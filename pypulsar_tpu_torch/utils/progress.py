"""Progress reporting for CLI pipelines.

Behavioral spec: reference ``utils/__init__.py:6-44`` (``show_progress``
iterator wrapper printing a ``\\r``-rewritten percent bar).  Signature is
kept compatible; output only updates when the integer percent changes.

A copy of ``pypulsar_tpu/utils/progress.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import sys

__all__ = ["show_progress"]


def show_progress(iterator, width=0, tot=None, fmt="%d", show_number=False,
                  file=None):
    """Yield from ``iterator`` while printing a progress percentage (and,
    with ``width > 0``, an ``[====  ]`` bar) rewritten in place.

    ``tot`` defaults to ``len(iterator)``; pass it explicitly for
    generators.  ``file`` defaults to ``sys.stdout``.
    """
    out = file if file is not None else sys.stdout
    if tot is None:
        tot = len(iterator)
    tot = max(int(tot), 1)
    last_pcnt = -1
    for curr, item in enumerate(iterator, start=1):
        frac = curr / tot
        pcnt = int(100 * frac)
        if pcnt > last_pcnt:
            last_pcnt = pcnt
            if width:
                neq = int(width * frac + 0.5)
                bar = "[" + "=" * neq + " " * (width - neq) + "]"
            else:
                bar = ""
            out.write("     %s %s %% " % (bar, fmt % pcnt))
            if show_number:
                out.write("(%d of %d)" % (curr, tot))
            out.write("\r")
            out.flush()
        yield item
    out.write("Done\n")
