"""One-shot equatorial -> galactic conversion (reference
``bin/coordconv.py``).

Copy of ``pypulsar_tpu/cli/coordconv.py``.
"""

from __future__ import annotations

import sys

from pypulsar_tpu_torch.astro import sextant


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print("usage: coordconv RA_DEG DEC_DEG", file=sys.stderr)
        return 1
    print(sextant.equatorial_to_galactic(
        float(argv[0]), float(argv[1]), input="deg"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
