"""cli layer of the PyTorch/CUDA port (mirrors pypulsar_tpu/cli)."""

from __future__ import annotations

from typing import Sequence, Union


def open_reader(fns: Union[str, Sequence[str]]):
    """The reader of a raw-data input, for every CLI: several files are
    one :class:`~pypulsar_tpu_torch.io.fbobs.FilterbankObs`; one file is a
    :class:`~pypulsar_tpu_torch.io.psrfits.PsrfitsFile` by its
    ``.fits``/``.sf`` name or its header, else a SIGPROC
    :class:`~pypulsar_tpu_torch.io.filterbank.FilterbankFile`."""
    from pypulsar_tpu_torch.io import psrfits

    fns = [fns] if isinstance(fns, str) else list(fns)
    if len(fns) > 1:
        from pypulsar_tpu_torch.io.fbobs import FilterbankObs
        return FilterbankObs(fns)
    fn = fns[0]
    if fn.endswith((".fits", ".sf")) or psrfits.is_PSRFITS(fn):
        return psrfits.PsrfitsFile(fn)
    from pypulsar_tpu_torch.io.filterbank import FilterbankFile
    return FilterbankFile(fn)


def open_data_file(fn: str):
    """The reader of one ``.fil`` or ``.fits`` raw-data file, by its
    extension (the reference's bin/waterfaller.py:51-64, whose psrfits
    import was missing); any other name raises ValueError."""
    if not fn.endswith((".fil", ".fits")):
        raise ValueError(
            "Cannot recognize data file type from extension. "
            "(Only '.fits' and '.fil' are supported.)")
    return open_reader(fn)


def save_arrays(outfile, **arrays) -> bool:
    """Write a plot's ``arrays`` to ``outfile`` when it names a ``.npz``
    (numpy, no matplotlib: a machine without it still gets the plot's
    numbers). Returns whether it wrote them."""
    if not (outfile and outfile.endswith(".npz")):
        return False
    import numpy as np

    np.savez(outfile, **arrays)
    print("Wrote %s" % outfile)
    return True


def use_headless_backend_if_needed(outfile):
    """Switch matplotlib to Agg when writing to a file (without a display
    matplotlib's own backend resolution already falls back to Agg; the
    port reads no environment variable)."""
    import matplotlib
    if outfile:
        matplotlib.use("Agg", force=False)


def show_or_save(outfile):
    """``plt.show()``, or ``savefig(outfile)`` when given."""
    import matplotlib.pyplot as plt
    if outfile:
        plt.savefig(outfile, dpi=120, bbox_inches="tight")
        print("Wrote %s" % outfile)
    else:
        plt.show()
