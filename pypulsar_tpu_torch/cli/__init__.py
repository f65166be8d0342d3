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
