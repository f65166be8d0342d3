"""Folding of candidates into pulse profiles, and their SNR.

Exports what ``pypulsar_tpu/fold/__init__.py`` exports: the single-pulse
profiles, the polyco phase models, FFTFIT and the TOA writers,
``profile_snr`` and the fold engine.
"""

from pypulsar_tpu_torch.fold import profile_snr  # noqa: F401
from pypulsar_tpu_torch.fold.engine import (  # noqa: F401
    fold_bins,
    fold_numpy,
    fold_parts,
    fold_spectra,
    fold_timeseries,
    phase_to_bins,
    phases_constant_period,
    phases_from_polycos,
)
from pypulsar_tpu_torch.fold.polycos import (  # noqa: F401
    Polyco,
    PolycoError,
    Polycos,
    create_polycos,
    create_polycos_from_inf,
    create_polycos_from_spindown,
)
from pypulsar_tpu_torch.fold.pulse import (  # noqa: F401
    Pulse,
    SummedPulse,
    read_pulse_from_file,
)
from pypulsar_tpu_torch.fold.toa import (  # noqa: F401
    FFTFitError,
    cprof,
    fftfit,
    format_princeton_toa,
    measure_phase,
    write_princeton_toa,
)
