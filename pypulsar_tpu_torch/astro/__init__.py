"""astro layer of the PyTorch/CUDA port (mirrors pypulsar_tpu/astro):
angle conversions, calendar and sidereal time, coordinate transforms,
compact RA/DEC strings, telescope tables, the sky-temperature map and the
radiometer SNR estimate. Host numpy.

The package exports the JAX package's names, each imported at first use
(a module ``__getattr__``): ``estimate_snr``'s scipy would otherwise
cost every process that reads a PSRFITS date about 0.8 s of imports."""

import importlib

__all__ = [
    "protractor",
    "calendar",
    "clock",
    "sextant",
    "coordconv",
    "healpix",
    "skytemp",
    "estimate_snr",
    "telescope_to_id",
    "id_to_telescope",
    "telescope_to_maxha",
]

_TELESCOPE_NAMES = ("telescope_to_id", "id_to_telescope",
                    "telescope_to_maxha")


def __getattr__(name):
    if name in _TELESCOPE_NAMES:
        return getattr(importlib.import_module(f"{__name__}.telescopes"),
                       name)
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
