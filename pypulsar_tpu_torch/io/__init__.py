"""io layer of the PyTorch/CUDA port (mirrors pypulsar_tpu/io). The
package exports the WAPP reader and the survey data-file objects, as the
JAX package's ``io`` does; every other reader is imported from its
module.

The exports are imported at first use (a module ``__getattr__``): the
WAPP reader's ``pycparser`` and the data-file objects' ``astro`` layer
(scipy) would otherwise cost every process that reads a filterbank
about 0.6-0.9 s of imports."""

import importlib

__all__ = ["WappFile", "autogen_dataobj", "Data"]

_EXPORTS = {"WappFile": "wapp", "autogen_dataobj": "datafile",
            "Data": "datafile"}


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
