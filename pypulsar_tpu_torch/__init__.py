"""PyTorch/CUDA port of pypulsar_tpu, beside the JAX package it is checked
against. It runs the survey's per-observation chain (``survey/dag.py``):
the rfifind mask stage (``cli/rfifind.py``), the sweep stage (the flat
single-pulse DM sweep of a SIGPROC filterbank, masked, with the two TPU
kernels rewritten as CUDA for Hopper in ``ops/csrc``, and the streamed
sweep->accel handoff of ``parallel/accelpipe.py``), sift, the batched
fold (a third CUDA kernel) and the SNR summary. Beside the chain, the
``Spectra`` container (``core/spectra.py``) and its data-plane ops
(``ops/kernels.py``, plain PyTorch) serve the loaders' ``get_spectra``
and the waterfaller, zero_dm_filter, spectrogram and freq_time CLIs.

The port imports ``torch``, numpy and scipy, never ``jax`` and nothing of
``pypulsar_tpu``. Its entry points run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``.
"""

__all__ = ["Spectra"]


def __getattr__(name):
    # imported on first use: a tool that needs no torch (psrlint,
    # coordconv, pfdinfo) starts without paying torch's import
    if name == "Spectra":
        from pypulsar_tpu_torch.core.spectra import Spectra

        return Spectra
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
