"""PyTorch/CUDA port of pypulsar_tpu, beside the JAX package it is checked
against. It runs the survey's sweep stage: the flat single-pulse DM sweep
of a SIGPROC filterbank, with the two TPU kernels rewritten as CUDA for
Hopper (``ops/csrc``), and the streamed sweep->accel handoff
(``parallel/accelpipe.py``): every trial's series through rfft, deredden
and the Fourier acceleration search (``fourier/``).

The port imports ``torch``, numpy and scipy, never ``jax`` and nothing of
``pypulsar_tpu``. Its entry points run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``.
"""
