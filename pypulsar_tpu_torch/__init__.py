"""PyTorch/CUDA port of pypulsar_tpu, beside the JAX package it is checked
against. Slice 1: the flat single-pulse DM sweep of a SIGPROC filterbank,
with the two TPU kernels rewritten as CUDA for Hopper (``ops/csrc``).

The port imports ``torch`` and numpy, never ``jax`` and nothing of
``pypulsar_tpu``. Its entry points run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``.
"""
