"""The compile plane of the port: the warm-pool registry (a port of
``pypulsar_tpu/compile/``).

What the JAX package's plane does, and what it becomes here:

- **The warmers** (:mod:`.plane`): each stage registers a function that
  makes ready, for one observation's geometry, what that stage's first
  device dispatch would otherwise pay for; the fleet scheduler's warm
  pool runs them for the next observation while the card is busy. The
  port's first dispatch pays for building (at first use) and loading
  each CUDA kernel's library and, for the tree engine, its host plan, so
  that is what the warmers make ready.
- **The accounting**: ``compile.cache_hit``, ``compile.cache_miss``,
  ``compile.persistent_hit``, ``compile.ms`` and the
  ``compile.first.<stage>`` spans are kept by the kernel loader,
  :func:`pypulsar_tpu_torch.ops._build.load`.

Dropped, with the reason:

- ``plane_jit`` / ``PlaneJit`` and the AOT executable registry. Torch
  neither traces nor compiles anything per shape: the port's kernels are
  ``ctypes`` libraries built once per source, and one library serves
  every shape.
- The persistent XLA cache. The digest-named library directory of
  ``ops/_build.py`` is already the persistent cache across processes
  and hosts.
- ``compile/registry.py``'s bucket ladder (``bucket_size``,
  ``bucket_floor``, ``bucket_rows``, ``note_bucket_pad``,
  ``buckets_enabled``). One launch serves any row count, so padding a
  batch up to a rung would add work and save nothing; the reference
  keeps bucketing out of every fingerprint, so no artifact depends on
  it.
- ``OPS_LEAF_ALLOWLIST``, the table of the JAX linter's raw-jit rule.
"""

from __future__ import annotations

from pypulsar_tpu_torch.compile.plane import (  # noqa: F401
    register_warmer,
    warm_stage,
    warmable_stages,
)

__all__ = ["register_warmer", "warm_stage", "warmable_stages"]
