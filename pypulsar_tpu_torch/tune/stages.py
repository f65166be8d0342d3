"""Per-stage measure builders: the real dispatches the search times.

Port of ``pypulsar_tpu/tune/stages.py``. Each builder returns a callable
that runs one representative slice of the stage's own dispatch at the
run's geometry, on ``device``, with the candidate config as its keywords
(``run(**config)``; a knob it is not given takes ``explicit``, then its
default). The work is the same for every config, so faster means more
throughput, not less work:

- ``sweep``: dedisperses ``nsamp`` samples of seeded ``[nchan, T]`` noise
  through :func:`~pypulsar_tpu_torch.parallel.sweep.
  dedisperse_series_chunk` in chunks of the candidate ``chunk_fft_len``,
  its payload clamped to the geometry exactly as the series passes clamp
  it (:func:`~pypulsar_tpu_torch.parallel.staged.step_geometry`);
- ``accel``: preps and searches ``nspec`` seeded series through
  :func:`~pypulsar_tpu_torch.fourier.kernels.prep_spectra_batch` and
  :func:`~pypulsar_tpu_torch.fourier.accelsearch.accel_search_batch` in
  groups of the candidate ``batch``, under its ``hbm_budget_bytes``.

Data comes from ``np.random.RandomState(seed)``; the sweep's block is
made once per chunk length and kept on the device, so a repeat pays no
generation.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from pypulsar_tpu_torch.core.device import resolve_device
from pypulsar_tpu_torch.tune import knobs

__all__ = ["MEASURED_STAGES", "accel_measure", "measure_for_stage",
           "sweep_measure"]

#: the stages with a measure builder (the others are cache-only)
MEASURED_STAGES = ("sweep", "accel")


def sweep_measure(nchan: int, nsamp: int, *, ndm: int = 32,
                  dt: float = 6.4e-5, engine: str = "gather",
                  nsub: Optional[int] = None, seed: int = 0,
                  device="cuda",
                  explicit: Optional[Mapping[str, Any]] = None
                  ) -> Callable[..., None]:
    """Dedispersing ``nsamp`` samples of ``[nchan, T]`` noise at ``ndm``
    trials by the series passes' chunk loop."""
    from pypulsar_tpu_torch.parallel import sweep as psweep

    device = resolve_device(device)
    nsub = nsub or min(64, nchan)
    freqs = 1500.0 - (400.0 / nchan) * np.arange(nchan)
    dms = np.linspace(0.0, 30.0 * ndm / 32.0, ndm)
    plan = psweep.make_sweep_plan(
        dms, freqs, dt, nsub=nsub,
        group_size=psweep.choose_group_size(dms, freqs, dt, nsub))
    nsamp = max(1, int(nsamp))
    blocks: Dict[int, torch.Tensor] = {}

    def run(**trial) -> None:
        fft_len = knobs.resolve("sweep", "chunk_fft_len",
                                (explicit or {}).get("chunk_fft_len"),
                                trial=trial)
        # the series passes' clamp: a chunk longer than the observation
        # runs one nsamp-sized dispatch, not a payload-sized one
        payload = min(psweep.default_chunk_payload(plan.min_overlap,
                                                   int(fft_len)), nsamp)
        if payload <= plan.min_overlap:
            payload = min(nsamp, 2 * plan.min_overlap + 1)
        L = payload + plan.min_overlap
        block = blocks.get(L)
        if block is None:
            blocks.clear()  # one resident block, not one per config
            block = blocks[L] = torch.from_numpy(
                np.random.RandomState(seed).randn(nchan, L)
                .astype(np.float32)).to(device)
        done = 0
        while done < nsamp:  # the same span for every config
            psweep.dedisperse_series_chunk(
                block, plan.stage1_bins, plan.stage2_bins, plan.nsub,
                payload, plan.max_shift2, engine)
            done += payload

    return run


def accel_measure(nsamp: int, *, zmax: int = 20, numharm: int = 2,
                  nspec: int = 16, dt: float = 6.4e-5, seed: int = 0,
                  device="cuda",
                  explicit: Optional[Mapping[str, Any]] = None
                  ) -> Callable[..., None]:
    """Prepping and searching ``nspec`` series of ``nsamp`` samples (the
    next power of two, at least 1024) in groups of the candidate batch
    under its device budget: the handoff's batched search."""
    from pypulsar_tpu_torch.fourier.accelsearch import (
        AccelSearchConfig,
        accel_search_batch,
    )
    from pypulsar_tpu_torch.fourier.kernels import prep_spectra_batch

    device = resolve_device(device)
    n = 1 << max(10, (int(nsamp) - 1).bit_length())
    cfg = AccelSearchConfig(zmax=zmax, numharm=numharm)
    series = np.random.RandomState(seed).randn(nspec, n).astype(np.float32)
    T = n * dt

    def run(**trial) -> None:
        v = knobs.resolve_all("accel", explicit, trial=trial)
        batch = max(1, int(v["batch"]))
        for b0 in range(0, nspec, batch):
            spectra = prep_spectra_batch(series[b0:b0 + batch],
                                         device=device)
            # returns host candidate lists: the device work is done
            accel_search_batch(spectra, T, cfg,
                               hbm_budget_bytes=v["hbm_budget_bytes"],
                               bank_cache_bytes=v["bank_cache_bytes"],
                               device=device)

    return run


def measure_for_stage(stage: str, *, nchan: Optional[int] = None,
                      nsamp: Optional[int] = None,
                      zmax: Optional[int] = None,
                      engine: Optional[str] = None, ndm: int = 32,
                      nspec: int = 16, numharm: int = 2, seed: int = 0,
                      device="cuda",
                      explicit: Optional[Mapping[str, Any]] = None
                      ) -> Callable[..., None]:
    """The measure callable of ``stage`` at this geometry (what ``cli
    tune --search`` and the ``search`` mode share); ValueError for a
    stage without one."""
    if stage == "sweep":
        return sweep_measure(int(nchan or 64), int(nsamp or 1 << 16),
                             ndm=ndm, engine=engine or "gather", seed=seed,
                             device=device, explicit=explicit)
    if stage == "accel":
        return accel_measure(int(nsamp or 1 << 14), zmax=int(zmax or 20),
                             numharm=numharm, nspec=nspec, seed=seed,
                             device=device, explicit=explicit)
    raise ValueError(f"no measure builder for stage {stage!r} (searchable "
                     f"stages: {', '.join(MEASURED_STAGES)})")
