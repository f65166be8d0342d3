"""Spectral fusion: the accel search served from spectra that never leave
the device.

Port of ``pypulsar_tpu/parallel/specfuse.py`` on one device. The streamed
handoff (``parallel/accelpipe.py``) copies every trial's series to a host
buffer and back to the device per prep batch; here they stay on the card,
in one of two regimes:

- **stitched** (the default): each chunk's dedispersed rows, from the
  sweep's own chunk engine (:func:`~pypulsar_tpu_torch.parallel.staged.
  iter_device_chunks`), scatter into a device-resident ``[D, T]`` buffer
  (the chunks' valid windows partition the time axis), and one
  :func:`~pypulsar_tpu_torch.fourier.kernels.prep_spectra_batch` per DM
  slice transforms it, row by row. The rows and the prep are the streamed
  path's own, so the candidates have the streamed device-prep run's
  bytes.
- **decimated** (``mode="decimate"``; needs the ``fourier`` engine, one
  chunk covering the observation and ``n_fft % T == 0``): the Fourier
  engine's per-trial spectra, decimated onto the T-point grid before any
  inverse transform (:func:`~pypulsar_tpu_torch.ops.fourier_dedisperse.
  sweep_chunk_spectra`), are dereddened as they are: no transform per
  trial. Decimation is circular dedispersion where the time-domain
  engines shift linearly with zero fill, so the last ``max_total_shift``
  samples differ and the candidate tables are not the stitched ones.

Differences from the reference: the slice budget and the regime are
keyword arguments with the reference's defaults
(:data:`SPECFUSE_HBM_BYTES`, ``mode="stitch"``), not environment
variables or a tuning cache; and ``mode="decimate"`` on a geometry that
fails its gate raises, naming the gate, where the reference stitches
silently. The mesh path waits for ROADMAP.md Queue 1 item 14.

Telemetry (the reference's names): the slice is a ``specfuse_slice``
span, each stitched chunk a ``specfuse_stitch`` span counted in
``specfuse.chunks_stitched``, the decimated chunk a ``specfuse_spectra``
span with ``specfuse.fft_pairs_elided``, the transform a
``specfuse_prep`` span, and ``specfuse.bytes_on_device`` counts the
series bytes the streamed path would have moved to the host and back.
Each chunk's dispatch halves its trial groups on a device OOM (fault
point ``specfuse.chunk_dispatch``); ``specfuse.after_stitch`` is a kill
point between the chunks and the transform.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from pypulsar_tpu_torch.core.device import resolve_device
from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.resilience import faultinject
from pypulsar_tpu_torch.resilience.retry import halving_dispatch

__all__ = [
    "MODES",
    "SPECFUSE_HBM_BYTES",
    "decimate_gate",
    "fused_spectra_slice",
    "spectral_trial_bytes",
]

#: device bytes a fused DM slice may hold (the reference's default)
SPECFUSE_HBM_BYTES = 8e9
MODES = ("stitch", "decimate")


def spectral_trial_bytes(T: int) -> int:
    """Device bytes one trial holds while a slice is fused: the stitched
    series row (4T) and its prepped complex64 spectrum (8 (T//2 + 1)).
    The decimated regime holds no series row, but one budget for both
    keeps the slicing independent of the regime."""
    return 4 * T + 8 * (T // 2 + 1)


def decimate_gate(engine: str, n_chunks: int, T: int, n_fft: int):
    """None when the decimated regime can run, else the gate it fails."""
    if engine != "fourier":
        return f"it needs engine 'fourier', not {engine!r}"
    if n_chunks != 1:
        return (f"it needs one chunk covering the observation, not "
                f"{n_chunks} (raise the chunk payload to >= {T})")
    if T <= 1 or n_fft % T:
        return (f"it needs the FFT length {n_fft} to be a multiple of the "
                f"series length {T}")
    return None


def fused_spectra_slice(reader, dms, schedule=None, downsamp: int = 1,
                        nsub: int = 64, group_size: int = 32, rfimask=None,
                        engine: str = "auto",
                        chunk_payload: Optional[int] = None,
                        mode: str = "stitch", device="cuda",
                        verbose: bool = False) -> dict:
    """One pass over ``reader``: every trial of ``dms`` to its prepped
    (dereddened) T-point spectrum, resident on ``device``.

    Returns ``dict(spectra, n_real, T, dt_eff, regime)``: ``spectra`` is
    a ``[Dpad, T//2 + 1]`` complex64 tensor (trials padded to the stage-1
    group; rows ``[:n_real]`` are ``dms`` in order), ready for
    ``accel_search_batch`` by row gathers. ``schedule`` is the
    ``deredden_schedule(T//2 + 1)`` (built when omitted)."""
    from pypulsar_tpu_torch.fourier.kernels import (
        deredden_schedule,
        prep_spectra_batch,
    )
    from pypulsar_tpu_torch.ops.fourier_dedisperse import (
        fourier_chunk_len,
        sweep_chunk_spectra,
    )
    from pypulsar_tpu_torch.parallel.staged import (
        ReaderSource,
        dats_geometry,
        downsampled_blocks,
        iter_device_chunks,
        make_source,
    )
    from pypulsar_tpu_torch.parallel.sweep import resolve_engine

    if mode not in MODES:
        raise ValueError(f"unknown spectral fusion mode {mode!r}; expected "
                         f"one of {MODES}")
    factor = max(1, int(downsamp))
    dms = np.asarray(dms, dtype=np.float64)
    device = resolve_device(device)
    engine = resolve_engine(engine)
    plan, payload, T = dats_geometry(reader, dms, downsamp=factor,
                                     nsub=nsub, group_size=group_size,
                                     chunk_payload=chunk_payload)
    dt_eff = ReaderSource(reader).tsamp * factor
    if schedule is None:
        schedule = deredden_schedule(T // 2 + 1)
    need = payload + plan.min_overlap
    n_fft = fourier_chunk_len(need)
    n_chunks = -(-T // payload)
    if mode == "decimate":
        gate = decimate_gate(engine, n_chunks, T, n_fft)
        if gate is not None:
            raise ValueError(f"spectral fusion's decimated regime cannot run "
                             f"here: {gate}")
    if verbose:
        what = ("decimated (no transform per trial)" if mode == "decimate"
                else f"stitched ({n_chunks} chunks)")
        print(f"# specfuse: {len(dms)} trials x {T} samples, {what}, "
              f"engine={engine}")
    n_real = len(dms)
    with telemetry.span("specfuse_slice", aggregate=False, n_trials=n_real,
                        n_samples=int(T),
                        regime="decimated" if mode == "decimate"
                        else "stitched"):
        if mode == "decimate":
            src = make_source(reader, rfimask, device)
            _pos, block = next(iter(downsampled_blocks(
                src, factor, payload, plan.min_overlap, device)))
            if block.shape[1] < need:
                block = F.pad(block, (0, need - block.shape[1]))

            def run(lo, hi):
                faultinject.trip("specfuse.chunk_dispatch")
                return sweep_chunk_spectra(
                    block, plan.stage1_bins[lo:hi], plan.stage2_bins[lo:hi],
                    plan.nsub, n_fft, n_fft // T, T // 2 + 1, T)

            with telemetry.span("specfuse_spectra"):
                # each group's spectra are its own: the halves of an
                # OOM-halved dispatch concatenate to the whole one
                parts = [r for _, _, r in halving_dispatch(
                    run, plan.n_groups, what="specfuse.chunk")]
                raw = parts[0] if len(parts) == 1 else torch.cat(parts)
            del block
            telemetry.counter("specfuse.fft_pairs_elided", n_real)
            faultinject.trip("specfuse.after_stitch")
            with telemetry.span("specfuse_prep"):
                spectra = prep_spectra_batch(spectra=raw, schedule=schedule,
                                             device=device)
        else:
            buf = torch.zeros((plan.n_trials, T), dtype=torch.float32,
                              device=device)
            chunks = iter_device_chunks(
                reader, dms, downsamp=factor, nsub=nsub,
                group_size=plan.group_size, chunk_payload=chunk_payload,
                rfimask=rfimask, engine=engine, device=device,
                dispatch_point="specfuse.chunk_dispatch")
            for pos, valid, series in chunks:
                with telemetry.span("specfuse_stitch", valid=int(valid)):
                    # the valid windows partition the time axis: the
                    # scatter takes the place of the streamed path's copy
                    # to the host
                    buf[:, pos:pos + valid] = series[:, :valid]
                telemetry.counter("specfuse.chunks_stitched")
                if verbose:
                    print(f"# specfuse chunk at {pos}: {valid} samples x "
                          f"{n_real} DMs stitched on the device")
            faultinject.trip("specfuse.after_stitch")
            with telemetry.span("specfuse_prep"):
                spectra = prep_spectra_batch(buf, schedule, device=device)
            del buf
        # the series bytes the streamed path would have moved over the
        # host link (the pull and the prep's re-ship), kept on the device
        telemetry.counter("specfuse.bytes_on_device", 8 * n_real * T)
    return dict(spectra=spectra, n_real=n_real, T=T, dt_eff=dt_eff,
                regime="decimated" if mode == "decimate" else "stitched")
