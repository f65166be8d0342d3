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
silently.

With ``mesh=`` (a ``'dm'`` mesh, ``parallel/mesh.py``) the trial groups
shard over the mesh positions, padded to their multiple, and spectra stay
on the device that made them: each position stitches its own rows into
its own buffer (the stitched regime) or computes its own groups'
decimated spectra (:func:`_make_sharded_spectra_chunk`), and preps them
there. ``spectra`` is then the list of the positions' blocks, in group
order (:func:`fused_rows` gathers a batch's rows); each row has the
single-device row's bits.

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
    "fused_rows",
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


def fused_rows(fused: dict, loc, device) -> torch.Tensor:
    """Rows ``loc`` of a fused slice's spectra on ``device``: a row
    gather of the one tensor, or under a mesh of the position that holds
    each row."""
    sp = fused["spectra"]
    if isinstance(sp, torch.Tensor):
        return sp[torch.tensor(loc, device=sp.device)].to(device)
    per = int(sp[0].shape[0])
    return torch.stack([sp[i // per][i % per].to(device) for i in loc])


def _make_sharded_spectra_chunk(mesh, nsub: int, n_fft: int,
                                dec_stride: int, dec_len: int, T: int):
    """The decimated regime's spectra kernel with trial groups sharded
    over ``mesh``'s ``'dm'`` axis: ``fn(block, stage1_bins,
    stage2_bins)`` -> each position's groups' raw spectra on its own
    device, in group order (a group's spectra are its own, so each row
    has the single-device bits). A position's dispatch halves its groups
    on a device OOM (fault point ``specfuse.chunk_dispatch``)."""
    from pypulsar_tpu_torch.ops.fourier_dedisperse import sweep_chunk_spectra
    from pypulsar_tpu_torch.parallel.mesh import on_device, replicate

    devices = mesh.axis_devices("dm")

    def fn(block, stage1_bins, stage2_bins):
        G = stage1_bins.shape[0]
        if G % len(devices):
            raise ValueError(f"group count {G} must divide the mesh 'dm' "
                             f"axis {len(devices)}")
        per = G // len(devices)
        out = []
        for i, (dev, x) in enumerate(zip(devices, replicate(block,
                                                            devices))):
            s1 = stage1_bins[i * per:(i + 1) * per]
            s2 = stage2_bins[i * per:(i + 1) * per]

            def run(lo, hi, x=x, s1=s1, s2=s2):
                faultinject.trip("specfuse.chunk_dispatch")
                return sweep_chunk_spectra(x, s1[lo:hi], s2[lo:hi], nsub,
                                           n_fft, dec_stride, dec_len, T)

            with on_device(dev):
                parts = [r for _, _, r in halving_dispatch(
                    run, per, what="specfuse.chunk")]
                out.append(parts[0] if len(parts) == 1 else torch.cat(parts))
        return out

    return fn


def fused_spectra_slice(reader, dms, schedule=None, downsamp: int = 1,
                        nsub: int = 64, group_size: int = 32, rfimask=None,
                        engine: str = "auto",
                        chunk_payload: Optional[int] = None,
                        mode: str = "stitch", device="cuda",
                        verbose: bool = False, mesh=None) -> dict:
    """One pass over ``reader``: every trial of ``dms`` to its prepped
    (dereddened) T-point spectrum, resident on ``device``.

    Returns ``dict(spectra, n_real, T, dt_eff, regime)``: ``spectra`` is
    a ``[Dpad, T//2 + 1]`` complex64 tensor (trials padded to the stage-1
    group; rows ``[:n_real]`` are ``dms`` in order), ready for
    ``accel_search_batch`` by row gathers. ``schedule`` is the
    ``deredden_schedule(T//2 + 1)`` (built when omitted). With ``mesh``,
    ``spectra`` is the list of the mesh positions' ``[Dpad/k, T//2 + 1]``
    blocks, each on its own device (:func:`fused_rows`)."""
    from pypulsar_tpu_torch.parallel.mesh import on_device
    from pypulsar_tpu_torch.parallel.sweep import mesh_home
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
    device = mesh_home(mesh) if mesh is not None else resolve_device(device)
    engine = resolve_engine(engine)
    plan, payload, T = dats_geometry(reader, dms, downsamp=factor,
                                     nsub=nsub, group_size=group_size,
                                     chunk_payload=chunk_payload, mesh=mesh)
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
                if mesh is not None:
                    raws = _make_sharded_spectra_chunk(
                        mesh, plan.nsub, n_fft, n_fft // T, T // 2 + 1, T)(
                            block, plan.stage1_bins, plan.stage2_bins)
                else:
                    parts = [r for _, _, r in halving_dispatch(
                        run, plan.n_groups, what="specfuse.chunk")]
                    raws = [parts[0] if len(parts) == 1
                            else torch.cat(parts)]
            del block
            telemetry.counter("specfuse.fft_pairs_elided", n_real)
            faultinject.trip("specfuse.after_stitch")
            with telemetry.span("specfuse_prep"):
                spectra = []
                for raw in raws:
                    with on_device(raw.device):
                        spectra.append(prep_spectra_batch(
                            spectra=raw, schedule=schedule,
                            device=raw.device))
        else:
            devices = ([device] if mesh is None
                       else mesh.axis_devices("dm"))
            per = plan.n_trials // len(devices)
            bufs = [torch.zeros((per, T), dtype=torch.float32, device=d)
                    for d in devices]
            chunks = iter_device_chunks(
                reader, dms, downsamp=factor, nsub=nsub,
                group_size=plan.group_size, chunk_payload=chunk_payload,
                rfimask=rfimask, engine=engine, device=device,
                dispatch_point="specfuse.chunk_dispatch", mesh=mesh,
                shard_parts=mesh is not None)
            for pos, valid, series in chunks:
                with telemetry.span("specfuse_stitch", valid=int(valid)):
                    # the valid windows partition the time axis: the
                    # scatter takes the place of the streamed path's copy
                    # to the host; under a mesh each position stitches
                    # its own rows on its own device
                    parts = series if mesh is not None else [series]
                    for buf, rows in zip(bufs, parts):
                        buf[:, pos:pos + valid] = rows[:, :valid]
                telemetry.counter("specfuse.chunks_stitched")
                if verbose:
                    print(f"# specfuse chunk at {pos}: {valid} samples x "
                          f"{n_real} DMs stitched on the device")
            faultinject.trip("specfuse.after_stitch")
            with telemetry.span("specfuse_prep"):
                spectra = []
                for buf in bufs:
                    with on_device(buf.device):
                        spectra.append(prep_spectra_batch(
                            buf, schedule, device=buf.device))
            del bufs
        # the series bytes the streamed path would have moved over the
        # host link (the pull and the prep's re-ship), kept on the device
        telemetry.counter("specfuse.bytes_on_device", 8 * n_real * T)
    if mesh is None:
        spectra = spectra[0]
    return dict(spectra=spectra, n_real=n_real, T=T, dt_eff=dt_eff,
                regime="decimated" if mode == "decimate" else "stitched")
