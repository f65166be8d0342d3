"""Streamed sweep of a SIGPROC filterbank, a PSRFITS file or a multi-file
observation.

Port of the flat path of ``pypulsar_tpu/parallel/staged.py``: raw blocks
in the file's native dtype ship ahead to the device
(:func:`~pypulsar_tpu_torch.parallel.prefetch.ship_ahead`), are unpacked,
transposed to [chan, time], widened to float32 and band-flipped there
(:func:`ingest_tc`; PSRFITS subints are also scaled there,
:func:`ingest_psrfits`), scrubbed of non-finite values when float-typed
(``resilience/dataguard.py``), optionally masked with an rfifind mask
(:class:`MaskedSource`, at the full sample rate), optionally downsampled,
and fed to :func:`~pypulsar_tpu_torch.parallel.sweep.sweep_stream`.

Host downsampling (the reference's ``_host_downsampled_blocks``), opt-in
through ``host_downsample=True`` (on :func:`run_step`, :func:`sweep_flat`,
:func:`sweep_ddplan`, :func:`iter_device_chunks`): where a single integer
SIGPROC file is downsampled (:func:`host_downsample_wins`), the prefetch
worker sums the raw samples on the host (uint16, or uint32 for 16-bit
samples and large factors) and ships the sums; integer sums are exact in
either accumulator and in float32, so the blocks have the device path's
bits. It is off by default: the sums halve the bytes shipped at factor 4
on 8-bit data, but numpy's strided reduction on the worker takes longer
than the card's co-add of the native samples (PERF.md).

The series path (:func:`iter_device_chunks`) streams the same blocks
through the dedispersion only, by any chunk engine;
:func:`iter_dedispersed_chunks` hands every trial's series back to the
host, where the sweep->accel handoff
(:func:`pypulsar_tpu_torch.parallel.accelpipe.stream_series`, which also
tees them to the ``.dat`` files) reads them, and spectral fusion
(``parallel/specfuse.py``) keeps them on the device. :func:`sweep_ddplan`
runs a DDplan's steps, each at its own downsampling.

Kill and resume: ``checkpoint_path`` on :func:`sweep_flat` and
:func:`sweep_ddplan` checkpoints each pass
(:class:`~pypulsar_tpu_torch.parallel.sweep.SweepCheckpoint`); a resumed
pass re-roots its block source at the cursor (:func:`reroot_source`:
every reader seeks), and a DDplan step that finished leaves a done marker
from which a resumed plan loads it without sweeping.

Meshes (``parallel/mesh.py``): ``mesh=`` on :func:`sweep_flat`,
:func:`sweep_ddplan`, :func:`run_step`, :func:`iter_device_chunks` and
:func:`iter_dedispersed_chunks` shards each chunk's trial groups over the
mesh's ``'dm'`` axis (``parallel/sweep.ShardedChunkEngine``): blocks ship
to the mesh's first device and reach each other distinct card once, and
the rows are the single-device rows' bits. :func:`sweep_ddplan_2d` runs
each DDplan step as one chunk over a ``'dm'`` x ``'time'`` mesh
(``parallel/sweep.make_sharded_sweep_chunk_2d``).
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pypulsar_tpu_torch.core.device import count_d2h, resolve_device
from pypulsar_tpu_torch.io.filterbank import FilterbankFile, unpack_subbyte
from pypulsar_tpu_torch.io.infodata import InfoData
from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.ops.masking import masked
from pypulsar_tpu_torch.parallel.prefetch import ship_ahead
from pypulsar_tpu_torch.parallel.sweep import (
    DEFAULT_CHUNK_FFT_LEN,
    DEFAULT_WIDTHS,
    ChunkEngine,
    GroupHalving,
    SweepCheckpoint,
    ShardedChunkEngine,
    SweepResult,
    choose_group_size,
    default_chunk_payload,
    finalize_sweep,
    make_sharded_sweep_chunk_2d,
    make_sweep_plan,
    mesh_home,
    mesh_pad_groups,
    mesh_tag,
    padded_group_count,
    resolve_engine,
    sweep_stream,
)
from pypulsar_tpu_torch.resilience import faultinject
from pypulsar_tpu_torch.resilience.dataguard import (
    GuardedSource,
    StreamQuality,
    guard_source,
)


@dataclasses.dataclass
class StepResult:
    """One sweep's output at its own time resolution."""

    downsamp: int
    dt: float  # effective (downsampled) sampling time, seconds
    result: SweepResult

    def candidates(self) -> List[dict]:
        """All (dm, width, snr, sample) records in physical units."""
        out = []
        res = self.result
        for di, dm in enumerate(res.dms):
            for wi, w in enumerate(res.widths):
                out.append(dict(
                    dm=float(dm),
                    snr=float(res.snr[di, wi]),
                    width_bins=int(w),
                    width_sec=float(w * self.dt),
                    sample=int(res.peak_sample[di, wi]),
                    time_sec=float(res.peak_sample[di, wi] * self.dt),
                    downsamp=self.downsamp,
                ))
        return out


@dataclasses.dataclass
class StagedSweepResult:
    """The steps' results plus global candidate selection. ``quality`` is
    the scrub's account of the stream (summed over the steps' passes),
    None when the source was not scrubbed (integer samples)."""

    steps: List[StepResult]
    quality: Optional[StreamQuality] = None

    @property
    def n_trials(self) -> int:
        return sum(len(s.result.dms) for s in self.steps)

    def best(self, k: int = 10) -> List[dict]:
        """Global top-k candidates (best width per trial) across steps."""
        cands = []
        for s in self.steps:
            res = s.result
            wi = np.argmax(res.snr, axis=1)
            for di, dm in enumerate(res.dms):
                w = res.widths[wi[di]]
                cands.append(dict(
                    dm=float(dm),
                    snr=float(res.snr[di, wi[di]]),
                    width_bins=int(w),
                    width_sec=float(w * s.dt),
                    sample=int(res.peak_sample[di, wi[di]]),
                    time_sec=float(res.peak_sample[di, wi[di]] * s.dt),
                    downsamp=s.downsamp,
                ))
        cands.sort(key=lambda c: -c["snr"])
        return cands[:k]

    def above_threshold(self, snr: float) -> List[dict]:
        """All per-(trial, width) detections above ``snr``, time-ordered."""
        out = [c for s in self.steps for c in s.candidates() if c["snr"] >= snr]
        out.sort(key=lambda c: (c["dm"], c["time_sec"]))
        return out

    def events(self, snr: float) -> List[dict]:
        """Every per-chunk peak at or above ``snr`` across the steps, in
        physical units, sorted by (dm, time) (the sweep must have kept its
        chunk peaks)."""
        out = []
        for s in self.steps:
            for e in s.result.events(snr):
                out.append(dict(
                    dm=e["dm"], snr=e["snr"], width_bins=e["width"],
                    width_sec=e["width"] * s.dt, sample=e["sample"],
                    time_sec=e["sample"] * s.dt, downsamp=s.downsamp))
        out.sort(key=lambda c: (c["dm"], c["time_sec"]))
        return out


def band_orientation(freqs) -> Tuple[np.ndarray, bool]:
    """(high-frequency-first channel table, whether it was flipped)."""
    freqs = np.asarray(freqs, dtype=np.float64)
    flip = len(freqs) > 1 and freqs[0] < freqs[-1]
    return (freqs[::-1].copy() if flip else freqs), flip


def unpack_rows(packed: torch.Tensor, nbits: int) -> torch.Tensor:
    """Packed [rows, n] uint8 of ``nbits`` < 8 samples -> [rows, n*8//nbits]
    samples, the low bits of each byte first (the lower channel in SIGPROC
    and PSRFITS rows alike)."""
    spb = 8 // nbits
    mask = (1 << nbits) - 1
    parts = [(packed >> (nbits * i)) & mask for i in range(spb)]
    return torch.stack(parts, dim=-1).reshape(packed.shape[0],
                                              packed.shape[1] * spb)


def ingest_tc(raw_tc: torch.Tensor, flip: bool, nbits: int = 8):
    """[time, chan] native-dtype block -> [chan, time] float32, optionally
    band-flipped, on the block's device. ``nbits`` < 8 means ``raw_tc`` is
    packed [time, nchans*nbits//8] uint8 (low bits = lower channel) and is
    unpacked here; 16-bit samples (and uint16 host sums) arrive as int16,
    uint32 host sums as int32, and are widened as unsigned. Integer to
    float32 is exact."""
    if nbits < 8:
        raw_tc = unpack_rows(raw_tc, nbits)
    elif raw_tc.dtype == torch.int16:
        raw_tc = raw_tc.to(torch.int32) & 0xFFFF
    elif raw_tc.dtype == torch.int32:
        raw_tc = raw_tc.to(torch.int64) & 0xFFFFFFFF
    d = raw_tc.t().to(torch.float32, memory_format=torch.contiguous_format)
    return torch.flip(d, dims=(0,)) if flip else d


def ingest_psrfits(data: torch.Tensor, scales: torch.Tensor,
                   offsets: torch.Tensor, weights: torch.Tensor, skip: int,
                   n: int, nbits: int, nchan: int, npol: int = 1,
                   poln: int = 0, flip: bool = True) -> torch.Tensor:
    """Stored PSRFITS subints -> [chan, n] float32 on their device.

    ``data`` [nsub, row] is what
    :meth:`~pypulsar_tpu_torch.io.psrfits.PsrfitsFile.raw_subints` reads:
    packed bytes below 8 bits (low bits first), uint8, int16 or float32;
    ``scales``/``offsets`` [nsub, npol*nchan] and ``weights`` [nsub,
    nchan] float32 rows of each subint. The samples are unpacked, scaled
    per channel and subint as ``(data*scales + offsets)*weights`` with
    each step rounded to float32 on its own (separate elementwise ops, no
    fused multiply-add: the JAX package's numpy sums, bit for bit),
    polarisation ``poln`` kept, trimmed to samples [skip, skip + n) of
    the subints' concatenation, transposed and, with ``flip``,
    band-flipped."""
    nsub = data.shape[0]
    if nbits < 8:
        data = unpack_rows(data, nbits)
    x = data.to(torch.float32).reshape(nsub, -1, npol, nchan)[:, :, poln]
    if npol > 1:
        # DAT_SCL/DAT_OFFS hold npol consecutive nchan blocks
        scales = scales[:, poln * nchan:(poln + 1) * nchan]
        offsets = offsets[:, poln * nchan:(poln + 1) * nchan]
    x = x * scales[:, None, :]
    x.add_(offsets[:, None, :])
    x.mul_(weights[:, None, :])
    x = x.reshape(-1, nchan)[skip:skip + n]
    if flip:
        x = torch.flip(x, dims=(1,))
    return x.t().contiguous()


def _raw_blocks(read, payload: int, overlap: int, total: int,
                start: int = 0, end: Optional[int] = None):
    """(pos, read(pos, n)) stepping by ``payload`` from ``start`` while
    ``pos < end`` (default ``total``), each ``n = payload + overlap``
    samples long except at the file's tail."""
    end = total if end is None else end
    pos = start
    while pos < end:
        yield pos, read(pos, min(payload + overlap, total - pos))
        pos += payload


def _before(blocks, end: int):
    """The (pos, block) of ``blocks`` that start before ``end``: a block
    at or past it (an overlap-only tail past a window) would be shipped
    ahead for nothing. Closes ``blocks`` when it stops."""
    try:
        for pos, block in blocks:
            if pos >= end:
                return
            yield pos, block
    finally:
        blocks.close()


class ReaderSource:
    """High-frequency-first block source over a file reader: a SIGPROC
    :class:`~pypulsar_tpu_torch.io.filterbank.FilterbankFile` (1-16 bit
    and float32), a :class:`~pypulsar_tpu_torch.io.psrfits.PsrfitsFile`
    or a :class:`~pypulsar_tpu_torch.io.fbobs.FilterbankObs`. Each ships
    its blocks in their stored form and decodes them on the device:
    :func:`ingest_tc` for filterbanks, :func:`ingest_psrfits` for
    PSRFITS (the bytes of the subints a block spans, with their scales,
    offsets and weights).

    ``start``/``end`` bound the blocks' starts to a window of the file
    (every reader seeks there); a block still reads its overlap past
    ``end``, up to the file's tail. Positions stay those of the file. An
    interior window (``end`` before the tail) must be a whole number of
    payloads, or the seam samples would count in two windows."""

    def __init__(self, reader, start: int = 0, end: Optional[int] = None):
        self.reader = reader
        self.frequencies, self._flip = band_orientation(reader.frequencies)
        self.tsamp = float(reader.tsamp)
        for attr in ("number_of_samples", "nspec", "nsamples"):
            n = getattr(reader, attr, None)
            if n is not None:
                self.total = int(n)
                break
        else:
            raise ValueError(f"cannot determine sample count of {reader!r}")
        self.start = int(start)
        self.end = self.total if end is None else min(int(end), self.total)
        if not 0 <= self.start <= self.end:
            raise ValueError(f"bad window [{start}, {end}) of {self.total}")
        self.nsamples = self.end - self.start

    def chan_major_blocks(self, payload: int, overlap: int, device):
        """(pos, [chan, time] float32 block on ``device``) stepping by
        ``payload`` over the window, each with ``overlap`` samples of
        lookahead."""
        if self.end < self.total and (self.end - self.start) % payload:
            raise ValueError(
                f"windowed source [{self.start}, {self.end}) is not a whole "
                f"multiple of payload={payload}; seam samples would be "
                f"counted in two windows")
        r = self.reader
        if hasattr(r, "raw_subints"):
            yield from self._psrfits_blocks(payload, overlap, device)
            return
        if hasattr(r, "get_raw_interval"):  # several files
            nbits = r.fbs[0].nbits
            raw = _raw_blocks(lambda pos, n: r.get_raw_interval(pos, pos + n),
                              payload, overlap, self.total, self.start,
                              self.end)
        else:
            nbits = int(r.nbits)
            # one read-ahead ring over the window; it reads past the
            # window's end so in-window blocks keep their overlap, and
            # lends each slot to the ship thread, whose pinned copy is
            # the block's copy-out
            raw = _before(r.iter_blocks(
                payload, overlap, start=self.start,
                end=min(self.end + overlap, self.total), raw=True,
                borrow=True), self.end)
        shipped = ship_ahead(raw, device)
        try:
            for pos, dev in shipped:
                yield pos, ingest_tc(dev, self._flip, min(nbits, 8))
        finally:  # an early stop closes the ship thread and the ring now
            shipped.close()

    def _psrfits_blocks(self, payload: int, overlap: int, device):
        r = self.reader
        nsblk = int(r.nsamp_per_subint)
        # raw rows are stored low-frequency-first unless need_flipband;
        # the table above is high-frequency-first unless _flip
        flip = (not r.specinfo.need_flipband) != self._flip
        raw = _raw_blocks(r.raw_subints, payload, overlap, self.total,
                          self.start, self.end)
        for pos, arrays in ship_ahead(raw, device):
            n = min(payload + overlap, self.total - pos)
            yield pos, ingest_psrfits(
                *arrays, pos % nsblk, n, int(r.nbits), int(r.nchan),
                int(r.npoln), int(r.specinfo.default_poln), flip)


class MaskedSource:
    """A block source with an rfifind mask applied: each block's zapped
    cells take their channel's median-mid80 fill over that block, overlap
    included (the reference's waterfaller semantics at the sweep's
    streaming boundary). The [nint, nchan] zap table goes to ``device``
    once, flipped there to the source's high-frequency-first rows (mask
    channels are low-frequency-first); a block's [C, L] mask is expanded
    from interval indices on the device. A block none of whose intervals
    is zapped passes through unfilled."""

    def __init__(self, src, rfimask, device):
        self.frequencies = src.frequencies
        self.tsamp = src.tsamp
        self.nsamples = src.nsamples
        self._src = src
        self._pts = int(rfimask.ptsperint)
        self._host_table = np.asarray(rfimask._zap_table, dtype=bool)
        self._table = torch.from_numpy(
            np.ascontiguousarray(self._host_table[:, ::-1])).to(device)

    def chan_major_blocks(self, payload: int, overlap: int, device):
        nint = self._host_table.shape[0]
        for pos, block in self._src.chan_major_blocks(payload, overlap,
                                                      device):
            L = int(block.shape[1])
            i0 = min(pos // self._pts, nint - 1)
            i1 = min((pos + L - 1) // self._pts, nint - 1)
            if self._host_table[i0:i1 + 1].any():
                block = masked_block(block, self._table, pos // self._pts,
                                     pos % self._pts, self._pts)
            yield pos, block


def masked_block(data: torch.Tensor, table: torch.Tensor, base: int,
                 rem: int, pts: int) -> torch.Tensor:
    """Expand the [nint, C] zap table to this block's [C, L] mask
    (interval = sample // pts, clamped to the last interval as
    ``RfifindMask.get_sample_mask`` does) and apply the median-mid80
    fill. ``base`` and ``rem`` are the interval and the offset in it of
    the block's first sample."""
    L = data.shape[1]
    iv = torch.clamp_max(
        base + (rem + torch.arange(L, dtype=torch.int64,
                                   device=data.device)) // pts,
        table.shape[0] - 1)
    return masked(data, table[iv].T)


def mask_tag(rfimask) -> str:
    """A tag of the applied mask for resume fingerprints: artifacts made
    under another (or no) mask must not be resumed."""
    if rfimask is None:
        return ""
    h = hashlib.sha256()
    h.update(np.int64([rfimask.nchan, rfimask.nint,
                       rfimask.ptsperint]).tobytes())
    h.update(np.packbits(rfimask._zap_table).tobytes())
    return "/mask=" + h.hexdigest()[:16]


def make_source(reader, rfimask, device):
    """The block source of ``reader``: scrubbed of non-finite values when
    its blocks are float-typed
    (:func:`~pypulsar_tpu_torch.resilience.dataguard.guard_source`), then
    masked when ``rfimask`` is given. The scrub sits inside the mask: the
    fill's channel medians must never see a NaN."""
    src = guard_source(ReaderSource(reader))
    return src if rfimask is None else MaskedSource(src, rfimask, device)


def reroot_source(src, start_raw: int):
    """``src`` with its blocks starting at raw sample ``start_raw`` (the
    same end), or None when it cannot seek: through the mask and the
    scrub to the :class:`ReaderSource`; the scrub's rebuilt wrapper
    shares the original's ``stats``, so a resumed stream's account goes
    on with the original tally."""
    if isinstance(src, MaskedSource):
        inner = reroot_source(src._src, start_raw)
        if inner is None:
            return None
        out = copy.copy(src)  # the same zap table on the device
        out._src = inner
        return out
    if isinstance(src, GuardedSource):
        inner = reroot_source(src._src, start_raw)
        return None if inner is None else GuardedSource(inner,
                                                        stats=src.stats)
    if isinstance(src, ReaderSource):
        return ReaderSource(src.reader, start_raw,
                            src.end if src.end < src.total else None)
    return None


def stream_quality(src) -> Optional[StreamQuality]:
    """The scrub's account of a :func:`make_source` source, None when it
    is not scrubbed."""
    if isinstance(src, MaskedSource):
        src = src._src
    return src.stats if isinstance(src, GuardedSource) else None


def host_downsample_wins(src, factor: int,
                         host_downsample: bool = False) -> bool:
    """Whether :func:`downsampled_blocks` sums ``factor`` samples on the
    host and ships the sums (the reference's ``_host_downsample_wins``
    with its override set): only when ``host_downsample`` asks for it,
    and only for a :class:`ReaderSource` over one SIGPROC file of 16 bits
    or fewer (integer sums are exact; a float file's would not keep the
    device's order), 16-bit samples only up to factor 256; a masked or
    scrubbed source stays at the full rate."""
    if not host_downsample or factor <= 1 \
            or not isinstance(src, ReaderSource):
        return False
    r = src.reader
    if not isinstance(r, FilterbankFile):
        return False
    nbits = int(r.nbits)
    return nbits <= 8 or (nbits <= 16 and factor <= 256)


def host_ds_acc_dtype(nbits: int, factor: int):
    """The accumulator of exact host bin sums: uint16 while ``factor``
    samples of 8 bits or fewer fit (factor <= 257), uint32 otherwise and
    for 16-bit samples."""
    return np.uint16 if (nbits <= 8 and factor <= 257) else np.uint32


def _host_downsampled_blocks(src: ReaderSource, factor: int,
                             payload_ds: int, overlap_ds: int, device):
    """Raw blocks read at ``factor`` times the downsampled geometry,
    unpacked (below 8 bits) and summed over ``factor`` samples on the
    prefetch worker, shipped as the integer sums and widened on
    ``device`` (:func:`ingest_tc`)."""
    reader = src.reader
    nbits = int(reader.nbits)
    acc_dtype = host_ds_acc_dtype(nbits, factor)
    payload, overlap = payload_ds * factor, overlap_ds * factor
    # the seam contract of ReaderSource.chan_major_blocks
    if src.end < src.total and (src.end - src.start) % payload:
        raise ValueError(
            f"windowed source [{src.start}, {src.end}) is not a whole "
            f"multiple of payload={payload}; seam samples would be counted "
            f"in two windows")
    # the sums are new arrays, made before the ring's next block
    raw = _before(reader.iter_blocks(
        payload, overlap, start=src.start,
        end=min(src.end + overlap, src.total), raw=True, borrow=True),
        src.end)

    def sums():
        try:
            for pos, block in raw:
                if nbits < 8:
                    block = unpack_subbyte(block, nbits)
                nbin = block.shape[0] // factor
                if nbin == 0:
                    continue  # tail shorter than one output bin
                yield pos, block[:nbin * factor].reshape(
                    nbin, factor, block.shape[1]).sum(axis=1, dtype=acc_dtype)
        finally:
            raw.close()

    shipped = ship_ahead(sums(), device)
    try:
        for pos, dev in shipped:
            yield pos // factor, ingest_tc(dev, src._flip, 8)
    finally:
        shipped.close()


def downsampled_blocks(src, factor: int, payload_ds: int, overlap_ds: int,
                       device, host_downsample: bool = False):
    """Chan-major device blocks downsampled by ``factor`` (co-added in
    float32 on the device, or summed on the host where
    :func:`host_downsample_wins`; a partial trailing bin is dropped). Raw
    blocks are read at ``factor`` times the downsampled geometry so bin
    edges line up across chunks."""
    if host_downsample_wins(src, factor, host_downsample):
        yield from _host_downsampled_blocks(src, factor, payload_ds,
                                            overlap_ds, device)
        return
    for pos, data in src.chan_major_blocks(payload_ds * factor,
                                           overlap_ds * factor, device):
        if factor > 1:
            nbin = data.shape[1] // factor
            if nbin == 0:
                continue  # tail shorter than one output bin
            data = data[:, :nbin * factor].reshape(
                data.shape[0], nbin, factor).sum(dim=-1)
        yield pos // factor, data


def step_geometry(src, dms, factor: int, nsub: int, group_size: int,
                  widths: Tuple[int, ...], chunk_payload: Optional[int],
                  mesh=None):
    """(plan, payload, n_ds) of one pass over ``src`` downsampled by
    ``factor``: the plan of ``dms`` (``group_size`` <= 0 picks the largest
    group within the smearing bound; with a ``mesh`` its groups padded to
    the ``'dm'`` multiple), the chunk payload and the downsampled length.
    The sweep and the series pass chunk by it."""
    dt_eff = src.tsamp * factor
    n_ds = src.nsamples // factor
    if group_size <= 0:
        group_size = choose_group_size(dms, src.frequencies, dt_eff, nsub)
    plan = make_sweep_plan(np.asarray(dms, dtype=np.float64),
                           src.frequencies, dt_eff, nsub=nsub,
                           group_size=group_size, widths=widths,
                           pad_groups_to=mesh_pad_groups(len(dms),
                                                         group_size, mesh))
    if chunk_payload is None:
        chunk_payload = default_chunk_payload(plan.min_overlap)
    payload = min(chunk_payload, n_ds)
    if payload <= plan.min_overlap:
        payload = min(n_ds, 2 * plan.min_overlap + 1)
    return plan, payload, n_ds


def run_step(src, dms, factor: int, nsub: int, group_size: int,
             widths: Tuple[int, ...], chunk_payload: Optional[int],
             device, verbose: bool = False, engine: str = "auto",
             label: str = "", checkpoint: Optional[SweepCheckpoint] = None,
             keep_chunk_peaks: bool = False, ckpt_extra: str = "",
             host_downsample: bool = False, mesh=None
             ) -> Optional[StepResult]:
    """Sweep ``dms`` over ``src`` downsampled by ``factor`` with the chunk
    ``engine``. ``group_size`` <= 0 picks the largest group within the
    smearing bound. ``checkpoint`` checkpoints the pass and resumes it,
    the source re-rooted at the cursor; ``ckpt_extra`` joins its
    fingerprint (the mask tag). ``host_downsample`` sums eligible
    blocks on the host (:func:`host_downsample_wins`). ``mesh`` shards the
    trial groups over its ``'dm'`` axis (``device`` is then its first
    device)."""
    dt_eff = src.tsamp * factor
    if src.nsamples // factor == 0:
        return None
    plan, payload, _ = step_geometry(src, dms, factor, nsub, group_size,
                                     widths, chunk_payload, mesh)
    if verbose:
        print(f"# {label}downsamp={factor} dt={dt_eff:.3e}s "
              f"DMs {dms[0]:.2f}..{dms[-1]:.2f} ({len(dms)} trials, "
              f"group {plan.group_size}) payload={payload}")

    def block_factory(cursor_ds: int):
        # the cursor sits on a payload boundary, so the re-rooted blocks
        # are the ones the original stream would have given from there
        seeked = reroot_source(src, cursor_ds * factor)
        return downsampled_blocks(src if seeked is None else seeked, factor,
                                  payload, plan.min_overlap, device,
                                  host_downsample)

    # sink-only span (aggregate=False): it encloses the sweep loop's
    # stages, which must stay non-overlapping in the flat table
    with telemetry.span("sweep_step", aggregate=False, downsamp=factor,
                        n_trials=len(dms), payload=int(payload)):
        res = sweep_stream(
            plan, downsampled_blocks(src, factor, payload, plan.min_overlap,
                                     device, host_downsample),
            payload, engine=engine, device=device, checkpoint=checkpoint,
            keep_chunk_peaks=keep_chunk_peaks, block_factory=block_factory,
            checkpoint_context=ckpt_extra, mesh=mesh)
    if verbose and res.engine_info.get("engine") == "tree":
        info = res.engine_info
        print(f"# {label}tree: {info['merge_levels']} merge levels, "
              f"{info['rows']} rows, {info['adds_per_sample']} adds per "
              f"sample, {info['state_bytes'] / 1e9:.2f} GB of state")
    return StepResult(downsamp=factor, dt=dt_eff, result=res)


def dats_geometry(reader, dms, downsamp: int = 1, nsub: int = 64,
                  group_size: int = 32, chunk_payload: Optional[int] = None,
                  mesh=None):
    """(plan, payload, T_ds) of the streamed series pass for these
    parameters: a plan of the trial DMs with one boxcar width (the series
    needs no detection overlap), the chunk payload and the downsampled
    series length. ``group_size`` <= 0 picks the group automatically;
    ``mesh`` pads the groups to its ``'dm'`` multiple."""
    return step_geometry(ReaderSource(reader), dms, max(1, int(downsamp)),
                         nsub, group_size, (1,), chunk_payload, mesh)


def iter_device_chunks(reader, dms, downsamp: int = 1, nsub: int = 64,
                       group_size: int = 32,
                       chunk_payload: Optional[int] = None, rfimask=None,
                       engine: str = "auto", device="cuda",
                       dispatch_point: Optional[str] = None,
                       host_downsample: bool = False, mesh=None,
                       shard_parts: bool = False,
                       window: Optional[Tuple[int, int]] = None):
    """Stream the file once on ``device`` and yield ``(pos, valid,
    series)``: each chunk's ``[D, payload]`` dedispersed series of every
    (group-padded) trial on the device, by the chunk ``engine``, of which
    the first ``valid = min(payload, T - pos)`` samples belong to it. No
    baseline is subtracted; the tail past the end of data is zero-padded
    to the chunk's length. ``pos`` is the downsampled sample of the
    chunk's start. ``rfimask`` (an
    :class:`~pypulsar_tpu_torch.io.rfimask.RfifindMask`) fills the zapped
    cells of each raw block before it is downsampled. With
    ``dispatch_point`` each chunk's dispatch trips that fault point and
    halves its trial groups on a device OOM
    (:class:`~pypulsar_tpu_torch.parallel.sweep.GroupHalving`).
    ``host_downsample`` sums eligible blocks on the host
    (:func:`host_downsample_wins`). ``mesh`` shards the trial groups over
    its ``'dm'`` axis (padded to its multiple; ``device`` is its first
    device): the series gather there in group order, or with
    ``shard_parts`` stay on their shards' devices as a list. ``window``
    ``(s0, s1)`` (downsampled samples, whole chunks: a time shard's)
    streams only the chunks that start in it."""
    factor = max(1, int(downsamp))
    dms = np.asarray(dms, dtype=np.float64)
    device = mesh_home(mesh) if mesh is not None else resolve_device(device)
    plan, payload, T = dats_geometry(reader, dms, downsamp=factor, nsub=nsub,
                                     group_size=group_size,
                                     chunk_payload=chunk_payload, mesh=mesh)
    need = payload + plan.min_overlap
    what = (dispatch_point.rsplit("_dispatch", 1)[0]
            if dispatch_point is not None else "")
    if mesh is not None:
        eng = ShardedChunkEngine(mesh, engine, plan.stage1_bins,
                                 plan.stage2_bins, plan.nsub, payload,
                                 plan.max_shift2, need, point=dispatch_point,
                                 what=what)
    else:
        eng = ChunkEngine(engine, plan.stage1_bins, plan.stage2_bins,
                          plan.nsub, payload, plan.max_shift2, need, device)
        if dispatch_point is not None:
            eng = GroupHalving(eng, dispatch_point, what)
    if window is None:
        src = make_source(reader, rfimask, device)
    else:
        s0, s1 = window
        src = guard_source(ReaderSource(
            reader, s0 * factor, s1 * factor if s1 < T else None))
        if rfimask is not None:
            src = MaskedSource(src, rfimask, device)
    for pos, block in downsampled_blocks(src, factor, payload,
                                         plan.min_overlap, device,
                                         host_downsample):
        L = int(block.shape[1])
        if L < need:  # tail: zero-pad to the chunk's length
            block = F.pad(block, (0, need - L))
        yield pos, min(payload, T - pos), (
            eng.series_parts(block) if shard_parts else eng.series(block))


def iter_dedispersed_chunks(reader, dms, downsamp: int = 1, nsub: int = 64,
                            group_size: int = 32,
                            chunk_payload: Optional[int] = None,
                            rfimask=None, engine: str = "auto",
                            device="cuda", verbose: bool = False, mesh=None,
                            window: Optional[Tuple[int, int]] = None):
    """:func:`iter_device_chunks` handed to the host: ``(pos, rows[D,
    valid])`` float32 chunks of every real DM trial's series, the values a
    ``.dat`` file holds. Each chunk's pull is a ``dedisperse_chunk`` span
    (the dedispersion's launches are queued before it, so the span's wall
    is the wait for them and the copy) and counts in
    ``dedisperse.chunks`` and ``d2h.bytes``. ``mesh`` shards the trial
    groups over its ``'dm'`` axis (the rows are the single-device rows'
    bits); the span carries the mesh positions' ids and each position
    counts its chunks in ``device{id}.dedisperse.chunks``."""
    D = len(dms)
    attrs = {} if mesh is None else {"dev": mesh.axis_ids("dm")}
    for pos, valid, series in iter_device_chunks(
            reader, dms, downsamp=downsamp, nsub=nsub, group_size=group_size,
            chunk_payload=chunk_payload, rfimask=rfimask, engine=engine,
            device=device, mesh=mesh, window=window):
        # the plan pads trial groups to the group size (and the mesh's
        # multiple); only the real trials leave this generator
        with telemetry.span("dedisperse_chunk", n_trials=D,
                            valid=int(valid), **attrs):
            rows = series[:D, :valid].contiguous()
            count_d2h(rows)
            host = rows.cpu().numpy()
        if verbose:
            print(f"# dats chunk at {pos}: {valid} samples x {D} DMs")
        telemetry.counter("dedisperse.chunks")
        for i in attrs.get("dev", ()):
            telemetry.counter(f"device{i}.dedisperse.chunks")
        yield pos, host


def dat_truncate_paths(outbase: str, dms) -> List[str]:
    """Create (truncated) the per-DM ``{outbase}_DM{dm:.2f}.dat`` paths.
    Bytes accumulate in ``{path}.tmp`` and land on the final name only at
    :func:`dat_finalize_paths` (tmp + os.replace): a killed run leaves tmp
    debris, never a truncated ``.dat`` that a later stage would trust."""
    paths = [f"{outbase}_DM{dm:.2f}.dat" for dm in dms]
    # truncate once, then reopen per chunk in append mode: one open
    # descriptor per DM trial would hit the fd limit on large grids
    for p in paths:
        open(p + ".tmp", "wb").close()
    return paths


def dat_append_rows(paths: List[str], rows) -> None:
    """Append one chunk's [D, valid] float32 rows to the per-DM .dat
    byte streams (to the ``.tmp`` staging names). The fault point
    ``dats.append`` is a kill point mid-stream."""
    faultinject.trip("dats.append")
    for p, row in zip(paths, rows):
        with open(p + ".tmp", "ab") as f:
            row.tofile(f)


def dat_finalize_paths(paths: List[str]) -> None:
    """Atomically publish completed .dat streams (``.tmp`` -> final)."""
    for p in paths:
        os.replace(p + ".tmp", p)


def write_dat_infs(outbase: str, reader, dms, N: int, dt: float) -> None:
    """PRESTO .inf sidecars of the per-DM series ``{outbase}_DM{dm:.2f}``."""
    freqs = np.asarray(ReaderSource(reader).frequencies)
    for dm in np.asarray(dms, dtype=np.float64):
        base = f"{outbase}_DM{dm:.2f}"
        make_dat_inf(base, reader, float(dm), N, dt, freqs).to_file(
            base + ".inf")


def make_dat_inf(basenm: str, reader, dm: float, N: int, dt: float,
                 freqs: np.ndarray) -> InfoData:
    """InfoData of a dedispersed series of this reader."""
    inf = InfoData()
    inf.basenm = os.path.basename(basenm)
    inf.telescope = getattr(reader, "telescope", "unknown") or "unknown"
    inf.object = getattr(reader, "source_name", "synthetic") or "synthetic"
    inf.epoch = float(getattr(reader, "tstart", 0.0) or 0.0)
    inf.N = int(N)
    inf.dt = float(dt)
    inf.DM = float(dm)
    inf.numchan = len(freqs)
    inf.lofreq = float(freqs.min())
    inf.BW = float(abs(freqs.max() - freqs.min()))
    inf.chan_width = float(inf.BW / max(inf.numchan - 1, 1))
    inf.bary = 0
    inf.analyzer = "pypulsar_tpu_torch"
    return inf


def sweep_flat(source, dms, downsamp: int = 1, nsub: int = 64,
               group_size: int = 32, widths: Sequence[int] = DEFAULT_WIDTHS,
               chunk_payload: Optional[int] = None, verbose: bool = False,
               engine: str = "auto", rfimask=None, device="cuda",
               checkpoint_path: Optional[str] = None,
               checkpoint_every: int = 16,
               keep_chunk_peaks: bool = False,
               host_downsample: bool = False, mesh=None
               ) -> StagedSweepResult:
    """Single-step sweep of an explicit DM grid over a filterbank reader,
    streamed in chunks of ``chunk_payload`` (default: 2^18 samples less
    the overlap) on ``device``. ``rfimask`` (an
    :class:`~pypulsar_tpu_torch.io.rfimask.RfifindMask`) applies the
    median-mid80 mask fill per raw block. ``checkpoint_path`` checkpoints
    the pass every ``checkpoint_every`` chunks and resumes from it;
    ``keep_chunk_peaks`` keeps each chunk's peaks
    (:meth:`StagedSweepResult.events`); ``host_downsample`` sums
    eligible blocks on the host (:func:`host_downsample_wins`). ``mesh``
    shards the trial groups over its ``'dm'`` axis (``device`` is then
    its first device)."""
    resolve_engine(engine)
    device = mesh_home(mesh) if mesh is not None else resolve_device(device)
    src = make_source(source, rfimask, device)
    ckpt = (SweepCheckpoint(checkpoint_path, every=checkpoint_every)
            if checkpoint_path else None)
    step = run_step(src, np.asarray(dms, dtype=np.float64),
                    int(downsamp), nsub, group_size, tuple(widths),
                    chunk_payload, device, verbose=verbose, engine=engine,
                    checkpoint=ckpt, keep_chunk_peaks=keep_chunk_peaks,
                    ckpt_extra=mask_tag(rfimask),
                    host_downsample=host_downsample, mesh=mesh)
    return StagedSweepResult(steps=[] if step is None else [step],
                             quality=stream_quality(src))


def sweep_ddplan(source, ddplan, nsub: int = 64, group_size: int = 32,
                 widths: Sequence[int] = DEFAULT_WIDTHS,
                 chunk_payload: Optional[int] = None, verbose: bool = False,
                 engine: str = "auto", rfimask=None, device="cuda",
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 16,
                 host_downsample: bool = False, mesh=None
                 ) -> StagedSweepResult:
    """Sweep every step of ``ddplan`` (a
    :class:`~pypulsar_tpu_torch.plan.ddplan.DDplan`) over the reader
    ``source``: step i sweeps ``step.DMs`` at ``step.downsamp`` times the
    sampling time, one pass over the file each, through the chunk
    ``engine``; ``chunk_payload`` is in downsampled samples.

    ``checkpoint_path`` is a base path: step i checkpoints its pass to
    ``{path}.step{i}.npz`` and, once done, writes its result to
    ``{path}.step{i}.done.npz``. A resumed plan loads each finished step
    from its marker (when the marker's fingerprint, the input's probe
    included, matches), resumes the interrupted step from its cursor and
    removes the markers when the whole plan has finished.
    ``host_downsample`` sums each step's eligible blocks on the host
    (:func:`host_downsample_wins`; the results have the same bits either
    way). ``mesh`` shards every step's trial groups over its ``'dm'``
    axis; the markers' fingerprint carries its size, as in the
    reference."""
    engine = resolve_engine(engine)
    device = mesh_home(mesh) if mesh is not None else resolve_device(device)
    src = make_source(source, rfimask, device)
    mtag = mask_tag(rfimask)
    context = f"engine={engine}{mesh_tag(mesh)}{mtag}"
    probe = _source_probe(src) if checkpoint_path else b""
    steps: List[StepResult] = []
    done_fns: List[str] = []
    for si, step in enumerate(ddplan.DDsteps):
        dms = np.asarray(step.DMs, dtype=np.float64)
        ckpt = done_fn = None
        if checkpoint_path:
            done_fn = f"{checkpoint_path}.step{si}.done.npz"
            fp = _step_fingerprint(src, dms, int(step.downsamp), nsub,
                                   group_size, tuple(widths), chunk_payload,
                                   context, probe)
            sr = _load_step_result(done_fn, fp)
            if sr is not None:
                if verbose:
                    print(f"# step {si}: resumed from {done_fn}")
                steps.append(sr)
                done_fns.append(done_fn)
                continue
            ckpt = SweepCheckpoint(f"{checkpoint_path}.step{si}.npz",
                                   every=checkpoint_every)
        sr = run_step(src, dms, int(step.downsamp), nsub, group_size,
                      tuple(widths), chunk_payload, device, verbose=verbose,
                      engine=engine, label=f"step {si}: ", checkpoint=ckpt,
                      ckpt_extra=mtag, host_downsample=host_downsample,
                      mesh=mesh)
        if sr is None:
            break
        if done_fn:
            _save_step_result(done_fn, sr, fp)
            done_fns.append(done_fn)
        steps.append(sr)
    for fn in done_fns:  # the whole plan has finished
        if os.path.exists(fn):
            os.remove(fn)
    return StagedSweepResult(steps=steps, quality=stream_quality(src))


def sweep_ddplan_2d(source, ddplan, mesh, nsub: int = 64,
                    group_size: int = 8,
                    widths: Sequence[int] = DEFAULT_WIDTHS,
                    engine: str = "auto",
                    max_trials_per_step: Optional[int] = None,
                    rfimask=None) -> StagedSweepResult:
    """Each DDplan step as one chunk over a 2-D ``'dm'`` x ``'time'``
    ``mesh`` (the reference's): the step's whole downsampled series, less
    its per-channel float32 mean, is cut into ``mesh.shape['time']``
    shards of ``n_ds // nt`` samples, halos pass between neighbours by
    device-to-device copies and the trial groups shard over ``'dm'``
    (``parallel/sweep.make_sharded_sweep_chunk_2d``). Against the 1-D
    sweep at a payload of one time shard, the window maxima and their
    samples are bit-identical and the SNR agrees within float64
    re-association of the moments. ``max_trials_per_step`` caps each
    step's trials. The tree engine is refused."""
    engine = resolve_engine(engine)
    home = mesh.devices.flat[0]
    src = make_source(source, rfimask, home)
    nd, nt = int(mesh.shape["dm"]), int(mesh.shape["time"])
    steps: List[StepResult] = []
    for si, step in enumerate(ddplan.DDsteps):
        factor = int(step.downsamp)
        dms = np.asarray(step.DMs, dtype=np.float64)
        if max_trials_per_step is not None:
            dms = dms[:max_trials_per_step]
        dt_eff = src.tsamp * factor
        n_ds = src.nsamples // factor
        if n_ds == 0:
            break
        plan = make_sweep_plan(
            dms, src.frequencies, dt_eff, nsub=nsub, group_size=group_size,
            widths=tuple(widths),
            pad_groups_to=padded_group_count(-(-len(dms) // group_size), nd))
        local_payload = n_ds // nt
        if plan.min_overlap >= local_payload:
            raise ValueError(
                f"step {si}: time shard {local_payload} samples does not "
                f"cover the halo {plan.min_overlap}; fewer 'time' shards "
                f"or more data needed")
        T_used = local_payload * nt
        blocks = [b for _, b in downsampled_blocks(src, factor, n_ds, 0,
                                                   home)]
        data = torch.cat(blocks, dim=1)[:, :T_used]
        base = data.mean(dim=1, keepdim=True)
        base_sum = float(base.double().sum().item())
        fn = make_sharded_sweep_chunk_2d(
            mesh, plan.nsub, local_payload, plan.min_overlap,
            plan.max_shift2, tuple(plan.widths), engine=engine)
        with telemetry.span("sweep_step_2d", aggregate=False,
                            downsamp=factor, n_trials=len(dms),
                            payload=int(local_payload)):
            s, ss, mb, ab = fn(data - base, plan.stage1_bins,
                               plan.stage2_bins)
        del data, blocks
        res = finalize_sweep(plan, T_used, s, ss, mb, ab,
                             baseline_sum=base_sum)
        steps.append(StepResult(downsamp=factor, dt=dt_eff, result=res))
    return StagedSweepResult(steps=steps, quality=stream_quality(src))


def _source_probe(src) -> bytes:
    """The first 1024 samples of every channel of the file, decoded on
    the CPU: a marker of another input of the same geometry is not
    resumed. Read under the scrub and the mask, whose accounts it would
    otherwise join."""
    while isinstance(src, (MaskedSource, GuardedSource)):
        src = src._src
    blocks = src.chan_major_blocks(min(1024, src.nsamples), 0,
                                   torch.device("cpu"))
    try:
        _, block = next(blocks)
        return block.numpy().tobytes()
    except Exception:  # noqa: BLE001 - the probe is best-effort
        return b""
    finally:
        blocks.close()


def _step_fingerprint(src, dms, factor: int, nsub: int, group_size: int,
                      widths, chunk_payload: Optional[int], context: str,
                      probe: bytes) -> str:
    """Hash of everything a step's result depends on: its DMs, the band,
    sample time and length, the downsampling, plan geometry, payload (the
    default as the negated :data:`DEFAULT_CHUNK_FFT_LEN`), widths, the
    engine and mask (``context``) and the input's ``probe``."""
    h = hashlib.sha256()
    for part in (np.asarray(dms, dtype=np.float64).tobytes(),
                 np.asarray(src.frequencies, dtype=np.float64).tobytes(),
                 np.float64([src.tsamp]).tobytes(),
                 np.int64([src.nsamples, factor, nsub, group_size,
                           -DEFAULT_CHUNK_FFT_LEN if chunk_payload is None
                           else chunk_payload]).tobytes(),
                 np.int64(widths).tobytes(), context.encode(), probe):
        h.update(part)
    return h.hexdigest()


def _save_step_result(path: str, sr: StepResult, fingerprint: str) -> None:
    """A finished step's result, written atomically."""
    res = sr.result
    tmp = path + ".tmp.npz"
    np.savez(tmp, fingerprint=fingerprint, downsamp=sr.downsamp, dt=sr.dt,
             dms=res.dms, widths=np.asarray(res.widths, dtype=np.int64),
             snr=res.snr, peak_sample=res.peak_sample, mean=res.mean,
             std=res.std)
    os.replace(tmp, path)


def _load_step_result(path: str, fingerprint: str) -> Optional[StepResult]:
    """The step result of a marker with this fingerprint, else None (a
    missing, foreign or corrupt marker: the step is swept again)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            if str(z["fingerprint"]) != fingerprint:
                return None
            res = SweepResult(
                dms=z["dms"], widths=tuple(int(w) for w in z["widths"]),
                snr=z["snr"], peak_sample=z["peak_sample"], mean=z["mean"],
                std=z["std"])
            return StepResult(downsamp=int(z["downsamp"]), dt=float(z["dt"]),
                              result=res)
    except Exception:  # noqa: BLE001 - a corrupt marker: sweep the step
        return None
