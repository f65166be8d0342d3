"""The DM-trial sweep on one device: two-stage subband dedispersion of
every trial followed by boxcar detection statistics, streamed over the
time axis in overlap-save chunks.

Port of the single-device core of ``pypulsar_tpu/parallel/sweep.py``.
The ``gather`` engine (the reference's bit-parity formulation, and
``auto``'s choice off a TPU):

  stage 1: each trial group shifts its channels to the group's mean DM and
     sums them into ``nsub`` subbands;
  stage 2: each trial shifts and sums its group's subbands at its own DM;
  then: per-trial payload moments and, per boxcar width, the window-sum
     maximum and its first start.

``engine="tree"`` (``ops/tree_dedisperse.py``: shared pairwise merge
levels with the exact shifts) and ``engine="fourier"``
(``ops/fourier_dedisperse.py``: phase multiply-reduce between FFTs) give
the same statistics within 2e-6 relative SNR; :class:`ChunkEngine` runs
any of them over a stream of chunks. ``engine="scan"`` is the
reference's sequential formulation: stage 1 adds each subband's shifted
channel rows one after another from row 0, which is the order in which
the gather-sum kernel and its plain version add every output row, so the
port runs it through the gather engine's launches and its statistics
have the gather engine's bits.

:func:`sweep_resident` is the reference's sweep of a device-resident
``[C, T]`` array: :func:`sweep_spectra` of its whole chunks.

Sharding over a device mesh (``parallel/mesh.py``): with ``mesh=`` the
trial groups split into contiguous blocks, one per ``'dm'`` position
(:class:`ShardedChunkEngine`, :func:`make_sharded_sweep_chunk`,
:func:`make_sharded_series_chunk`); every position runs its groups
through its own engine on its own device, with no sync between shards,
and the rows gather in group order. A group's rows depend on no other
group, and the kernels add in a fixed order without atomics, so a shard
computes exactly the single-device rows: sharded results are
bit-identical at any device count. The group count must divide the
``'dm'`` size (``make_sweep_plan(pad_groups_to=)``; padded groups repeat
the last real DM and are dropped from the result). A chunk reaches each
distinct device once. :func:`make_sharded_sweep_chunk_2d` also splits
the time axis over ``'time'`` (the right neighbour's overlap comes by a
device-to-device copy); its moment sums re-associate, so its peaks are
bit-identical and its SNR agrees within float64 rounding.

Both ``gather`` stages are one :func:`~pypulsar_tpu_torch.ops.gather_sum.shifted_gather_sum`
each over ALL trial groups of a chunk (the reference scans the groups
one by one), in its shared-source form: at stage 1 source set ``s`` is
subband ``s``'s channels ``s*per + k``, read by every group ``j`` of the
batch into row ``j*nsub + s``; at stage 2 source set ``g`` is group
``g``'s stacked subbands ``g*nsub + s``, read by each of its trials ``i``
into row ``g*gs + i``. Groups are split, in order, only where the stacked
subbands would pass :data:`SUBBAND_BUDGET_BYTES`.

SNR accumulation-order contract (the reference's): a single per-channel
baseline (the f32 mean of the first streamed block, or the caller's) is
subtracted before dedispersion; dedispersion and per-chunk statistics run
in float32 on the device; the cross-chunk moments, the cross-chunk max
(strict >: the earlier chunk keeps a tie) and the SNR formula run on the
host in float64.

Kill and resume (:class:`SweepCheckpoint`): every ``every`` drained chunks
the host accumulator, the cursor (first payload sample not accumulated)
and the baseline are written atomically; a resumed stream accumulates the
remaining chunks in the same order, so its result has the uninterrupted
run's bits. With ``keep_chunk_peaks`` each chunk's window maxima are kept
too (:meth:`SweepResult.events`, the per-chunk single-pulse events), and
checkpointed with the rest.

Telemetry (``obs/telemetry.py``, the reference's names): per streamed
chunk the ``sweep.chunks`` counter, the ``sweep.pending_depth`` gauge and
a ``sweep.chunk`` event (``start``, ``stat_len``, ``pending``); the
profiling stages ``block_source``, ``host_to_device``,
``dispatch_sweep_chunk``, ``device_wait+accumulate`` and
``checkpoint_save``; at the end ``sweep.trials_completed``,
``sweep.payload_samples`` and a ``sweep_stream_end`` device snapshot. A
chunk's dispatch is the fault point ``sweep.chunk_dispatch`` and halves
its trial groups on a device OOM (``resilience.retry.halving_dispatch``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pypulsar_tpu_torch.compile import register_warmer
from pypulsar_tpu_torch.core import psrmath
from pypulsar_tpu_torch.core.device import count_d2h, resolve_device
from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.ops import fourier_dedisperse as fdd
from pypulsar_tpu_torch.ops import tree_dedisperse as tdd
from pypulsar_tpu_torch.ops.boxcar_stats import boxcar_stats
from pypulsar_tpu_torch.ops.gather_sum import (
    GatherTables,
    gather_tables,
    shifted_gather_sum,
)
from pypulsar_tpu_torch.parallel.mesh import (
    gather_rows,
    on_device,
    replicate,
)
from pypulsar_tpu_torch.resilience import faultinject
from pypulsar_tpu_torch.resilience.retry import halving_dispatch
from pypulsar_tpu_torch.utils import profiling

DEFAULT_WIDTHS = (1, 2, 4, 8, 16, 32)
DEFAULT_CHUNK_FFT_LEN = 1 << 18
#: stacked stage-1 subbands one launch may hold; more trial groups split
SUBBAND_BUDGET_BYTES = 4 << 30
#: chunks queued on the device ahead of the host's read-back
MAX_PENDING = 2
ENGINES = ("gather", "scan", "tree", "fourier")


def resolve_engine(engine: str = "auto") -> str:
    """The chunk formulation: ``gather``, ``scan``, ``tree`` or
    ``fourier``; ``auto`` is ``gather``, the reference's choice off a
    TPU."""
    if engine == "auto":
        return "gather"
    if engine in ENGINES:
        return engine
    raise ValueError(f"unknown sweep engine {engine!r}; expected one of "
                     f"{ENGINES + ('auto',)}")


def choose_group_size(dms, freqs, dt: float, nsub: int = 64,
                      max_extra_smear_bins: float = 1.0,
                      max_group: int = 128) -> int:
    """Largest power-of-two stage-1 group whose extra subband smearing
    (a trial at the group edge is dedispersed at the group mean DM within
    each subband) stays under ``max_extra_smear_bins`` samples."""
    dms = np.asarray(dms, dtype=np.float64)
    if len(dms) < 2:
        return 1
    ddm = float(np.max(np.abs(np.diff(dms))))
    freqs = np.asarray(freqs, dtype=np.float64)
    f_low = float(freqs.min())
    bw_sub = float(abs(freqs.max() - freqs.min())) / nsub
    g = 1
    while g * 2 <= max_group:
        off = g * ddm
        if psrmath.dm_smear(off, bw_sub, f_low) > max_extra_smear_bins * dt:
            break
        g *= 2
    return g


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """Host-side geometry of a sweep.

    stage1_bins[G, C]    int32  per-group per-channel shifts (to group subdm)
    stage2_bins[G, g, S] int32  per-trial per-subband shifts (trial dm)
    dms[G*g] float64 trial DMs (padded trials repeat the last real one)
    """

    dms: np.ndarray
    freqs: np.ndarray
    dt: float
    nsub: int
    group_size: int
    stage1_bins: np.ndarray
    stage2_bins: np.ndarray
    subdms: np.ndarray
    n_real_trials: int
    widths: Tuple[int, ...] = DEFAULT_WIDTHS

    @property
    def n_groups(self) -> int:
        return self.stage1_bins.shape[0]

    @property
    def n_trials(self) -> int:
        return self.n_groups * self.group_size

    @property
    def max_shift1(self) -> int:
        return int(self.stage1_bins.max(initial=0))

    @property
    def max_shift2(self) -> int:
        return int(self.stage2_bins.max(initial=0))

    @property
    def min_overlap(self) -> int:
        return self.max_shift1 + self.max_shift2 + max(self.widths)


def make_sweep_plan(dms: Sequence[float], freqs: np.ndarray, dt: float,
                    nsub: int = 64, group_size: int = 32,
                    widths: Tuple[int, ...] = DEFAULT_WIDTHS,
                    pad_groups_to: Optional[int] = None) -> SweepPlan:
    """Integer shift tables from float64 host math, bit-identical to the
    reference's. Channels must be high-frequency-first.
    ``pad_groups_to`` pads the plan to that many trial groups (a mesh's
    ``'dm'`` multiple); padded trials repeat the last real DM."""
    dms = np.asarray(dms, dtype=np.float64)
    freqs = np.asarray(freqs, dtype=np.float64)
    if group_size <= 0:
        group_size = choose_group_size(dms, freqs, dt, nsub)
    C = len(freqs)
    if C > 1 and not np.all(np.diff(freqs) <= 0):
        raise ValueError(
            "make_sweep_plan needs monotonically descending (high-"
            "frequency-first) channels: flip/sort the data and frequency "
            "axes first (the staged block sources flip ascending tables "
            "automatically)")
    if C % nsub:
        raise ValueError(f"nsub={nsub} must divide nchan={C}")
    per = C // nsub
    n_real = len(dms)
    G = -(-n_real // group_size)
    if pad_groups_to is not None:
        if pad_groups_to < G:
            raise ValueError("pad_groups_to smaller than required groups")
        G = int(pad_groups_to)
    padded = np.concatenate([dms, np.repeat(dms[-1], G * group_size - n_real)])

    sub_hif = freqs[np.arange(nsub) * per]  # top frequency of each subband
    f_ref = freqs.max()
    stage1 = np.zeros((G, C), dtype=np.int32)
    stage2 = np.zeros((G, group_size, nsub), dtype=np.int32)
    subdms = np.zeros(G, dtype=np.float64)
    for gi in range(G):
        block = padded[gi * group_size:(gi + 1) * group_size]
        subdm = float(np.mean(block))
        subdms[gi] = subdm
        d_chan = psrmath.delay_from_DM(subdm, freqs)
        d_ref = np.repeat(psrmath.delay_from_DM(subdm, sub_hif), per)
        stage1[gi] = np.round((d_chan - d_ref) / dt).astype(np.int32)
        for ti, dm in enumerate(block):
            d_sub = psrmath.delay_from_DM(dm, sub_hif)
            d0 = psrmath.delay_from_DM(dm, f_ref)
            stage2[gi, ti] = np.round((d_sub - d0) / dt).astype(np.int32)
    return SweepPlan(dms=padded, freqs=freqs, dt=float(dt), nsub=nsub,
                     group_size=group_size, stage1_bins=stage1,
                     stage2_bins=stage2, subdms=subdms, n_real_trials=n_real,
                     widths=tuple(widths))


def padded_group_count(n_groups: int, ndm: int = 1) -> int:
    """The group count rounded up to a multiple of a mesh's ``'dm'``
    size ``ndm`` (the reference's, without its compile buckets)."""
    ndm = max(1, int(ndm))
    return -(-int(n_groups) // ndm) * ndm


def mesh_dm(mesh) -> int:
    """The ``'dm'`` size of ``mesh``; 1 without a mesh."""
    return 1 if mesh is None else int(mesh.shape["dm"])


def mesh_tag(mesh) -> str:
    """The checkpoint fingerprint's mesh part, as in the reference
    (``/meshdm=K``); empty without a mesh, so a single-device checkpoint
    keeps its fingerprint."""
    return "" if mesh is None else f"/meshdm={mesh_dm(mesh)}"


def mesh_pad_groups(n_dms: int, group_size: int, mesh) -> Optional[int]:
    """The group padding that makes trial groups divide ``mesh``'s
    ``'dm'`` axis; None without a mesh."""
    if mesh is None:
        return None
    return padded_group_count(-(-int(n_dms) // group_size), mesh_dm(mesh))


def mesh_home(mesh) -> torch.device:
    """The device a mesh's results gather on: its first ``'dm'``
    position's."""
    return mesh.axis_devices("dm")[0]


def default_chunk_payload(min_overlap: int,
                          fft_len: int = DEFAULT_CHUNK_FFT_LEN) -> int:
    """Streaming chunk payload: ``fft_len`` samples (2^18, or a tuned
    chunk length), doubled until the overlap fits in half of it, less the
    overlap."""
    n = int(fft_len)
    while min_overlap >= n // 2:
        n <<= 1
    return n - min_overlap


@dataclasses.dataclass(frozen=True)
class GroupBatch:
    """Index tables of one launch of both stages over groups [g0, g1)."""

    g0: int
    g1: int
    stage1: GatherTables
    stage2: GatherTables


def group_batches(stage1_bins: np.ndarray, stage2_bins: np.ndarray,
                  nsub: int, L1: int, device,
                  budget: int = SUBBAND_BUDGET_BYTES) -> List[GroupBatch]:
    """Split the trial groups, in order, so that each batch's stacked
    [groups*nsub, L1] float32 subbands fit ``budget``, and lay out each
    batch's stage-1 and stage-2 tables on ``device``."""
    stage1_bins = np.asarray(stage1_bins, dtype=np.int32)
    stage2_bins = np.asarray(stage2_bins, dtype=np.int32)
    G, C = stage1_bins.shape
    gs = stage2_bins.shape[1]
    per = C // nsub
    step = max(1, int(budget) // max(1, nsub * L1 * 4))
    src1 = np.arange(C, dtype=np.int32).reshape(nsub, per)

    out = []
    for g0 in range(0, G, step):
        g1 = min(G, g0 + step)
        n = g1 - g0
        j = np.arange(n, dtype=np.int32)
        s = np.arange(nsub, dtype=np.int32)
        stage1 = gather_tables(
            src1, stage1_bins[g0:g1].reshape(n, nsub, per).transpose(1, 0, 2),
            j[None, :] * nsub + s[:, None], device, "stage1")
        stage2 = gather_tables(
            j[:, None] * nsub + s[None, :], stage2_bins[g0:g1],
            j[:, None] * gs + np.arange(gs, dtype=np.int32)[None, :], device,
            "stage2")
        out.append(GroupBatch(g0, g1, stage1, stage2))
    return out


def _dedisperse_batch(data, b: GroupBatch, out_len: int, L1: int):
    sub = shifted_gather_sum(data, b.stage1, L1)
    return shifted_gather_sum(sub, b.stage2, out_len)


def run_chunk(data, batches: Sequence[GroupBatch], out_len: int, L1: int,
              widths: Tuple[int, ...], stat_len: int):
    """Both stages and the boxcar statistics of one chunk ``data[C, L]``
    (L >= L1 + max stage-1 shift), batch by batch in group order; returns
    the list of per-batch (s, ss, mb, ab) device tensors."""
    return [boxcar_stats(_dedisperse_batch(data, b, out_len, L1), widths,
                         stat_len) for b in batches]


def dedisperse_batches(data, batches: Sequence[GroupBatch], out_len: int,
                       L1: int):
    """Two-stage dedispersed series [D, out_len] of one chunk ``data[C, L]``
    over the trial groups of ``batches``, in group order."""
    return torch.cat([_dedisperse_batch(data, b, out_len, L1)
                      for b in batches])


class ChunkEngine:
    """One engine's chunk kernels for one plan's shift tables, chunk
    geometry and device, built once for a stream of chunks: the gather
    engine's group batches, the tree engine's plan and state buffers
    (:class:`~pypulsar_tpu_torch.ops.tree_dedisperse.TreeState`, sized
    for chunks of ``need`` samples), or the Fourier engine's shift
    bounds. Chunks are ``data[C, L]`` with ``L >= need = out_len +
    slack2 +`` the largest stage-1 shift."""

    def __init__(self, engine: str, stage1_bins, stage2_bins, nsub: int,
                 out_len: int, slack2: int, need: int, device):
        self.engine = resolve_engine(engine)
        self.stage1_bins = np.asarray(stage1_bins, dtype=np.int32)
        self.stage2_bins = np.asarray(stage2_bins, dtype=np.int32)
        self.nsub, self.out_len, self.slack2 = nsub, out_len, slack2
        self.L1 = out_len + slack2
        self.need = need
        self.device = device
        self.batches = self.tree = None
        # the scan's stage-1 sum order is the gather-sum kernel's: it runs
        # the gather engine's launches
        if self.engine in ("gather", "scan"):
            self.batches = group_batches(self.stage1_bins, self.stage2_bins,
                                         nsub, self.L1, device)
        elif self.engine == "tree":
            self.tree = tdd.TreeState(
                tdd.plan_from_bins(self.stage1_bins, self.stage2_bins),
                need, device)

    def info(self) -> dict:
        """The engine and, for the tree, its structural numbers: merge
        levels, rows, adds per output sample, state bytes on the device."""
        out = {"engine": self.engine}
        if self.tree is not None:
            plan = self.tree.plan
            out.update(merge_levels=plan.n_levels, rows=plan.rows,
                       adds_per_sample=plan.adds_per_sample,
                       state_bytes=self.tree.nbytes)
        return out

    def _tree_series(self, data):
        # the tree reads no sample past need; its state has that width
        return self.tree.series(data[:, :self.need], self.out_len)

    def series(self, data):
        """The ``[D, out_len]`` dedispersed series of chunk ``data``."""
        if self.batches is not None:
            return dedisperse_batches(data, self.batches, self.out_len,
                                      self.L1)
        if self.engine == "tree":
            tdd.note_dispatch(self.tree.plan, data.shape[1], self.out_len)
            return self._tree_series(data)
        return fdd.dedisperse_series_fourier(
            data, self.stage1_bins, self.stage2_bins, self.nsub,
            self.out_len, fdd.fourier_chunk_len(data.shape[1]))

    def stats(self, data, widths: Tuple[int, ...], stat_len: int):
        """Per-trial (sum[D], sumsq[D], maxbox[D, W], argbox[D, W]) of
        chunk ``data`` on its device."""
        if self.batches is not None:
            parts = run_chunk(data, self.batches, self.out_len, self.L1,
                              widths, stat_len)
            return tuple(torch.cat([p[i] for p in parts]) for i in range(4))
        if self.engine == "tree":
            tdd.note_dispatch(self.tree.plan, data.shape[1], stat_len)
            return boxcar_stats(self._tree_series(data), widths, stat_len)
        # the lut mode's stage-1 bound falls out of the chunk's shape, as
        # in the reference
        return fdd.sweep_chunk_fourier(
            data, self.stage1_bins, self.stage2_bins, self.nsub,
            self.out_len, widths, stat_len,
            fdd.fourier_chunk_len(data.shape[1]),
            max_shift1=max(int(data.shape[1]) - self.L1, 0),
            max_shift2=self.slack2)


class GroupHalving:
    """A :class:`ChunkEngine`'s chunk dispatch over its trial groups under
    the OOM policy of ``resilience.retry.halving_dispatch``: a device OOM
    halves the groups, each half running on an engine of its slice of
    the shift tables (built on first use and kept). Each group's rows are
    its own, so the halves concatenate to the whole dispatch's.
    ``point`` names the fault point tripped before every dispatch."""

    def __init__(self, eng: ChunkEngine, point: str, what: str):
        self.eng, self.point, self.what = eng, point, what
        self.n_groups = int(eng.stage1_bins.shape[0])
        self._slices = {}

    def _engine(self, lo: int, hi: int) -> ChunkEngine:
        if (lo, hi) == (0, self.n_groups):
            return self.eng
        e = self._slices.get((lo, hi))
        if e is None:
            k = self.eng
            e = self._slices[(lo, hi)] = ChunkEngine(
                k.engine, k.stage1_bins[lo:hi], k.stage2_bins[lo:hi],
                k.nsub, k.out_len, k.slack2, k.need, k.device)
        return e

    def _run(self, method: str, *args):
        def one(lo, hi):
            faultinject.trip(self.point)
            return getattr(self._engine(lo, hi), method)(*args)

        got = [r for _, _, r in halving_dispatch(one, self.n_groups,
                                                 what=self.what)]
        if len(got) == 1:
            return got[0]
        if isinstance(got[0], tuple):
            return tuple(torch.cat([g[i] for g in got])
                         for i in range(len(got[0])))
        return torch.cat(got)

    def stats(self, data, widths: Tuple[int, ...], stat_len: int):
        """:meth:`ChunkEngine.stats` over every group."""
        return self._run("stats", data, widths, stat_len)

    def series(self, data):
        """:meth:`ChunkEngine.series` over every group."""
        return self._run("series", data)


class ShardedChunkEngine:
    """A :class:`ChunkEngine` per ``'dm'`` position of ``mesh`` (at
    ``'time'`` index 0), each over its contiguous block of the trial
    groups on its own device. A chunk reaches each distinct device once
    (:func:`~pypulsar_tpu_torch.parallel.mesh.replicate`), each position
    launches its own kernels with no sync between shards, and the rows
    gather on the first position's device in group order. With
    ``point`` each shard dispatches under :class:`GroupHalving` (its OOM
    halving and that fault point)."""

    def __init__(self, mesh, engine: str, stage1_bins, stage2_bins,
                 nsub: int, out_len: int, slack2: int, need: int,
                 point: Optional[str] = None, what: str = "sweep.chunk"):
        self.engine = resolve_engine(engine)
        self.devices = mesh.axis_devices("dm")
        self.ids = mesh.axis_ids("dm")
        self.home = self.devices[0]
        s1 = np.asarray(stage1_bins, dtype=np.int32)
        s2 = np.asarray(stage2_bins, dtype=np.int32)
        k = len(self.devices)
        if s1.shape[0] % k:
            raise ValueError(
                f"group count {s1.shape[0]} must divide the mesh 'dm' axis "
                f"{k}; use make_sweep_plan(pad_groups_to=...)")
        per = s1.shape[0] // k
        self.shards = []
        for i, dev in enumerate(self.devices):
            with on_device(dev):
                e = ChunkEngine(self.engine, s1[i * per:(i + 1) * per],
                                s2[i * per:(i + 1) * per], nsub, out_len,
                                slack2, need, dev)
            self.shards.append(GroupHalving(e, point, what)
                               if point is not None else e)

    def info(self) -> dict:
        """The first shard's :meth:`ChunkEngine.info`, the tree's rows and
        state bytes summed over the shards, and the ``'dm'`` size."""
        infos = [(s.eng if isinstance(s, GroupHalving) else s).info()
                 for s in self.shards]
        out = dict(infos[0], mesh_dm=len(self.shards))
        for key in ("rows", "state_bytes"):
            if key in out:
                out[key] = sum(i[key] for i in infos)
        return out

    def _run(self, method: str, data, *args, gather: bool = True):
        reps = replicate(data, self.devices)
        parts = []
        for i, (eng, x) in enumerate(zip(self.shards, reps)):
            with on_device(self.devices[i]):
                parts.append(getattr(eng, method)(x, *args))
            telemetry.counter(f"device{self.ids[i]}.sweep.dispatches")
        return gather_rows(parts, self.home) if gather else parts

    def stats(self, data, widths: Tuple[int, ...], stat_len: int):
        """Per-trial (sum, sumsq, maxbox, argbox) of chunk ``data`` over
        every shard, on the first position's device."""
        return self._run("stats", data, widths, stat_len)

    def series(self, data):
        """The ``[D, out_len]`` series of every shard, on the first
        position's device."""
        return self._run("series", data)

    def series_parts(self, data) -> list:
        """Each shard's series on its own device, in group order."""
        return self._run("series", data, gather=False)


def make_sharded_sweep_chunk(mesh, nsub: int, out_len: int, slack2: int,
                             widths, stat_len: int, engine: str = "gather"):
    """The chunk sweep with trial groups sharded over ``mesh``'s ``'dm'``
    axis: ``fn(data, stage1_bins, stage2_bins)`` -> per-trial (sum,
    sumsq, maxbox, argbox) on the first position's device, the
    single-device rows' bits. The group count must divide the axis
    (``make_sweep_plan(pad_groups_to=...)``)."""
    engine = resolve_engine(engine)

    def fn(data, stage1_bins, stage2_bins):
        return ShardedChunkEngine(
            mesh, engine, stage1_bins, stage2_bins, nsub, out_len, slack2,
            data.shape[1]).stats(data, tuple(widths), stat_len)

    return fn


def make_sharded_series_chunk(mesh, nsub: int, out_len: int, slack2: int,
                              engine: str = "gather"):
    """:func:`dedisperse_series_chunk` with trial groups sharded over
    ``mesh``'s ``'dm'`` axis: ``fn(data, stage1_bins, stage2_bins)`` ->
    the ``[D, out_len]`` series in group order on the first position's
    device, the single-device rows' bits."""
    engine = resolve_engine(engine)

    def fn(data, stage1_bins, stage2_bins):
        return ShardedChunkEngine(
            mesh, engine, stage1_bins, stage2_bins, nsub, out_len, slack2,
            data.shape[1]).series(data)

    return fn


def make_sharded_sweep_chunk_2d(mesh, nsub: int, local_payload: int,
                                overlap: int, slack2: int, widths,
                                engine: str = "gather"):
    """The chunk sweep sharded over both axes of ``mesh``: trial groups
    over ``'dm'`` and the time axis over ``'time'``. Returns
    ``fn(data, stage1_bins, stage2_bins)`` for ``data[C, T]`` with ``T =
    local_payload * mesh.shape['time']`` (on any device).

    Time shard ``ti`` holds ``data[:, ti*P:(ti+1)*P]`` on the devices of
    its column and takes the first ``overlap`` samples of its right
    neighbour's shard by a device-to-device copy (the reference's
    ``ppermute``; the last shard gets zeros, the streamed tail's). Each
    device sweeps its groups over its shard with ``stat_len = P``; the
    moment sums add over the time shards in float64 in time order, and
    the window maxima reduce with the earliest shard keeping a tie, at
    global sample starts. Returns host numpy (sum, sumsq, maxbox,
    argbox) in group order. The tree engine is refused, as in the
    reference."""
    engine = resolve_engine(engine)
    if engine == "tree":
        raise ValueError(
            "engine='tree' supports the 1-D 'dm' mesh only (its merge "
            "tables are host-built per device); use gather/scan/fourier "
            "on the dm x time mesh")
    widths = tuple(widths)
    out_len = local_payload + max(widths)
    nd, nt = int(mesh.shape["dm"]), int(mesh.shape["time"])
    if overlap > local_payload and nt > 1:
        raise ValueError(f"time shard {local_payload} samples does not "
                         f"cover the halo {overlap}")

    def fn(data, stage1_bins, stage2_bins):
        s1 = np.asarray(stage1_bins, dtype=np.int32)
        s2 = np.asarray(stage2_bins, dtype=np.int32)
        C, T = data.shape
        if T != local_payload * nt:
            raise ValueError(f"data has {T} samples; the mesh needs "
                             f"{local_payload} x {nt}")
        if s1.shape[0] % nd:
            raise ValueError(
                f"group count {s1.shape[0]} must divide the mesh 'dm' "
                f"axis {nd}; use make_sweep_plan(pad_groups_to=...)")
        per = s1.shape[0] // nd
        need = local_payload + overlap
        # each time shard on its column's devices, once per distinct card
        shards = [replicate(data[:, ti * local_payload:
                                 (ti + 1) * local_payload].contiguous(),
                            [mesh.devices[di, ti] for di in range(nd)])
                  for ti in range(nt)]
        rows = []
        for di in range(nd):
            acc = None
            for ti in range(nt):
                dev = mesh.devices[di, ti]
                local = shards[ti][di]
                if ti + 1 < nt:
                    halo = shards[ti + 1][di][:, :overlap].to(dev)
                else:
                    halo = torch.zeros((C, overlap), dtype=local.dtype,
                                       device=dev)
                with on_device(dev):
                    eng = ChunkEngine(engine, s1[di * per:(di + 1) * per],
                                      s2[di * per:(di + 1) * per], nsub,
                                      out_len, slack2, need, dev)
                    ext = torch.cat([local, halo], dim=1)
                    if ext.shape[1] < need:
                        ext = F.pad(ext, (0, need - ext.shape[1]))
                    s, ss, mb, ab = (t.cpu().numpy() for t in eng.stats(
                        ext, widths, local_payload))
                telemetry.counter(
                    f"device{int(mesh.ids[di, ti])}.sweep.dispatches")
                s = s.astype(np.float64)
                ss = ss.astype(np.float64)
                ab = ab.astype(np.int64) + ti * local_payload
                if acc is None:
                    acc = [s, ss, mb, ab]
                    continue
                acc[0] = acc[0] + s
                acc[1] = acc[1] + ss
                better = mb > acc[2]  # the earlier shard keeps a tie
                acc[2] = np.where(better, mb, acc[2])
                acc[3] = np.where(better, ab, acc[3])
            rows.append(acc)
        return tuple(np.concatenate([r[i] for r in rows])
                     for i in range(4))

    return fn


def sweep_chunk(data, stage1_bins, stage2_bins, nsub: int, out_len: int,
                slack2: int, widths, stat_len: int, engine: str = "gather"):
    """One chunk for all trial groups (the reference's ``sweep_chunk``):
    data[C, L] with L >= out_len + slack2 + max stage-1 shift; returns
    per-trial (sum[D], sumsq[D], maxbox[D, W], argbox[D, W]) on data's
    device."""
    eng = ChunkEngine(engine, stage1_bins, stage2_bins, nsub, out_len,
                      slack2, data.shape[1], data.device)
    return eng.stats(data, tuple(widths), stat_len)


def dedisperse_series_chunk(data, stage1_bins, stage2_bins, nsub: int,
                            out_len: int, slack2: int,
                            engine: str = "gather"):
    """Two-stage dedispersed series [D, out_len] of one chunk: the sweep's
    chunk with the detection statistics left off."""
    eng = ChunkEngine(engine, stage1_bins, stage2_bins, nsub, out_len,
                      slack2, data.shape[1], data.device)
    return eng.series(data)


@dataclasses.dataclass
class SweepResult:
    """``snr[d, w]``: matched-filter SNR of the best width-``widths[w]``
    boxcar of trial ``dms[d]``, ``(max_w_sum - w*mean) / (sqrt(w)*std)``
    with the mean and std of the whole series."""

    dms: np.ndarray
    widths: Tuple[int, ...]
    snr: np.ndarray  # [D, W]
    peak_sample: np.ndarray  # [D, W] global sample of the best box start
    mean: np.ndarray
    std: np.ndarray
    #: the engine that ran and its structural numbers (ChunkEngine.info)
    engine_info: dict = dataclasses.field(default_factory=dict)
    #: with keep_chunk_peaks: each chunk's peak SNRs and global starts,
    #: [n_chunks, D, W]
    chunk_snr: Optional[np.ndarray] = None
    chunk_sample: Optional[np.ndarray] = None

    def events(self, threshold: float) -> List[dict]:
        """Every per-chunk peak at or above ``threshold`` SNR, one
        (dm, width, snr, sample) record per (chunk, trial, width) cell,
        sorted by (dm, sample). Needs the sweep run with
        ``keep_chunk_peaks``; raises otherwise."""
        if self.chunk_snr is None:
            raise ValueError(
                "per-chunk peaks were not recorded: run the sweep with "
                "keep_chunk_peaks=True (cli: --all-events)")
        out = []
        for ci in range(self.chunk_snr.shape[0]):
            for di, wi in np.argwhere(self.chunk_snr[ci] >= threshold):
                out.append(dict(dm=float(self.dms[di]),
                                width=int(self.widths[wi]),
                                snr=float(self.chunk_snr[ci, di, wi]),
                                sample=int(self.chunk_sample[ci, di, wi])))
        out.sort(key=lambda e: (e["dm"], e["sample"]))
        return out

    def best(self, k: int = 10):
        """Top-k (dm, width, snr, sample) candidates over all trials."""
        flat = self.snr.reshape(-1)
        order = np.argsort(flat)[::-1][:k]
        d, w = np.unravel_index(order, self.snr.shape)
        return [dict(dm=float(self.dms[di]), width=int(self.widths[wi]),
                     snr=float(self.snr[di, wi]),
                     sample=int(self.peak_sample[di, wi]))
                for di, wi in zip(d, w)]


class AccumParts(NamedTuple):
    """Raw accumulator state: host-f64 moment sums over ``n`` payload
    samples, f32 window-sum maxima ``mb`` at global starts ``ab``, the
    baseline sum that restores original units and, with
    ``keep_chunk_peaks``, each chunk's real-trial ``mb`` and ``ab``."""

    n: int
    s: np.ndarray
    ss: np.ndarray
    mb: np.ndarray
    ab: np.ndarray
    baseline_sum: float
    chunk_mb: tuple = ()
    chunk_ab: tuple = ()


def merge_accum_parts(parts: Sequence[AccumParts]) -> AccumParts:
    """Merge per-window accumulators in window order (earliest first):
    the float64 moment sums add in that order and a window's maxima
    replace the incumbent's only where strictly greater, the choice the
    chunk loop makes, so a time-sharded sweep merges to the sequential
    result with bit-identical maxima and starts and moment sums that
    differ only by float64 re-association. Chunk peak records
    concatenate in window order."""
    if not parts:
        raise ValueError("no accumulator parts to merge")
    n = parts[0].n
    s = np.array(parts[0].s, dtype=np.float64)
    ss = np.array(parts[0].ss, dtype=np.float64)
    mb = np.array(parts[0].mb)
    ab = np.array(parts[0].ab, dtype=np.int64)
    chunk_mb = tuple(parts[0].chunk_mb)
    chunk_ab = tuple(parts[0].chunk_ab)
    for p in parts[1:]:
        n += p.n
        s += p.s
        ss += p.ss
        better = p.mb > mb
        mb = np.where(better, p.mb, mb)
        ab = np.where(better, p.ab, ab)
        chunk_mb += tuple(p.chunk_mb)
        chunk_ab += tuple(p.chunk_ab)
    return AccumParts(n, s, ss, mb, ab, parts[0].baseline_sum,
                      chunk_mb, chunk_ab)


class _Accum:
    """Host float64 accumulation of per-chunk statistics, in stream order.
    With ``keep_chunk_peaks`` each chunk's window maxima and global starts
    of the ``n_real`` real trials are kept as well (float32 and int64,
    ``n_chunks * n_real * W * 12`` bytes)."""

    def __init__(self, D: int, W: int, keep_chunk_peaks: bool = False,
                 n_real: Optional[int] = None):
        self.n = 0
        self.s = np.zeros(D)
        self.ss = np.zeros(D)
        self.mb = np.full((D, W), -np.inf)
        self.ab = np.zeros((D, W), dtype=np.int64)
        self.keep_chunk_peaks = keep_chunk_peaks
        self.n_real = D if n_real is None else n_real
        self.chunk_mb: list = []
        self.chunk_ab: list = []

    def update(self, start, stat_len, s, ss, mb, ab):
        self.n += stat_len
        self.s += np.asarray(s, dtype=np.float64)
        self.ss += np.asarray(ss, dtype=np.float64)
        mb = np.asarray(mb)
        ab = np.asarray(ab, dtype=np.int64) + start
        if self.keep_chunk_peaks:
            self.chunk_mb.append(mb[:self.n_real].astype(np.float32))
            self.chunk_ab.append(ab[:self.n_real].copy())
        better = mb > self.mb  # the incumbent keeps a tie
        self.mb = np.where(better, mb, self.mb)
        self.ab = np.where(better, ab, self.ab)


def _repad_rows(a, pad: int) -> np.ndarray:
    """The trial axis extended by ``pad`` copies of the last real row:
    what padded trials (the last real DM repeated) accumulate."""
    a = np.asarray(a)
    if pad <= 0:
        return a
    return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)


class SweepCheckpoint:
    """In-sweep checkpoint of a long stream (the reference's).

    Every ``every`` drained chunks, the host accumulator (:class:`_Accum`,
    its real trials' rows), the cursor (the first payload sample not yet
    accumulated) and the per-channel baseline are written to ``path``
    through ``{path}.tmp.npz`` and ``os.replace``. A resume accumulates the
    remaining chunks in stream order, as the uninterrupted run does, so
    its result has the same bits. A checkpoint of other parameters (its
    fingerprint differs) or one that cannot be read starts the sweep from
    scratch. The file is removed when the sweep finishes."""

    def __init__(self, path: str, every: int = 16):
        self.path = path
        self.every = max(1, int(every))
        self._drained = 0

    @staticmethod
    def _fingerprint(plan: SweepPlan, chunk_payload: int,
                     context: str = "") -> str:
        """Hash of the plan's real trials, band, sample time, geometry and
        widths, the payload and ``context`` (the resolved engine and the
        mask tag: engines agree only within tolerance, so a checkpoint
        resumes only the configuration that wrote it)."""
        h = hashlib.sha256()
        nr = plan.n_real_trials
        for part in (plan.dms[:nr].tobytes(), plan.freqs.tobytes(),
                     np.float64(plan.dt).tobytes(),
                     np.int64([plan.nsub, plan.group_size,
                               plan.n_real_trials, chunk_payload]).tobytes(),
                     np.int64(plan.widths).tobytes(),
                     context.encode()):
            h.update(part)
        return h.hexdigest()

    def load(self, plan: SweepPlan, chunk_payload: int, context: str = "",
             keep_chunk_peaks: bool = False):
        """(acc, cursor, baseline) of a matching checkpoint, else None.
        ``keep_chunk_peaks`` must be what the checkpoint was written with:
        a resume without the per-chunk record would drop events."""
        if not os.path.exists(self.path):
            return None
        try:
            with np.load(self.path, allow_pickle=False) as z:
                if str(z["fingerprint"]) != self._fingerprint(
                        plan, chunk_payload, context):
                    return None
                if ("chunk_mb" in z) != keep_chunk_peaks:
                    return None
                acc = _Accum(plan.n_trials, len(plan.widths),
                             keep_chunk_peaks=keep_chunk_peaks,
                             n_real=plan.n_real_trials)
                acc.n = int(z["n"])
                # real rows are stored; padded trials repeat the last one
                pad = plan.n_trials - plan.n_real_trials
                acc.s = _repad_rows(z["s"], pad)
                acc.ss = _repad_rows(z["ss"], pad)
                acc.mb = _repad_rows(z["mb"], pad)
                acc.ab = _repad_rows(z["ab"], pad)
                if keep_chunk_peaks:
                    acc.chunk_mb = list(z["chunk_mb"])
                    acc.chunk_ab = list(z["chunk_ab"])
                return acc, int(z["cursor"]), z["baseline"]
        except Exception:  # noqa: BLE001 - a corrupt checkpoint restarts
            return None

    def save(self, plan: SweepPlan, chunk_payload: int, acc: _Accum,
             cursor: int, baseline, context: str = "") -> None:
        """Write the state atomically (``.tmp.npz``: ``np.savez`` must not
        append a suffix of its own)."""
        tmp = self.path + ".tmp.npz"
        extra = {}
        if acc.keep_chunk_peaks:
            # the keys exist before the first chunk, so that load() tells
            # a checkpoint with peaks from one without
            W = acc.mb.shape[1]
            extra["chunk_mb"] = (np.stack(acc.chunk_mb) if acc.chunk_mb
                                 else np.zeros((0, acc.n_real, W),
                                               np.float32))
            extra["chunk_ab"] = (np.stack(acc.chunk_ab) if acc.chunk_ab
                                 else np.zeros((0, acc.n_real, W), np.int64))
        nr = plan.n_real_trials
        np.savez(tmp,
                 fingerprint=self._fingerprint(plan, chunk_payload, context),
                 n=acc.n, s=acc.s[:nr], ss=acc.ss[:nr], mb=acc.mb[:nr],
                 ab=acc.ab[:nr], cursor=cursor,
                 baseline=np.asarray(baseline, dtype=np.float32), **extra)
        os.replace(tmp, self.path)

    def on_drained(self, plan: SweepPlan, chunk_payload: int, acc: _Accum,
                   cursor: int, baseline, context: str = "",
                   n: int = 1) -> None:
        """Count ``n`` newly drained chunks and save when the count
        crosses a multiple of ``every``. The caller passes the state after
        the whole drain: ``acc`` then holds every chunk before ``cursor``
        and no other."""
        fire = (self._drained + n) // self.every > self._drained // self.every
        self._drained += n
        if fire:
            telemetry.counter("sweep.checkpoint_saves")
            with profiling.stage("checkpoint_save"):
                self.save(plan, chunk_payload, acc, cursor, baseline,
                          context)

    def finish(self) -> None:
        """The sweep is complete: remove the checkpoint."""
        if os.path.exists(self.path):
            os.remove(self.path)


def finalize_sweep(plan: SweepPlan, n: int, s, ss, mb, ab,
                   baseline_sum: float = 0.0, chunk_mb=None,
                   chunk_ab=None) -> SweepResult:
    """Host float64 SNR over the accumulated moments and window maxima;
    ``baseline_sum`` restores the reported mean to original units.
    ``chunk_mb``/``chunk_ab`` (per-chunk real-trial [n_real, W] maxima and
    starts) give the per-chunk SNRs, with the whole series' mean and std
    (the reference's rule)."""
    s = np.asarray(s, dtype=np.float64)
    ss = np.asarray(ss, dtype=np.float64)
    mb = np.asarray(mb, dtype=np.float64)
    ab = np.asarray(ab, dtype=np.int64)
    mean = s / max(n, 1)
    var = np.maximum(ss / max(n, 1) - mean * mean, 0.0)
    std = np.sqrt(var)
    ws = np.array(plan.widths, dtype=np.float64)
    denom = np.sqrt(ws)[None, :] * np.where(std > 0, std, 1.0)[:, None]
    snr = (mb - ws[None, :] * mean[:, None]) / denom
    nr = plan.n_real_trials
    chunk_snr = chunk_sample = None
    if chunk_mb:
        chunk_snr = np.stack([
            ((np.asarray(m, dtype=np.float64)[:nr]
              - ws[None, :] * mean[:nr, None]) / denom[:nr])
            .astype(np.float32) for m in chunk_mb])
        chunk_sample = np.stack([np.asarray(a, dtype=np.int64)[:nr]
                                 for a in chunk_ab])
    return SweepResult(dms=plan.dms[:nr], widths=plan.widths, snr=snr[:nr],
                       peak_sample=ab[:nr], mean=mean[:nr] + baseline_sum,
                       std=std[:nr], chunk_snr=chunk_snr,
                       chunk_sample=chunk_sample)


def block_mean(data):
    """Float32 per-channel mean of ``data[C, L]`` rounded as the reference
    rounds it: XLA divides by a constant as a multiply by its float32
    reciprocal. (The sum of an integer-valued block below 2^24 is exact in
    any order, so on such blocks the two means agree bit for bit.)"""
    recip = float(np.float32(1.0) / np.float32(data.shape[1]))
    return data.sum(dim=1, keepdim=True) * recip


def sweep_stream(plan: SweepPlan, blocks, chunk_payload: int, baseline=None,
                 engine: str = "auto", device="cuda", finalize: bool = True,
                 checkpoint: Optional[SweepCheckpoint] = None,
                 keep_chunk_peaks: bool = False, block_factory=None,
                 checkpoint_context: str = "", mesh=None):
    """Run the sweep over a stream of (startsamp, block[chan, time])
    chunks, each ``chunk_payload`` samples plus an overlap of at least
    ``plan.min_overlap`` (only the last may be shorter). Blocks may be
    numpy arrays or tensors; they are moved to ``device``.

    ``baseline`` ([C] or [C, 1]) is subtracted from every block; when None
    it is the f32 per-channel mean of the first block. The tail past the
    end of data is zero-padded AFTER the subtraction. Up to
    :data:`MAX_PENDING` chunks run ahead on the device before their
    statistics are read back and accumulated on the host. With
    ``finalize=False`` the raw :class:`AccumParts` come back instead of
    the :class:`SweepResult`.

    ``checkpoint`` (a :class:`SweepCheckpoint`) resumes from a matching
    checkpoint and saves the state as chunks drain; ``checkpoint_context``
    joins its fingerprint (state the plan cannot see, such as the mask
    applied by the block source). On a resume the checkpoint's baseline
    is used (unless ``baseline`` is given), chunks before the cursor are
    skipped and, when ``block_factory(cursor)`` is given, the stream is
    rebuilt from the cursor instead of replayed. ``keep_chunk_peaks``
    keeps each chunk's maxima (:meth:`SweepResult.events`).

    ``mesh`` shards the trial groups over its ``'dm'`` axis
    (:class:`ShardedChunkEngine`; blocks come to its first position's
    device, which replaces ``device``); the fingerprint of a checkpoint
    carries the ``'dm'`` size, as in the reference."""
    engine = resolve_engine(engine)
    device = (mesh_home(mesh) if mesh is not None
              else resolve_device(device))
    W = max(plan.widths)
    out_len = chunk_payload + W
    L1 = out_len + plan.max_shift2
    need = L1 + plan.max_shift1
    acc = _Accum(plan.n_trials, len(plan.widths),
                 keep_chunk_peaks=keep_chunk_peaks,
                 n_real=plan.n_real_trials)
    cursor = 0  # first payload sample not yet accumulated
    ckpt_context = f"engine={engine}{mesh_tag(mesh)}{checkpoint_context}"
    if checkpoint is not None:
        state = checkpoint.load(plan, chunk_payload, ckpt_context,
                                keep_chunk_peaks=keep_chunk_peaks)
        if state is not None:
            acc, cursor, saved_baseline = state
            if baseline is None:
                baseline = saved_baseline  # a bit-identical resume needs it
            if cursor > 0 and block_factory is not None:
                blocks = block_factory(cursor)
    if mesh is not None:
        eng = halved = ShardedChunkEngine(
            mesh, engine, plan.stage1_bins, plan.stage2_bins, plan.nsub,
            out_len, plan.max_shift2, need, point="sweep.chunk_dispatch")
    else:
        eng = ChunkEngine(engine, plan.stage1_bins, plan.stage2_bins,
                          plan.nsub, out_len, plan.max_shift2, need, device)
        halved = GroupHalving(eng, "sweep.chunk_dispatch", "sweep.chunk")
    pending: list = []  # (start, stat_len, host outputs, copy-done event)
    host_baseline = None

    def drain(limit: int) -> None:
        nonlocal cursor, host_baseline
        n = 0
        with profiling.stage("device_wait+accumulate"):
            while len(pending) > limit:
                start, stat_len, host, ready = pending.pop(0)
                if ready is not None:
                    ready.synchronize()
                acc.update(start, stat_len, *(t.numpy() for t in host))
                cursor = start + stat_len
                n += 1
        # outside the stage: checkpoint_save is a stage of its own, and
        # nested stages would count its wall twice
        if checkpoint is not None and n:
            if host_baseline is None:
                host_baseline = baseline.cpu().numpy()
            # saved only here, after a whole drain: acc holds every chunk
            # before the cursor and no other
            checkpoint.on_drained(plan, chunk_payload, acc, cursor,
                                  host_baseline, ckpt_context, n=n)

    def process(start: int, data, L: int) -> None:
        if L < need:  # end of data: zero tail
            data = F.pad(data, (0, need - L))
        stat_len = min(chunk_payload, L)
        with profiling.stage("dispatch_sweep_chunk"):
            parts = halved.stats(data, plan.widths, stat_len)
            # start the read-back right behind this chunk's kernels, so
            # that reading it later does not wait for the chunks queued
            # after it
            count_d2h(*parts)
            host = [p.to("cpu", non_blocking=True) for p in parts]
            ready = None
            if device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(device))
            pending.append((start, stat_len, host, ready))
        if telemetry.is_active():
            # one record per streamed chunk: position, payload and how
            # far device work ran ahead of the host's accumulate
            telemetry.counter("sweep.chunks")
            telemetry.gauge("sweep.pending_depth", len(pending))
            telemetry.event("sweep.chunk", start=int(start),
                            stat_len=int(stat_len), pending=len(pending))
        drain(MAX_PENDING)

    if baseline is not None:
        baseline = torch.as_tensor(baseline, dtype=torch.float32,
                                   device=device).reshape(-1, 1)
    # hold one block back: a short block is legal only at end of data
    prev = None
    # explicit iteration, so the time spent producing each block (the
    # read and the ship in the source) is a stage of its own
    block_iter = iter(blocks)
    while True:
        with profiling.stage("block_source"):
            nxt = next(block_iter, None)
        if nxt is None:
            break
        start, block = nxt
        if start < cursor:  # accumulated before the checkpoint
            continue
        with profiling.stage("host_to_device"):
            was_host = not (isinstance(block, torch.Tensor)
                            and block.device.type == device.type)
            data = torch.as_tensor(block, dtype=torch.float32,
                                   device=device)
            if was_host and device.type == "cuda" and telemetry.is_active():
                telemetry.counter("h2d.bytes",
                                  data.numel() * data.element_size())
        if baseline is None:
            baseline = block_mean(data)
        data = data - baseline
        L = data.shape[1]
        if prev is not None:
            pstart, pdata, pL = prev
            if pL < need and pstart + pL < start + L:
                raise ValueError(
                    f"interior block at sample {pstart} has {pL} samples but "
                    f"data continues to sample {start + L}; the sweep needs "
                    f"{need} per block (payload {chunk_payload} + overlap >= "
                    f"plan.min_overlap = {plan.min_overlap})")
            process(pstart, pdata, pL)
        prev = (start, data, L)
    if prev is not None:
        process(*prev)
    drain(0)
    if checkpoint is not None:
        checkpoint.finish()
    if telemetry.is_active():
        telemetry.counter("sweep.trials_completed", plan.n_real_trials)
        telemetry.counter("sweep.payload_samples", int(acc.n))
        telemetry.device_snapshot(tag="sweep_stream_end")
    B = (float(baseline.double().sum().item())
         if baseline is not None else 0.0)
    if not finalize:
        return AccumParts(acc.n, acc.s, acc.ss, acc.mb, acc.ab, B,
                          tuple(acc.chunk_mb), tuple(acc.chunk_ab))
    res = finalize_sweep(plan, acc.n, acc.s, acc.ss, acc.mb, acc.ab, B,
                         chunk_mb=acc.chunk_mb, chunk_ab=acc.chunk_ab)
    res.engine_info = eng.info()
    return res


def sweep_spectra(data, freqs, dt: float, dms, nsub: int = 64,
                  group_size: int = 32, widths=DEFAULT_WIDTHS,
                  chunk_payload: Optional[int] = None, engine: str = "auto",
                  device="cuda", mesh=None,
                  pad_groups_to: Optional[int] = None) -> SweepResult:
    """Sweep an in-memory ``data[chan, time]`` (numpy or tensor, channels
    high-frequency-first) over ``dms``. The baseline is the whole-series
    per-channel mean (float64 on the host for numpy data, cast to f32), so
    the result does not depend on the chunking. ``mesh`` shards the
    trial groups over its ``'dm'`` axis (:func:`sweep_stream`), the
    groups padded to its multiple unless ``pad_groups_to`` says how
    far."""
    device = (mesh_home(mesh) if mesh is not None
              else resolve_device(device))
    freqs = np.asarray(freqs, dtype=np.float64)
    if group_size <= 0:
        group_size = choose_group_size(dms, freqs, dt, nsub)
    if pad_groups_to is None:
        pad_groups_to = mesh_pad_groups(len(dms), group_size, mesh)
    plan = make_sweep_plan(dms, freqs, dt, nsub=nsub, group_size=group_size,
                           widths=tuple(widths), pad_groups_to=pad_groups_to)
    T = int(data.shape[1])
    if chunk_payload is None:
        chunk_payload = T
    if isinstance(data, np.ndarray):
        baseline = np.mean(data, axis=1, keepdims=True,
                           dtype=np.float64).astype(np.float32)
    else:
        baseline = data.to(torch.float32).mean(dim=1, keepdim=True)

    def blocks():
        ov = plan.min_overlap
        pos = 0
        while pos < T:
            n = min(chunk_payload + ov, T - pos)
            yield pos, data[:, pos:pos + n]
            pos += chunk_payload

    return sweep_stream(plan, blocks(), chunk_payload, baseline=baseline,
                        engine=engine, device=device, mesh=mesh)


def sweep_resident(data, freqs, dt: float, dms, nsub: int = 64,
                   group_size: int = 32, widths=DEFAULT_WIDTHS,
                   chunk_payload: Optional[int] = None, engine: str = "auto",
                   device="cuda", mesh=None,
                   pad_groups_to: Optional[int] = None) -> SweepResult:
    """The whole sweep of ``data[chan, time]`` (numpy or tensor, channels
    high-frequency-first), the reference's ``sweep_resident``: the time
    axis is cut to whole chunks of ``chunk_payload`` samples (default:
    one chunk of all of it) and what is kept is swept by
    :func:`sweep_spectra` at that chunking, so its baseline is that of
    the kept samples. A tensor already on ``device`` stays there; each
    chunk's statistics come back behind its launch (:func:`sweep_stream`).

    ``mesh`` shards the trial groups over its ``'dm'`` axis and
    ``pad_groups_to`` pads the plan's groups (:func:`sweep_spectra`):
    the rows are the single-device rows' bits. ``engine="tree"`` is
    refused (as in the reference: sweep it with :func:`sweep_spectra`)."""
    if resolve_engine(engine) == "tree":
        raise ValueError(
            "sweep_resident does not take the tree engine (its host-built "
            "merge plan); use sweep_spectra(..., engine='tree')")
    T = int(data.shape[1])
    payload = T if chunk_payload is None else min(int(chunk_payload), T)
    n_chunks = max(T // payload, 1)
    with telemetry.span("sweep_resident_run", n_chunks=n_chunks,
                        payload=int(payload)):
        return sweep_spectra(data[:, :n_chunks * payload], freqs, dt, dms,
                             nsub=nsub, group_size=group_size, widths=widths,
                             chunk_payload=payload, engine=engine,
                             device=device, mesh=mesh,
                             pad_groups_to=pad_groups_to)


# ---------------------------------------------------------------------------
# the warm pool's planner


def warm_geometry(*, dms, freqs, dt, nsub: int = 64, group_size: int = 0,
                  widths=DEFAULT_WIDTHS, n_samples=None, downsamp: int = 1,
                  chunk_payload: Optional[int] = None, engine: str = "auto",
                  **_ignored) -> Optional[dict]:
    """The geometry the streamed sweep will dispatch for one observation,
    rebuilt as the reference's ``_warm_sweep`` rebuilds it: the plan (the
    grid ``dms`` over the header's channels at the raw ``dt`` times
    ``downsamp``, ``group_size`` <= 0 picking the group), the bounded
    chunk payload (the default at the plan's overlap, clipped to the
    downsampled length), ``out_len``, the chunk's ``need`` and the
    resolved engine. None when there is nothing to plan, or the plan is
    refused (the stage reports that)."""
    dms = np.asarray(dms, dtype=np.float64)
    # the plan wants high-frequency-first channels (the block sources
    # flip ascending tables)
    freqs = np.sort(np.asarray(freqs, dtype=np.float64))[::-1].copy()
    if dms.size == 0 or freqs.size == 0 or not dt or dt <= 0:
        return None
    factor = max(1, int(downsamp))
    dt = float(dt) * factor  # ``dt`` is the raw header sample time
    try:
        if group_size <= 0:
            group_size = choose_group_size(dms, freqs, dt, nsub)
        plan = make_sweep_plan(dms, freqs, dt, nsub=nsub,
                               group_size=group_size, widths=tuple(widths))
        engine = resolve_engine(engine)
    except ValueError:
        return None
    if chunk_payload is None:
        chunk_payload = default_chunk_payload(plan.min_overlap)
    if n_samples:
        n_ds = int(n_samples) // factor
        chunk_payload = min(int(chunk_payload), n_ds)
        if chunk_payload <= plan.min_overlap:
            chunk_payload = min(n_ds, 2 * plan.min_overlap + 1)
        if chunk_payload <= 0:
            return None
    out_len = int(chunk_payload) + max(plan.widths)
    return {"plan": plan, "engine": engine,
            "chunk_payload": int(chunk_payload), "out_len": out_len,
            "need": out_len + plan.max_shift2 + plan.max_shift1}


def _warm_sweep(*, device="cuda", **geometry) -> int:
    """The sweep stage's warmer: on the card, load (building where
    absent) the kernel libraries the first chunk launches, and for the
    tree engine build its cached host plan and the plan's tables on
    ``device``; returns how many it holds ready. Reads no data and
    dispatches nothing; 0 on a CPU device or a geometry with nothing to
    plan."""
    from pypulsar_tpu_torch.ops import _build

    geo = warm_geometry(**geometry)
    if geo is None:
        return 0
    device = resolve_device(device)
    if device.type != "cuda":
        return 0
    names = (("boxcar_stats",) if geo["engine"] == "fourier"
             else ("gather_sum", "boxcar_stats"))
    for name in names:
        _build.load(name)
    if geo["engine"] != "tree":
        return len(names)
    plan = geo["plan"]
    tdd.plan_from_bins(plan.stage1_bins,
                       plan.stage2_bins).device_tables(device)
    return len(names) + 1


register_warmer("sweep", _warm_sweep)
