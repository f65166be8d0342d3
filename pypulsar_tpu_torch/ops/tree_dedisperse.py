"""Tree dedispersion: every DM trial of a chunk through log2(nchan)
shared pairwise merge levels and an exact-shift snap.

Port of ``pypulsar_tpu/ops/tree_dedisperse.py`` on one device. A partial
sum over a 2w-channel block is one add of two w-channel partial sums, and
trials whose per-channel shifts agree on a block share that block's row:

    row(LR, v)[t] = row(L, vL)[t + offA] + row(R, vR)[t + offB]

The tables are derived from the exact integer shifts the two-stage
engines apply (``stage1_bins + stage2_bins``), so no shift is
approximated; the final snap reads trial d's top-level row at offset
``min_c shift[d, c]``, and every channel of trial d's series is shifted by
exactly the ``s1 + s2`` the ``gather`` engine applies. Only the float32
summation tree differs (balanced pairwise against subband sums).

Host part (copied, not imported): :class:`TreePlan`, :func:`_build_plan`,
:func:`_digest` and :func:`plan_from_bins` with its LRU cache of
:data:`PLAN_CACHE_SIZE` plans.

Device part: each merge level is one launch of the hand-written
gather-sum kernel (``ops/gather_sum.py``) in its generic J = 1 form, K = 2
(``out[i, t] = st[a_i, t + oa_i] + st[b_i, t + ob_i]``), counted under
``shifted_gather_sum.launches["tree_level"]``; the snap is K = 1 (trial d
reads row ``trial_row[d]`` at ``trial_off[d]``), counted under
``"tree_snap"``. The kernel sums from zero in k order, and ``0 + a + b``
is exactly the reference's ``a + b``, so the series have the JAX
package's bits. Where ``torch.gather`` would need a ``[R, L]`` int64
index (~30 GB at 1024 trials) and row slices ~143k launches a chunk, a
level is one launch.

The state is two ping-pong ``[R + 1, L + pad]`` float32 buffers
(:class:`TreeState`), allocated once per stream: row ``R`` is the constant
zero row every passthrough and padding entry reads, and the ``pad`` zero
columns on the right are the reference's per-level zero fill
(``_shift_rows``), given once. A level writes the first ``L`` columns of
its rows only, so both stay zero. At 1024 channels x 1024 trials (14,343
rows, a 2^18-sample chunk) the two buffers take ~31 GB.

Telemetry: every dispatch records the reference's structural counters
(:func:`note_dispatch`: the ``tree.merge_levels`` gauge,
``tree.adds_total`` and ``tree.bytes_on_device``).

The ``'dm'``-mesh factories (:func:`make_sharded_tree_sweep_chunk`,
:func:`make_sharded_tree_series_chunk`) are ``parallel.sweep``'s
sharded factories with this engine: each mesh position's
``ChunkEngine`` builds its own plan of its contiguous block of trial
groups and its own state on its device (the reference's
``_stack_shard_plans`` without the stacking, which only a single
compiled program needs). A row is the sum of the same channel rows in
the same tree order whichever trials share the plan, so the shards'
rows are the unsharded engine's bits.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import List, Tuple

import numpy as np
import torch

from pypulsar_tpu_torch.obs import telemetry

from pypulsar_tpu_torch.ops.boxcar_stats import boxcar_stats
from pypulsar_tpu_torch.ops.gather_sum import (
    GatherTables,
    gather_tables,
    shifted_gather_sum,
)

__all__ = [
    "PLAN_CACHE_SIZE",
    "TreePlan",
    "TreeState",
    "dedisperse_series_tree",
    "make_sharded_tree_series_chunk",
    "make_sharded_tree_sweep_chunk",
    "plan_from_bins",
    "sweep_chunk_tree",
]

#: plans kept by :func:`plan_from_bins` (the reference's knob default)
PLAN_CACHE_SIZE = 8


class TreePlan:
    """Host-built merge-tree tables for one (stage1_bins, stage2_bins)
    shift set (field for field the reference's).

    tabs[4, NL, R] int32   per-level (srcA, srcB, offA, offB); rows past a
                           level's real count (and passthrough srcB) point
                           at the constant zero row ``R``
    trial_row[D] int32     top-level row of each trial (group-major order)
    trial_off[D] int32     the snap offset: min_c of the trial's exact
                           per-channel shift
    pad                    the largest exact total shift
    adds_per_sample        real (two-child) merges over all levels
    """

    def __init__(self, tabs, trial_row, trial_off, pad, group_size,
                 rows, n_levels, adds_per_sample, rows_per_level,
                 n_channels):
        self.tabs = tabs
        self.trial_row = trial_row
        self.trial_off = trial_off
        self.pad = int(pad)
        self.group_size = int(group_size)
        self.rows = int(rows)
        self.n_levels = int(n_levels)
        self.adds_per_sample = int(adds_per_sample)
        self.rows_per_level = tuple(int(r) for r in rows_per_level)
        self.n_channels = int(n_channels)
        self.n_trials = int(len(trial_row))
        self._dev = {}  # device -> (level tables, snap tables)

    def device_tables(self, device) -> Tuple[List[GatherTables],
                                             GatherTables]:
        """(one gather-sum table set per level, the snap's) on ``device``,
        built once per device so a streamed sweep's chunks reuse them.
        A level's tables hold its real rows only: the rows past them are
        never read by the next level."""
        device = torch.device(device)
        if device not in self._dev:
            levels = []
            for li, n in enumerate(self.rows_per_level):
                t = self.tabs[:, li, :n]
                levels.append(gather_tables(
                    t[0:2].T, t[2:4].T[:, None, :],
                    np.arange(n, dtype=np.int32)[:, None], device,
                    "tree_level"))
            D = self.n_trials
            snap = gather_tables(self.trial_row[:, None],
                                 self.trial_off[:, None, None],
                                 np.arange(D, dtype=np.int32)[:, None],
                                 device, "tree_snap")
            self._dev[device] = (levels, snap)
        return self._dev[device]


def _build_plan(s1: np.ndarray, s2: np.ndarray) -> TreePlan:
    """Build the merge tables from the exact two-stage shift tables
    ``s1[G, C]`` / ``s2[G, g, S]``: trial d's shift of channel c is
    ``s1[g(d), c] + s2[g(d), t(d), c // per]``."""
    s1 = np.asarray(s1, dtype=np.int64)
    s2 = np.asarray(s2, dtype=np.int64)
    G, C = s1.shape
    _, g, S = s2.shape
    per = C // S
    D = G * g
    tot = (s1[:, None, :] + np.repeat(s2, per, axis=2)).reshape(D, C)

    # level 0: one row per channel, a trial's variant of channel c is the
    # row itself and its base the exact shift
    assign = np.broadcast_to(np.arange(C, dtype=np.int64), (D, C)).copy()
    base = tot.copy()
    ZERO = -1  # the constant zero row; patched to R below
    levels = []
    rows_per_level = []
    adds = 0
    rows_max = C
    nb = C
    while nb > 1:
        nb_new = (nb + 1) // 2
        new_assign = np.empty((D, nb_new), dtype=np.int64)
        new_base = np.empty((D, nb_new), dtype=np.int64)
        srcA: list = []
        srcB: list = []
        offA: list = []
        offB: list = []
        for p in range(nb_new):
            lc, rc = 2 * p, 2 * p + 1
            k0 = len(srcA)
            if rc >= nb:
                # odd block count: the last block passes through (an add
                # of the zero row, no real add)
                uniq, inv = np.unique(assign[:, lc], return_inverse=True)
                srcA.extend(int(u) for u in uniq)
                srcB.extend(ZERO for _ in uniq)
                offA.extend(0 for _ in uniq)
                offB.extend(0 for _ in uniq)
                new_assign[:, p] = k0 + inv
                new_base[:, p] = base[:, lc]
                continue
            bl, br = base[:, lc], base[:, rc]
            nbase = np.minimum(bl, br)
            # trials with the same (left variant, right variant, offsets)
            # share the parent row: the work sharing
            key = np.stack([assign[:, lc], assign[:, rc],
                            bl - nbase, br - nbase], axis=1)
            uniq, inv = np.unique(key, axis=0, return_inverse=True)
            srcA.extend(int(u) for u in uniq[:, 0])
            srcB.extend(int(u) for u in uniq[:, 1])
            offA.extend(int(u) for u in uniq[:, 2])
            offB.extend(int(u) for u in uniq[:, 3])
            adds += len(uniq)
            new_assign[:, p] = k0 + inv.reshape(-1)
            new_base[:, p] = nbase
        levels.append((np.asarray(srcA, dtype=np.int64),
                       np.asarray(srcB, dtype=np.int64),
                       np.asarray(offA, dtype=np.int64),
                       np.asarray(offB, dtype=np.int64)))
        rows_per_level.append(len(srcA))
        rows_max = max(rows_max, len(srcA))
        assign, base, nb = new_assign, new_base, nb_new

    NL = len(levels)
    R = rows_max
    tabs = np.empty((4, max(NL, 1), R), dtype=np.int32)
    tabs[0], tabs[1] = R, R
    tabs[2], tabs[3] = 0, 0
    for li, (a, b, oa, ob) in enumerate(levels):
        n = len(a)
        tabs[0, li, :n] = np.where(a < 0, R, a)
        tabs[1, li, :n] = np.where(b < 0, R, b)
        tabs[2, li, :n] = oa
        tabs[3, li, :n] = ob
    if NL == 0:  # one channel: no merges, trials snap straight to it
        tabs = tabs[:, :0]
    return TreePlan(
        tabs=tabs,
        trial_row=assign[:, 0].astype(np.int32),
        trial_off=base[:, 0].astype(np.int32),
        pad=max(int(tot.max(initial=0)), 0),
        group_size=g,
        rows=R,
        n_levels=NL,
        adds_per_sample=adds,
        rows_per_level=rows_per_level,
        n_channels=C,
    )


_PLAN_CACHE: "OrderedDict[bytes, TreePlan]" = OrderedDict()
# shared by every sweep in the process; a batch lane sweeps from several
# threads
_PLAN_CACHE_LOCK = threading.Lock()


def _digest(s1: np.ndarray, s2: np.ndarray) -> bytes:
    h = hashlib.sha256()
    for a in (s1, s2):
        h.update(np.int64(a.shape).tobytes())
        h.update(np.ascontiguousarray(a, dtype=np.int32).tobytes())
    return h.digest()


def plan_from_bins(stage1_bins, stage2_bins) -> TreePlan:
    """Cached :class:`TreePlan` of these exact shift tables (host arrays
    or tensors)."""
    s1 = np.asarray(stage1_bins)
    s2 = np.asarray(stage2_bins)
    key = _digest(s1, s2)
    with _PLAN_CACHE_LOCK:
        plan = _PLAN_CACHE.pop(key, None)
    if plan is None:
        plan = _build_plan(s1, s2)  # outside the lock: seconds at scale
    with _PLAN_CACHE_LOCK:
        _PLAN_CACHE[key] = plan  # (re)insert as the most recent
        while len(_PLAN_CACHE) > PLAN_CACHE_SIZE:
            _PLAN_CACHE.popitem(last=False)
    return plan


class TreeState:
    """The two ping-pong ``[R + 1, L + pad]`` float32 state buffers of
    one chunk length ``L`` on one device, zeroed once; a stream of chunks
    of that length reuses them."""

    def __init__(self, plan: TreePlan, L: int, device):
        self.plan = plan
        self.L = int(L)
        shape = (plan.rows + 1, self.L + plan.pad)
        n = 2 if plan.n_levels else 1
        self.bufs = [torch.zeros(shape, dtype=torch.float32, device=device)
                     for _ in range(n)]

    @property
    def nbytes(self) -> int:
        return sum(b.numel() * 4 for b in self.bufs)

    def series(self, data: torch.Tensor, out_len: int) -> torch.Tensor:
        """The ``[D, out_len]`` dedispersed series of every (padded)
        trial of ``data[C, L]``: the merge levels, then the snap. Needs
        ``L >= out_len + pad``, so that no read passes the chunk's end
        (where the reference's snap would clamp its window)."""
        plan = self.plan
        C, L = data.shape
        if C != plan.n_channels or L != self.L:
            raise ValueError(f"chunk [{C}, {L}] does not fit the tree "
                             f"state [{plan.n_channels}, {self.L}]")
        if L < out_len + plan.pad:
            raise ValueError(
                f"the tree engine needs a chunk of at least out_len + pad = "
                f"{out_len} + {plan.pad} samples; got {L}")
        levels, snap = plan.device_tables(data.device)
        src = self.bufs[0]
        src[:C, :L].copy_(data)
        for li, tables in enumerate(levels):
            dst = self.bufs[(li + 1) % 2]
            shifted_gather_sum(src, tables, L,
                               out=dst[:plan.rows_per_level[li], :L])
            src = dst
        return shifted_gather_sum(src, snap, out_len)


def note_dispatch(plan: TreePlan, chunk_len: int, n_samples: int) -> None:
    """Host-side structural counters of one dispatch (the reference's):
    merge depth, the shared-work adds performed for ``n_samples`` output
    samples, and the bytes of a ``[R + 1, chunk_len]`` merge state."""
    if not telemetry.is_active():
        return
    telemetry.gauge("tree.merge_levels", plan.n_levels)
    telemetry.counter("tree.adds_total",
                      plan.adds_per_sample * int(n_samples))
    telemetry.counter("tree.bytes_on_device",
                      4 * (plan.rows + 1) * int(chunk_len))


def _check_data(data) -> None:
    if not isinstance(data, torch.Tensor) or data.dim() != 2 \
            or data.dtype != torch.float32:
        raise ValueError("data must be a 2-D float32 tensor")


def dedisperse_series_tree(data, stage1_bins, stage2_bins,
                           out_len: int) -> torch.Tensor:
    """Tree-engine twin of ``parallel.sweep.dedisperse_series_chunk``:
    the ``[D, out_len]`` series of one chunk ``data[C, L]`` (on its own
    device; a CPU tensor runs the kernel's plain version)."""
    _check_data(data)
    plan = plan_from_bins(stage1_bins, stage2_bins)
    return TreeState(plan, data.shape[1], data.device).series(data, out_len)


def sweep_chunk_tree(data, stage1_bins, stage2_bins, out_len: int,
                     widths: Tuple[int, ...], stat_len: int):
    """Tree-engine twin of ``parallel.sweep.sweep_chunk``: per-trial
    (sum, sumsq, maxbox, argbox) of one chunk. The boxcar statistics of a
    row do not depend on the others, so one launch covers every trial
    (the reference scans the trial groups)."""
    return boxcar_stats(dedisperse_series_tree(data, stage1_bins,
                                               stage2_bins, out_len),
                        widths, stat_len)



def make_sharded_tree_sweep_chunk(mesh, out_len: int,
                                  widths: Tuple[int, ...], stat_len: int):
    """``parallel.sweep.make_sharded_sweep_chunk`` with the tree engine:
    ``fn(data, stage1_bins, stage2_bins)`` -> per-trial (sum, sumsq,
    maxbox, argbox) in group order on the first position's device."""
    from pypulsar_tpu_torch.parallel.sweep import make_sharded_sweep_chunk

    return make_sharded_sweep_chunk(mesh, 0, out_len, 0, widths, stat_len,
                                    engine="tree")


def make_sharded_tree_series_chunk(mesh, out_len: int):
    """``parallel.sweep.make_sharded_series_chunk`` with the tree engine:
    ``fn(data, stage1_bins, stage2_bins)`` -> the ``[D, out_len]``
    series in group order on the first position's device."""
    from pypulsar_tpu_torch.parallel.sweep import make_sharded_series_chunk

    return make_sharded_series_chunk(mesh, 0, out_len, 0, engine="tree")
