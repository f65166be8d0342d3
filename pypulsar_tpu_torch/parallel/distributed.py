"""Several processes, on one host or several: ``torch.distributed`` over
the ``gloo`` backend, and the two scale-out axes that use it.

Port of ``pypulsar_tpu/parallel/distributed.py``. Each process joins the
group (:func:`initialize`, ``init_method="tcp://HOST:PORT"``) and then
either

- takes its round-robin share of a file list (:func:`shard_files`),
  sweeps its files on its own card and merges the per-file top-k
  summaries with one fixed-size all-gather (:func:`multi_host_sweep`,
  :func:`allgather_candidates`); or
- sweeps one contiguous whole-chunk window of ONE file's time axis
  (:func:`time_shard_local_accum`: each process reads and ships 1/P of
  the file's bytes, its window reading its seam past the window's end as
  chunks do) and merges the windows' accumulators in rank order
  (:func:`_allgather_accums`, ``sweep.merge_accum_parts``):
  :func:`time_sharded_sweep`, :func:`time_sharded_ddplan`.

Why gloo: what crosses processes is KB-sized summaries (a window's
float64 moment sums, float32 window maxima and their samples; a file's
top-k rows), never the data; gloo takes two ranks on one card, which
NCCL refuses and which is the only multi-process layout a one-card
machine has; and the compute stays on each rank's card. The summaries
are host numpy arrays, gathered as CPU tensors.

Every function takes its grid explicitly: the reference's
``PYPULSAR_TPU_COORDINATOR``, ``PYPULSAR_TPU_NUM_PROCESSES`` and
``PYPULSAR_TPU_PROCESS_ID`` are not read (the port reads no environment
variable), so without :func:`initialize` a process is a grid of one. A
failed initialization raises: nothing falls back to a single process.

Contracts: a window's peaks merge bit for bit (the earliest window
keeps a tie, as the chunk loop does); the moment sums re-associate in
float64, so the SNR agrees with the single-process sweep within float64
rounding; every process returns the same result.
"""

from __future__ import annotations

import datetime
import itertools
from typing import List, Optional, Sequence

import numpy as np
import torch

from pypulsar_tpu_torch.core.device import resolve_device

__all__ = [
    "allgather_candidates",
    "barrier",
    "initialize",
    "is_distributed",
    "local_count",
    "local_rank",
    "multi_host_sweep",
    "process_count",
    "process_index",
    "shard_files",
    "shutdown",
    "time_shard_local_accum",
    "time_shard_window",
    "time_sharded_ddplan",
    "time_sharded_sweep",
]

#: seconds a rank waits for the others at init and in a collective
TIMEOUT_S = 600.0


def _dist():
    import torch.distributed as dist

    return dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: float = TIMEOUT_S) -> bool:
    """Join the process group at ``coordinator_address`` (``HOST:PORT``;
    rank 0 listens there) as rank ``process_id`` of ``num_processes``
    over gloo; returns True when distributed. Without a coordinator, or
    with one process, this is a no-op returning False. A coordinator
    without its grid, or a failed rendezvous, raises. Safe to call
    again once joined."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return True
    if not coordinator_address:
        if num_processes is not None and int(num_processes) > 1:
            raise ValueError("--num-processes > 1 needs --coordinator "
                             "HOST:PORT")
        return False
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and "
                         "process_id (the port reads no environment "
                         "variable)")
    num_processes, process_id = int(num_processes), int(process_id)
    if num_processes <= 1:
        return False
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside the "
                         f"{num_processes}-process grid")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    return True


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def is_distributed() -> bool:
    return process_count() > 1


def process_index() -> int:
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def process_count() -> int:
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


def local_rank() -> int:
    """This process's rank in the group (0 outside one). The reference
    reads its launcher's environment first; the port has the group
    only."""
    return process_index()


def local_count() -> int:
    """The group's size (1 outside one)."""
    return process_count()


def barrier(name: str = "pypulsar_barrier") -> None:
    """Every process waits for the others here (a no-op alone)."""
    if process_count() > 1:
        _dist().barrier()


def shard_files(files: Sequence[str], index: Optional[int] = None,
                count: Optional[int] = None) -> List[str]:
    """This process's round-robin share of the file list. With more
    processes than files the high ranks get an empty share; a rank
    outside ``[0, count)`` raises (it would alias another's share)."""
    index = process_index() if index is None else int(index)
    count = process_count() if count is None else int(count)
    if count < 1:
        raise ValueError(f"shard_files count must be >= 1, got {count}")
    if not 0 <= index < count:
        raise ValueError(
            f"shard_files rank {index} outside the {count}-process grid "
            f"[0, {count}): a wrapped rank would alias another host's "
            f"file share")
    return list(files[index::count])


def _allgather(arr: np.ndarray) -> np.ndarray:
    """``arr`` of every process stacked in rank order (the same shape on
    every rank); ``arr[None]`` alone."""
    if process_count() == 1:
        return np.asarray(arr)[None]
    t = torch.from_numpy(np.ascontiguousarray(arr))
    out = [torch.empty_like(t) for _ in range(process_count())]
    _dist().all_gather(out, t)
    return np.stack([o.numpy() for o in out])


def allgather_candidates(records: np.ndarray, pad_to: int) -> np.ndarray:
    """The valid rows of every process's ``records[n, F]`` (float64,
    ``n <= pad_to``; NaN-padded to ``pad_to`` so the collective has one
    shape), concatenated in rank order, on every process."""
    records = np.asarray(records, dtype=np.float64)
    if records.ndim != 2:
        raise ValueError("records must be [n, fields]")
    n, nf = records.shape
    n = min(n, pad_to)
    padded = np.full((pad_to, nf), np.nan)
    padded[:n] = records[:n]
    flat = _allgather(padded).reshape(-1, nf)
    return flat[~np.isnan(flat[:, 0])]


def time_shard_window(T: int, payload: int, rank: int,
                      count: int) -> tuple:
    """(s0, s1): rank's contiguous whole-chunk window of a ``T``-sample
    (downsampled) series chunked by ``payload``, chunks balanced across
    ``count`` ranks; empty past the last chunk."""
    nchunks = -(-T // payload)
    per = -(-nchunks // count)
    return (min(rank * per * payload, T),
            min((rank + 1) * per * payload, T))


def time_sharded_sweep(reader, dms, nsub: int = 64, group_size: int = 32,
                       chunk_payload: Optional[int] = None, mesh=None,
                       widths=None, engine: str = "auto", rfimask=None,
                       rank: Optional[int] = None,
                       count: Optional[int] = None,
                       checkpoint_base: Optional[str] = None,
                       checkpoint_every: int = 16, downsamp: int = 1,
                       keep_chunk_peaks: bool = False, device="cuda"):
    """Sweep ONE file with its time axis sharded over the processes:
    rank ``k`` of ``P`` streams only its window (1/P of the bytes) and
    the windows' accumulators merge in rank order. Every process returns
    the same finalized ``SweepResult``. ``rank``/``count`` default to
    the process group."""
    from pypulsar_tpu_torch.parallel.sweep import (
        finalize_sweep,
        merge_accum_parts,
    )

    rank = process_index() if rank is None else int(rank)
    count = process_count() if count is None else int(count)
    plan, local = time_shard_local_accum(
        reader, dms, rank, count, nsub=nsub, group_size=group_size,
        chunk_payload=chunk_payload, mesh=mesh, widths=widths,
        engine=engine, rfimask=rfimask, checkpoint_base=checkpoint_base,
        checkpoint_every=checkpoint_every, downsamp=downsamp,
        keep_chunk_peaks=keep_chunk_peaks, device=device)
    merged = merge_accum_parts(_allgather_accums(
        local, count, with_peaks=keep_chunk_peaks, nr=plan.n_real_trials))
    return finalize_sweep(plan, merged.n, merged.s, merged.ss, merged.mb,
                          merged.ab, merged.baseline_sum,
                          chunk_mb=list(merged.chunk_mb) or None,
                          chunk_ab=list(merged.chunk_ab) or None)


def time_shard_local_accum(reader, dms, rank: int, count: int,
                           nsub: int = 64, group_size: int = 32,
                           chunk_payload: Optional[int] = None, mesh=None,
                           widths=None, engine: str = "auto", rfimask=None,
                           checkpoint_base: Optional[str] = None,
                           checkpoint_every: int = 16, downsamp: int = 1,
                           keep_chunk_peaks: bool = False, device="cuda"):
    """(plan, ``AccumParts``) of rank's window of the file: the mergeable
    half of :func:`time_sharded_sweep`. The per-channel baseline is the
    file's first (downsampled, masked) block's float32 mean, as the
    single-process sweep takes it, so a one-rank run has the
    single-process sweep's bits: in a group of ``count`` processes rank
    0 broadcasts it, otherwise every rank reads that block. Each block of
    the window is read and shipped once. ``downsamp`` sweeps the downsampled
    series (windows align to whole raw bins); ``keep_chunk_peaks`` keeps
    each chunk's peaks; ``checkpoint_base`` checkpoints the window to
    ``{base}.r{rank}``. ``reader`` is a reader or a path."""
    from pypulsar_tpu_torch.parallel import staged
    from pypulsar_tpu_torch.parallel.sweep import (
        DEFAULT_WIDTHS,
        AccumParts,
        SweepCheckpoint,
        block_mean,
        mesh_home,
        sweep_stream,
    )

    widths = DEFAULT_WIDTHS if widths is None else tuple(widths)
    if isinstance(reader, str):
        from pypulsar_tpu_torch.cli import open_reader

        with open_reader(reader) as r:
            return time_shard_local_accum(
                r, dms, rank, count, nsub, group_size, chunk_payload, mesh,
                widths, engine, rfimask, checkpoint_base, checkpoint_every,
                downsamp, keep_chunk_peaks, device)
    device = mesh_home(mesh) if mesh is not None else resolve_device(device)
    factor = max(1, int(downsamp))
    probe = staged.ReaderSource(reader)
    dms = np.asarray(dms, dtype=np.float64)
    plan, payload, T = staged.step_geometry(probe, dms, factor, nsub,
                                            group_size, widths,
                                            chunk_payload, mesh)

    def source(s0: int, s1: int):
        src = staged.guard_source(staged.ReaderSource(
            reader, s0 * factor, s1 * factor if s1 < T else None))
        return (src if rfimask is None
                else staged.MaskedSource(src, rfimask, device))

    s0, s1 = time_shard_window(T, payload, rank, count)
    # in a group of ``count`` processes rank 0 computes the baseline and
    # broadcasts it (4 bytes a channel), so no other rank reads the
    # file's first block; alone, or merging by hand, every rank reads it
    shared = count > 1 and process_count() == count
    first = None
    if rank == 0 or not shared:
        blocks0 = staged.downsampled_blocks(
            source(0, min(payload, T)), factor, payload, plan.min_overlap,
            device)
        first = next(iter(blocks0))
        blocks0.close()
        baseline = block_mean(first[1])
    if shared:
        buf = (baseline.cpu() if rank == 0 else
               torch.empty((len(probe.frequencies), 1), dtype=torch.float32))
        _dist().broadcast(buf, src=0)
        baseline = buf.to(device)
    if s0 >= s1:  # more ranks than chunks: the identity contribution
        D, W = plan.n_trials, len(plan.widths)
        return plan, AccumParts(
            0, np.zeros(D), np.zeros(D),
            np.full((D, W), -np.inf, np.float32), np.zeros((D, W), np.int64),
            float(baseline.double().sum().item()))
    src = source(s0, s1)
    ckpt = (SweepCheckpoint(f"{checkpoint_base}.r{rank}",
                            every=checkpoint_every)
            if checkpoint_base else None)
    ds_tag = f"/ds={factor}" if factor > 1 else ""
    ctx = f"/window={s0}:{s1}{ds_tag}" + staged.mask_tag(rfimask)

    def block_factory(cursor_ds: int):
        seeked = staged.reroot_source(src, cursor_ds * factor)
        return staged.downsampled_blocks(src if seeked is None else seeked,
                                         factor, payload, plan.min_overlap,
                                         device)

    if s0 == 0 and first is not None and s1 > payload:
        # the window's first block is the one the baseline came from:
        # shipped once, then the rest of the window
        blocks = itertools.chain([first], staged.downsampled_blocks(
            source(payload, s1), factor, payload, plan.min_overlap, device))
    else:
        blocks = staged.downsampled_blocks(src, factor, payload,
                                           plan.min_overlap, device)
    del first
    with _span("time_shard_window", rank=rank, count=count, s0=int(s0),
               s1=int(s1)):
        local = sweep_stream(
            plan, blocks, payload, baseline=baseline, engine=engine, device=device,
            finalize=False, checkpoint=ckpt, keep_chunk_peaks=keep_chunk_peaks,
            block_factory=block_factory, checkpoint_context=ctx, mesh=mesh)
    return plan, local


def _span(name: str, **attrs):
    from pypulsar_tpu_torch.obs import telemetry

    return telemetry.span(name, aggregate=False, **attrs)


def time_sharded_ddplan(reader, ddplan, nsub: int = 64,
                        group_size: int = 32,
                        chunk_payload: Optional[int] = None, mesh=None,
                        widths=None, engine: str = "auto", rfimask=None,
                        rank: Optional[int] = None,
                        count: Optional[int] = None,
                        checkpoint_base: Optional[str] = None,
                        checkpoint_every: int = 16, device="cuda"):
    """A DDplan's steps over ONE file, each a :func:`time_sharded_sweep`
    at its own downsampling; checkpoints go to
    ``{base}.step{i}.r{rank}``. Every process returns the same
    ``StagedSweepResult``."""
    from pypulsar_tpu_torch.parallel.staged import (
        StagedSweepResult,
        StepResult,
    )
    from pypulsar_tpu_torch.parallel.sweep import (
        finalize_sweep,
        merge_accum_parts,
    )

    rank = process_index() if rank is None else int(rank)
    count = process_count() if count is None else int(count)
    steps = []
    for i, st in enumerate(ddplan.DDsteps):
        base = f"{checkpoint_base}.step{i}" if checkpoint_base else None
        plan, local = time_shard_local_accum(
            reader, np.asarray(st.DMs, dtype=np.float64), rank, count,
            nsub=nsub, group_size=group_size, chunk_payload=chunk_payload,
            mesh=mesh, widths=widths, engine=engine, rfimask=rfimask,
            checkpoint_base=base, checkpoint_every=checkpoint_every,
            downsamp=int(st.downsamp), device=device)
        merged = merge_accum_parts(_allgather_accums(local, count))
        res = finalize_sweep(plan, merged.n, merged.s, merged.ss,
                             merged.mb, merged.ab, merged.baseline_sum)
        steps.append(StepResult(downsamp=int(st.downsamp),
                                dt=float(plan.dt), result=res))
    return StagedSweepResult(steps=steps)


def _allgather_accums(local, count: int, with_peaks: bool = False,
                      nr: int = 0) -> list:
    """Every rank's ``AccumParts``, in rank order: one float64 all-gather
    of the packed fields (``ab``'s int64 samples are exact in float64
    below 2^53) and, ``with_peaks``, the per-chunk peak records in their
    own dtypes (counts first, arrays padded to the largest). A ``count``
    other than the group's raises (windows would be lost)."""
    from pypulsar_tpu_torch.parallel.sweep import AccumParts

    if count == 1:
        return [local]
    if process_count() != count:
        raise ValueError(
            f"time-shard count {count} != process count {process_count()};"
            f" merge time_shard_local_accum parts with "
            f"sweep.merge_accum_parts instead")
    D, W = local.mb.shape
    packed = np.concatenate([
        [float(local.n), float(local.baseline_sum)],
        np.asarray(local.s, np.float64), np.asarray(local.ss, np.float64),
        np.asarray(local.mb, np.float64).ravel(),
        np.asarray(local.ab, np.float64).ravel()])
    parts = []
    for row in _allgather(packed):
        o = 2
        s = row[o:o + D]
        o += D
        ss = row[o:o + D]
        o += D
        mb = row[o:o + D * W].reshape(D, W).astype(np.float32)
        o += D * W
        ab = row[o:o + D * W].reshape(D, W).astype(np.int64)
        parts.append(AccumParts(int(row[0]), s, ss, mb, ab, float(row[1])))
    if with_peaks:
        nloc = len(local.chunk_mb)
        counts = _allgather(np.asarray([nloc], np.int64)).reshape(-1)
        m = int(counts.max())
        if m:
            mb_buf = np.zeros((m, nr, W), np.float32)
            ab_buf = np.zeros((m, nr, W), np.int64)
            if nloc:
                mb_buf[:nloc] = np.stack(local.chunk_mb)
                ab_buf[:nloc] = np.stack(local.chunk_ab)
            g_mb, g_ab = _allgather(mb_buf), _allgather(ab_buf)
            for r in range(count):
                c = int(counts[r])
                parts[r] = parts[r]._replace(
                    chunk_mb=tuple(g_mb[r, i] for i in range(c)),
                    chunk_ab=tuple(g_ab[r, i] for i in range(c)))
    return parts


def multi_host_sweep(files: Sequence[str], dms=None, nsub: int = 64,
                     group_size: int = 32,
                     chunk_payload: Optional[int] = None, mesh=None,
                     topk_per_file: int = 16, open_reader=None, *,
                     ddplan=None, downsamp: int = 1, widths=None,
                     engine: str = "auto", rfimask=None,
                     checkpoint_base: Optional[str] = None,
                     checkpoint_every: int = 16, per_file=None,
                     device="cuda") -> np.ndarray:
    """Sweep a file list over the processes (each its
    :func:`shard_files` share, on its own card or ``mesh``) and return
    the merged candidate table, rows ``(file_index, dm, snr,
    width_bins, sample, downsamp)`` by decreasing SNR, the same on every
    process. Either a flat ``dms`` grid or a ``ddplan`` drives each
    file's sweep; ``per_file(file_index, path, staged_result)`` runs on
    the process that swept the file (the CLI writes its artifacts
    there); ``checkpoint_base`` checkpoints file ``i`` at
    ``{base}.f{i}``."""
    from pypulsar_tpu_torch.parallel.staged import sweep_ddplan, sweep_flat
    from pypulsar_tpu_torch.parallel.sweep import DEFAULT_WIDTHS

    if (dms is None) == (ddplan is None):
        raise ValueError("exactly one of dms / ddplan must be given")
    widths = DEFAULT_WIDTHS if widths is None else tuple(widths)
    if open_reader is None:
        from pypulsar_tpu_torch.cli import open_reader
    files = list(files)
    rows = []
    for fi in range(process_index(), len(files), process_count()):
        ckpt = f"{checkpoint_base}.f{fi}" if checkpoint_base else None
        with open_reader(files[fi]) as reader:
            if ddplan is not None:
                staged = sweep_ddplan(
                    reader, ddplan, nsub=nsub, group_size=group_size,
                    widths=widths, chunk_payload=chunk_payload, mesh=mesh,
                    engine=engine, rfimask=rfimask, checkpoint_path=ckpt,
                    checkpoint_every=checkpoint_every, device=device)
            else:
                staged = sweep_flat(
                    reader, dms, downsamp=downsamp, nsub=nsub,
                    group_size=group_size, widths=widths,
                    chunk_payload=chunk_payload, mesh=mesh, engine=engine,
                    rfimask=rfimask, checkpoint_path=ckpt,
                    checkpoint_every=checkpoint_every, device=device)
        if per_file is not None:
            per_file(fi, files[fi], staged)
        for c in staged.best(topk_per_file):
            rows.append([fi, c["dm"], c["snr"], c["width_bins"],
                         c["sample"], c["downsamp"]])
    local = np.asarray(rows, dtype=np.float64).reshape(-1, 6)
    # one collective shape on every process: the largest share's rows
    max_share = -(-len(files) // max(process_count(), 1))
    merged = allgather_candidates(local,
                                  pad_to=topk_per_file * max(max_share, 1))
    order = np.argsort(merged[:, 2], kind="stable")[::-1]
    return merged[order]
