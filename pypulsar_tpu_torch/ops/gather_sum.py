"""Shared-source shifted gather-sum: the dedispersion operation of both
subband stages.

    out[out_rows[b, j], t] = sum_k data[src_rows[b, k], shifts[b, j, k] + t]

for ``t < out_len``: the J output rows of source set ``b`` read the same K
source rows at their own shifts. The generic ``[O, K]`` form of
``pypulsar_tpu/ops/pallas_dedisperse.py`` ``shifted_gather_sum`` is the
case J = 1 (:func:`expand_tables` goes the other way).

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
hand-written kernel ``csrc/gather_sum.cu``. Both sum the K windows in k
order from zero, so on the same inputs they give the same bits.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from pypulsar_tpu_torch.ops import _build

_INDEX_BUDGET = 1 << 26  # int64 index elements the plain version builds at once
#: output rows per block -> (samples per thread, threads per block): the
#: instantiations of csrc/gather_sum.cu. 16 rows serve stage 1, 8 rows
#: stage 2 (64 register sums a thread); one row serves the generic J = 1
#: form and spreads too wide for 8 rows, as a single row's window has none.
_CONFIGS = {16: (4, 128), 8: (8, 256), 1: (8, 256)}
_JBS = tuple(sorted(_CONFIGS))  # the order of Bounds.spreads
_STAGES = 4  # window buffers per block (csrc/gather_sum.cu STAGES)
_TILES_PER_BLOCK = 4  # time tiles per block (csrc/gather_sum.cu)
_MAX_SMEM = 232448  # bytes of shared memory a Hopper block may use
_MAX_GRID_YZ = 65535  # CUDA grid.y/z limit: source sets, time-tile runs


class Bounds(NamedTuple):
    """What the host knows of a table set: the row and shift ranges, and
    ``spreads[i]``, the largest ``max - min`` of one source row's shifts
    over a chunk of ``_JBS[i]`` consecutive output rows of a set."""

    min_row: int
    max_row: int
    min_shift: int
    max_shift: int
    spreads: Tuple[int, ...]


class GatherTables(NamedTuple):
    """Index tables of one gather-sum on one device, with their host
    bounds; ``stage`` names the launch counter the kernel adds to."""

    src_rows: torch.Tensor  # [B, K] int32
    shifts: torch.Tensor  # [B, J, K] int32
    out_rows: torch.Tensor  # [B, J] int32, a permutation of range(B * J)
    bounds: Bounds
    stage: str


def table_bounds(src_rows: np.ndarray, shifts: np.ndarray) -> Bounds:
    """:class:`Bounds` of host tables ``src_rows[B, K]``, ``shifts[B, J, K]``."""
    src_rows = np.asarray(src_rows)
    shifts = np.asarray(shifts)
    B, J, K = shifts.shape
    if shifts.size == 0:
        return Bounds(0, 0, 0, 0, (0,) * len(_JBS))
    spreads = []
    for jb in _JBS:
        pad = -J % jb  # repeat the last row: it widens no chunk
        s = np.concatenate([shifts, np.repeat(shifts[:, -1:], pad, axis=1)], 1)
        s = s.reshape(B, (J + pad) // jb, jb, K)
        spreads.append(int((s.max(axis=2) - s.min(axis=2)).max()))
    return Bounds(int(src_rows.min()), int(src_rows.max()), int(shifts.min()),
                  int(shifts.max()), tuple(spreads))


def gather_tables(src_rows: np.ndarray, shifts: np.ndarray,
                  out_rows: np.ndarray, device, stage: str) -> GatherTables:
    """Check host tables, take their bounds, and put them on ``device``."""
    src_rows = np.ascontiguousarray(src_rows, dtype=np.int32)
    shifts = np.ascontiguousarray(shifts, dtype=np.int32)
    out_rows = np.ascontiguousarray(out_rows, dtype=np.int32)
    if src_rows.ndim != 2 or shifts.ndim != 3 or out_rows.ndim != 2:
        raise ValueError("src_rows must be [B, K], shifts [B, J, K] and "
                         "out_rows [B, J]")
    B, J, K = shifts.shape
    if src_rows.shape != (B, K) or out_rows.shape != (B, J):
        raise ValueError(f"src_rows {src_rows.shape} and out_rows "
                         f"{out_rows.shape} do not fit shifts {shifts.shape}")
    if K < 1:
        raise ValueError("each source set needs at least one source row")
    if not np.array_equal(np.sort(out_rows, axis=None), np.arange(B * J)):
        raise ValueError(f"out_rows must be a permutation of range({B * J})")

    def put(a):
        return torch.from_numpy(a).to(device)

    return GatherTables(put(src_rows), put(shifts), put(out_rows),
                        table_bounds(src_rows, shifts), stage)


def expand_tables(src_rows: np.ndarray, shifts: np.ndarray,
                  out_rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The generic ``[O, K]`` form of host tables:
    ``rows[out_rows[b, j]] = src_rows[b]``,
    ``row_shifts[out_rows[b, j]] = shifts[b, j]``."""
    B, J, K = np.shape(shifts)
    o = np.asarray(out_rows).reshape(-1)
    rows = np.empty((B * J, K), np.int32)
    row_shifts = np.empty((B * J, K), np.int32)
    rows[o] = np.repeat(np.asarray(src_rows), J, axis=0)
    row_shifts[o] = np.asarray(shifts).reshape(B * J, K)
    return rows, row_shifts


def _check(data, tables: GatherTables, out_len: int, out=None) -> None:
    if data.dim() != 2 or data.dtype != torch.float32:
        raise ValueError(f"data must be 2-D float32; got {tuple(data.shape)} "
                         f"{data.dtype}")
    if any(t.device != data.device for t in tables[:3]):
        raise ValueError("data and the index tables must lie on one device")
    if out_len < 0:
        raise ValueError(f"out_len must be >= 0; got {out_len}")
    if out is not None:
        B, J, _ = tables.shifts.shape
        if (out.dtype != torch.float32 or out.device != data.device
                or tuple(out.shape) != (B * J, out_len)
                or (out.numel() and (out.stride(1) != 1
                                     or out.stride(0) < out_len))):
            raise ValueError(
                f"out must be float32 [{B * J}, {out_len}] on {data.device} "
                f"with unit column stride; got {tuple(out.shape)} "
                f"{out.dtype} strides {out.stride()} on {out.device}")
        if out.untyped_storage().data_ptr() == \
                data.untyped_storage().data_ptr():
            raise ValueError("out must not share storage with data")
    R, L = data.shape
    bd = tables.bounds
    if tables.shifts.numel() == 0:
        return
    if bd.min_row < 0 or bd.max_row >= R:
        raise ValueError(f"rows span [{bd.min_row}, {bd.max_row}] outside "
                         f"[0, {R})")
    if bd.min_shift < 0 or bd.max_shift + out_len > L:
        raise ValueError(
            f"windows reach [{bd.min_shift}, {bd.max_shift} + {out_len}) "
            f"outside the {L} samples of each row")


def _torch_gather_sum(data, tables: GatherTables, out_len: int, out=None):
    """Plain PyTorch version (any device): one flat ``take`` per k, added
    in k order from zero, over slices of the output rows that bound the
    index memory."""
    B, J, K = tables.shifts.shape
    O = B * J
    L = data.shape[1]
    flat = data.reshape(-1)
    rows = tables.src_rows.to(torch.int64)[:, None, :].expand(B, J, K)
    rows = rows.reshape(O, K)
    shifts = tables.shifts.reshape(O, K).to(torch.int64)
    dest = tables.out_rows.reshape(O).to(torch.int64)
    if out is None:
        out = torch.empty((O, out_len), dtype=data.dtype, device=data.device)
    t = torch.arange(out_len, device=data.device, dtype=torch.int64)
    step = max(1, _INDEX_BUDGET // max(out_len, 1))
    for o0 in range(0, O, step):
        acc = torch.zeros((min(step, O - o0), out_len), dtype=data.dtype,
                          device=data.device)
        r, s = rows[o0:o0 + step], shifts[o0:o0 + step]
        for k in range(K):
            acc += torch.take(flat, (r[:, k] * L + s[:, k])[:, None] + t[None, :])
        out[dest[o0:o0 + step]] = acc
    return out


def _smem_bytes(K: int, jb: int, win_len: int) -> int:
    """Shared memory of one block (the layout in csrc/gather_sum.cu,
    which refuses a launch given less)."""
    def align16(n):
        return -(-n // 16) * 16

    return (align16(align16(4 * K * jb) + 12 * K)
            + _STAGES * 4 * ((win_len + 6) // 4 * 4))


def launch_config(J: int, K: int, spreads: Tuple[int, ...]):
    """(JB, E, threads, window length, shared bytes) of a launch: the
    largest JB of ``_CONFIGS``, from the least that covers J down, whose
    ring of windows of ``threads * E + spread`` samples fits in shared
    memory. Raises ValueError when even one output row per block does not
    fit."""
    first = next(i for i, jb in enumerate(_JBS) if jb >= min(J, _JBS[-1]))
    for i in range(first, -1, -1):
        jb = _JBS[i]
        e, threads = _CONFIGS[jb]
        win_len = threads * e + spreads[i]
        smem = _smem_bytes(K, jb, win_len)
        if smem <= _MAX_SMEM:
            return jb, e, threads, win_len, smem
    raise ValueError(
        f"gather-sum: a window of {win_len} samples over K={K} source "
        f"rows needs {smem} bytes of shared memory, more than {_MAX_SMEM}")


def _cuda_gather_sum(data, tables: GatherTables, out_len: int, out=None):
    B, J, K = tables.shifts.shape
    L = data.shape[1]
    jb, e, threads, win_len, smem = launch_config(J, K, tables.bounds.spreads)
    tile_runs = -(-out_len // (threads * e * _TILES_PER_BLOCK))
    if B > _MAX_GRID_YZ or tile_runs > _MAX_GRID_YZ:
        raise ValueError(f"B={B}, out_len={out_len} exceed the kernel's grid")
    if out is None:
        out = torch.empty((B * J, out_len), dtype=torch.float32,
                          device=data.device)
    if out.numel() == 0:
        return out
    lib = _build.load("gather_sum")
    data = data.contiguous()  # may start anywhere (a row of a view, say)
    fn = lib.gather_sum_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(data.device).cuda_stream
    _build.check(fn(data.data_ptr(), data.numel(), tables.src_rows.data_ptr(),
                    tables.shifts.data_ptr(), tables.out_rows.data_ptr(),
                    out.data_ptr(), L, B, J, K, out_len, out.stride(0), jb, e,
                    threads, win_len, smem, stream), "gather_sum")
    _build.count_launch(shifted_gather_sum, tables.stage)
    return out


def shifted_gather_sum(data: torch.Tensor, tables: GatherTables,
                       out_len: int, out=None) -> torch.Tensor:
    """``out[out_rows[b, j], t] = sum_k data[src_rows[b, k],
    shifts[b, j, k] + t]`` for ``t < out_len``; ``out`` is
    ``[B * J, out_len]`` float32, new unless the caller gives it: then a
    view whose rows may lie further apart than ``out_len`` (the first
    columns of a wider buffer), on data's device and sharing no storage
    with it, written in place and returned.

    ``data`` is [R, L] float32 on the tables' device; ``tables`` come from
    :func:`gather_tables`, whose host bounds let every window be checked
    against ``data`` before anything runs (ValueError, never an
    out-of-bounds read).

    A CPU tensor runs the plain PyTorch version; a CUDA tensor launches
    ``csrc/gather_sum.cu``, counted in
    ``shifted_gather_sum.launches[tables.stage]``."""
    _check(data, tables, out_len, out)
    if data.device.type == "cpu":
        return _torch_gather_sum(data, tables, out_len, out)
    if data.device.type == "cuda":
        return _cuda_gather_sum(data, tables, out_len, out)
    raise ValueError(f"no gather-sum for device {data.device}")


shifted_gather_sum.launches = collections.Counter()
