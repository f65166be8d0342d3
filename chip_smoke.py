#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``pypulsar_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result lines):

1. the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of every CUDA kernel of the port (one ``nvcc``
   per source, all started together);
2. each kernel against its plain PyTorch version on the card, on the
   shapes the 1024-channel x 1024-trial sweep gives it (gather-sum once
   per dedispersion stage), with its time (CUDA events around 10 calls
   back to back, after a warm-up; beside it the median of 10 single
   event-bracketed calls, the timer of the first port, which also counts
   a wrapper's host work the device waits for), the plain version's time
   and the least time the card could take for the same work; then on
   edge cases (gather-sum: a ragged last time tile, output rows per set
   not a multiple of the rows per block, one source row, shift spreads of
   ~2000, 15000 and 60000 samples, views whose rows start off a 16-byte
   boundary with windows at both ends, and a table past shared memory,
   which must raise ValueError; boxcar: unsorted widths that are not
   powers of two, widths past the 256 threads of a block, more than 8
   widths, a payload that is not a multiple of a block's stretch, views
   off a 16-byte boundary, ties).
   Tolerances: gather-sum exact (both add in k order from zero: max abs
   err 0); boxcar sums of squares and window maxima rtol 1e-5, payload
   sums rtol 1e-5 plus 1e-5 * sqrt(sum of squares) (a sum of zero-mean
   samples cancels), and each argbox start equal to the plain version's
   or holding the same maximum within rtol 1e-5;
3. the flat sweep on a small file, on the card against the CPU;
4. the main path: ``python -m pypulsar_tpu_torch.cli.sweep``'s entry point
   on a 1024-channel, 2^20-sample 8-bit file with a pulsar at DM 70, over
   1024 trials; the pulsar must be found and every kernel (gather-sum
   of stage 1, of stage 2, boxcar) must have been launched by that run;
5. the acceleration search on the card against the port on the CPU, on
   8 seeded series of 2^15 samples (tones, drifting tones, a weak tone,
   noise): the normalized spectra within 2e-5 of the largest magnitude,
   the candidates under the matched-candidate contract (dr, dz, dsig) =
   (0.5, 1.0, 0.5) above sigma_min + 0.5, and the card's candidates the
   same bits searched as one batch of 8 or two of 4; then a probe
   (printed, not a check) of whether cuFFT keeps a spectrum's bits when
   the search's transforms are batched, and what batching saves;
6. the survey's sweep stage on the same file, through the same entry
   point: ``--accel-search --write-dats`` over 32 trials from DM 54
   (the survey's defaults: zmax 200, 8 harmonics, sigma 2, batch 32).
   First its kernels at its own shapes against the plain versions (both
   gather-sum stages of the single-pulse pass's plan and of the series
   pass's, at the group size the stage picks, and boxcar on the
   single-pulse pass's series; exact, and boxcar as in phase 2; run
   before phase 4 on the file phase 4 reads).
   Every artifact must be written, the DM-70 table must hold a harmonic
   of the pulsar's 3.8147 Hz with |z| <= 2 and sigma > 10, the series
   pass must have launched both gather-sum stages (counted apart from
   the single-pulse pass), and the DM-70 ``.dat`` must equal the series
   the handoff searched. Then the handoff once more, over 8 trials,
   under ``torch.profiler``: device time by op family and idle share;
7. the survey's fold stage on phase 6's output, at the survey's settings.
   First the fold kernel against its plain version on the DM-70 ``.dat``
   (2^20 samples), 32 periods from 1.5 ms to 2 s that include the
   pulsar's, 64 bins, 32 partitions: counts exact, profiles rtol 1e-5 /
   atol 1e-3 (float32 sums in another order; the JAX package's own fold
   tolerance), and each candidate's profile the same bits in one batch
   of 32, two of 16 and alone; then edge cases (50 bins, T not a
   multiple of npart with an odd partition length, a series view 4 bytes
   off a 16-byte boundary, one candidate, every sample in one bin, the
   largest nbins, and one past it, which must raise ValueError), timed
   beside its bound and one ``index_add_`` of the same sums. Then
   ``cli.sift`` over the stage's 32 ``.cand`` files (``-s 4 --min-hits
   2``), ``cli.foldbatch --datbase`` (``-n 64 --npart 32 --batch 32``,
   the 33 x 17 refinement grid), ``cli.pfd_snr --json``, ``cli.foldbatch``
   on the raw file (the stream source, ``-s 64 --group-size 0``) and
   ``--datbase`` once more at ``--batch 7``. Every sifted candidate must
   have its archives, each archive the same bytes at batch 32 and 7, both
   sources must have launched the fold kernel and the stream source both
   gather-sum stages, and a candidate within 2 DM of 70 at the pulsar's
   period or a harmonic (k or 1/k an integer <= 8) must fold to SNR > 10
   from both sources with a refined period within one grid step of the
   true one. Then one more ``--datbase`` fold under ``torch.profiler``:
   the fold kernel's, ``refine_chi2``'s and the copies' device time, the
   host prep's wall time and the idle share.

Then one JSON line of per-kernel numbers, the card line, and the last
line ``{"ok": true, "device": {...}}``.
"""

import collections
import glob
import json
import os
import subprocess
import sys
import tempfile
import time
from fractions import Fraction

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SEED = 20261016
REPS = 10


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = REPS, warmup: int = 1) -> float:
    """Device ms per call of ``fn()``: CUDA events around ``reps`` calls
    run back to back after a warm-up, so the host's work in a wrapper
    overlaps the device's and is not counted as device time."""
    import torch

    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def single_call_ms(fn, reps: int = REPS, warmup: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of one call of ``fn()`` each,
    after a warm-up: the first port's timer, kept to compare with it."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound(nbytes: float, nops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    float32 operations over the card's peak rate."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def path_geometry(device):
    """The plan, chunk geometry and first trial-group batch the main path
    builds for the 1024-channel, 1024-trial sweep below."""
    import numpy as np

    from pypulsar_tpu_torch.parallel import sweep

    C, tsamp = 1024, 64e-6
    freqs = 1500.0 + (-300.0 / C) * np.arange(C)
    dms = 0.5 * np.arange(1024)
    g = sweep.choose_group_size(dms, freqs, tsamp, 64)
    plan = sweep.make_sweep_plan(dms, freqs, tsamp, nsub=64, group_size=g)
    payload = sweep.default_chunk_payload(plan.min_overlap)
    out_len = payload + max(plan.widths)
    L1 = out_len + plan.max_shift2
    batches = sweep.group_batches(plan.stage1_bins, plan.stage2_bins, 64, L1,
                                  device)
    return plan, payload, out_len, L1, batches


def check_gather_exact(what, src, tables, n):
    """One gather-sum launch against the plain version: equal bits."""
    import torch

    from pypulsar_tpu_torch.ops import gather_sum as gs

    got = gs.shifted_gather_sum(src, tables, n)
    want = gs._torch_gather_sum(src, tables, n)
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.equal(got, want):
        fail(f"gather_sum {what} disagrees with its plain version "
             f"(max abs err {err})")
    return got, err


def check_gather_stage(stage, src, tables, n, report):
    """One stage of the path against the plain version, then timed."""
    from pypulsar_tpu_torch.ops import gather_sum as gs

    got, err = check_gather_exact(stage, src, tables, n)
    B, J, K = tables.shifts.shape
    R, L = src.shape
    jb, e, threads, win, _ = gs.launch_config(J, K, tables.bounds.spreads)
    ms = cuda_time_ms(lambda: gs.shifted_gather_sum(src, tables, n))
    single_ms = single_call_ms(lambda: gs.shifted_gather_sum(src, tables, n))
    plain_ms = cuda_time_ms(lambda: gs._torch_gather_sum(src, tables, n))
    nbytes = 4.0 * R * L + 4.0 * (B * K + B * J * K + B * J) + 4.0 * B * J * n
    bms, by = bound(nbytes, float(B) * J * K * n)
    report.append(dict(
        name=f"gather_sum/{stage}", route="cuda",
        source="pypulsar_tpu_torch/ops/csrc/gather_sum.cu",
        replaces="pypulsar_tpu/ops/pallas_dedisperse.py:107",
        shape=f"data [{R}, {L}], src_rows [{B}, {K}], shifts [{B}, {J}, "
              f"{K}], out_len {n}; {jb} rows x {e} samples per thread, "
              f"{threads} threads, window {win}",
        max_abs_err=err, ms=ms, single_call_ms=single_ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None))
    print(f"gather_sum {stage}: [{R}x{L}] -> [{B * J}x{n}], B={B} J={J} "
          f"K={K} (JB={jb}, E={e}, window {win}): kernel {ms:.3f} ms "
          f"(single calls {single_ms:.3f} ms), plain "
          f"{plain_ms:.3f} ms, bound {bms:.3f} ms ({by}: "
          f"{nbytes / 1e9:.3f} GB), max abs err {err:.3g}")
    return got


def check_gather(device, report):
    """Both stages of the first trial-group batch of the path on random
    channels; returns the dedispersed series and the chunk payload."""
    import torch

    plan, payload, out_len, L1, batches = path_geometry(device)
    b = batches[0]
    gen = torch.Generator(device=device).manual_seed(SEED)
    data = torch.randn((1024, L1 + plan.max_shift1), generator=gen,
                       device=device)
    sub = check_gather_stage("stage1", data, b.stage1, L1, report)
    del data
    ts = check_gather_stage("stage2", sub, b.stage2, out_len, report)
    return ts, payload


def check_gather_edges(device):
    """Gather-sum shapes the path does not give it, against the plain
    version; tables past shared memory must raise before launching."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.ops import gather_sum as gs

    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    R, L = 48, 70001  # odd: row r of the tensor starts r floats past 16 bytes
    data = torch.randn((R, L), generator=gen, device=device)
    cases = [  # (what, B, J, K, out_len, shift spread)
        ("ragged tile", 3, 16, 8, 5037, 40),
        ("J=20 (16 rows per block)", 2, 20, 16, 4100, 30),
        ("J=12", 2, 12, 5, 3000, 30),
        ("K=1", 4, 9, 1, 2049, 10),
        ("J=5 (8 rows per block)", 3, 5, 24, 3100, 50),
        ("J=1 generic form", 6, 1, 32, 1000, 5000),
        ("spread 2000", 2, 64, 16, 6000, 2000),
    ]
    done = []
    for what, B, J, K, n, spread in cases:
        base = rng.integers(0, L - n - spread, size=(B, 1, K))
        shifts = base + rng.integers(0, spread + 1, size=(B, J, K))
        tables = gs.gather_tables(
            rng.integers(0, R, size=(B, K)), shifts,
            rng.permutation(B * J).reshape(B, J), device, "edge")
        check_gather_exact(what, data, tables, n)
        done.append(f"{what}: JB={gs.launch_config(J, K, tables.bounds.spreads)[0]}")
    # the halves of a set 15000 samples apart: too wide for 16 rows per
    # block, the wrapper narrows to 8; rows 60000 apart in turn: to one row
    # per block, whose window has no spread
    for what, far in (("spread 15000", np.repeat([0, 15000], 8)),
                      ("spread 60000", np.tile([0, 60000], 8))):
        shifts = np.repeat(far[None, :, None], 4, axis=2)
        tables = gs.gather_tables(rng.integers(0, R, size=(1, 4)), shifts,
                                  np.arange(16)[None, :], device, "edge")
        check_gather_exact(what, data, tables, 5000)
        done.append(f"{what}: JB="
                    f"{gs.launch_config(16, 4, tables.bounds.spreads)[0]}")
    # views of data[lead:] start lead floats past a 16-byte boundary; the
    # windows of their first row start at 0 and of their last row end at L
    for lead in (1, 2, 3):
        n, rv = 3000, R - lead
        src = rng.integers(0, rv, size=(2, 6))
        src[0, 0], src[1, -1] = 0, rv - 1
        shifts = (rng.integers(0, L - n - 30, size=(2, 1, 6))
                  + rng.integers(0, 31, size=(2, 12, 6)))
        shifts[0, :, 0] = np.arange(12) % 3
        shifts[1, :, -1] = L - n - np.arange(12) % 3
        tables = gs.gather_tables(src, shifts,
                                  rng.permutation(24).reshape(2, 12), device,
                                  "edge")
        check_gather_exact(f"view at +{lead}", data[lead:], tables, n)
        done.append(f"view at +{lead} floats: JB="
                    f"{gs.launch_config(12, 6, tables.bounds.spreads)[0]}")
    # 15000 source rows: their offsets alone pass shared memory
    tables = gs.gather_tables(np.zeros((1, 15000)), np.zeros((1, 1, 15000)),
                              np.zeros((1, 1)), device, "edge")
    try:
        gs.shifted_gather_sum(data, tables, 100)
    except ValueError as e:
        done.append(f"K=15000 refused ({e})")
    else:
        fail("gather_sum launched a block past shared memory")
    print("gather_sum edge cases equal the plain version: " + "; ".join(done))


def compare_boxcar(what, ts, widths, stat_len):
    """The kernel against the plain version on one input; returns
    (max abs err of the maxima, argbox cells that differ)."""
    import torch

    from pypulsar_tpu_torch.ops import boxcar_stats as bx

    got = bx.boxcar_stats(ts, widths, stat_len)
    want = bx._torch_boxcar_stats(ts, widths, stat_len)
    torch.cuda.synchronize()
    s, ss, mb, ab = got
    ws, wss, wmb, wab = want
    # a sum of zero-mean samples cancels: its tolerance scales with the
    # root of the sum of squares, the size of its terms' rounding
    scale = 1e-5 * wss.sqrt()
    if not ((s - ws).abs() <= 1e-5 * ws.abs() + scale).all():
        fail(f"boxcar_stats {what}: payload sums disagree with the plain "
             f"version")
    for name, g, w in (("sumsq", ss, wss), ("maxbox", mb, wmb)):
        if not torch.allclose(g, w, rtol=1e-5, atol=0.0):
            fail(f"boxcar_stats {what}: {name} disagrees with the plain "
                 f"version (max rel err "
                 f"{float(((g - w) / w).abs().max()):.3g})")
    # a different start is right only where it holds the maximum too
    cs = torch.cat([torch.zeros((ts.shape[0], 1), dtype=torch.float64,
                                device=ts.device),
                    torch.cumsum(ts.double(), dim=1)], dim=1)
    for k, w in enumerate(widths):
        a = ab[:, k].long()
        at = cs.gather(1, (a + w)[:, None])[:, 0] - cs.gather(1, a[:, None])[:, 0]
        near = (at - wmb[:, k].double()).abs() <= 1e-5 * wmb[:, k].double().abs()
        if not bool(((ab[:, k] == wab[:, k]) | near).all()):
            fail(f"boxcar_stats {what}: width {w} starts hold no maximum")
    return float((mb - wmb).abs().max()), int((ab != wab).sum())


def check_boxcar(device, report, ts_in, stat_len):
    import torch

    from pypulsar_tpu_torch.ops import boxcar_stats as bx

    widths = (1, 2, 4, 8, 16, 32)
    ts = ts_in.contiguous()
    err, n_diff = compare_boxcar("path", ts, widths, stat_len)
    # ties: constant rows tie everywhere, two equal pulses keep the first
    tie = torch.ones((4, 5000), device=device)
    tie[1:] = 0.0
    tie[1:, 3000:3004] = 5.0
    tie[1:, 700:704] = 5.0
    tg = bx.boxcar_stats(tie, widths, 4096)
    tw = bx._torch_boxcar_stats(tie, widths, 4096)
    if not (torch.equal(tg[3], tw[3]) and int(tg[3][0].max()) == 0
            and int(tg[3][1, 0]) == 700):
        fail(f"boxcar_stats: tie rule broken: {tg[3].tolist()}")
    # widths neither sorted nor powers of two, widths past the 256 threads
    # of a block (a level's halo takes several passes), more than 8 widths
    # (the kernel's second register layout), payloads off a stretch
    # boundary; then views of edge[lead:], whose rows start lead floats
    # past a 16-byte boundary (T is odd), with windows to the end of the
    # last row
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    T_edge = 60001
    edge = torch.randn((37, T_edge), generator=gen, device=device)
    edge[5, 33333:33340] += 40.0
    edges = []
    cases = [(0, (100, 3, 7, 5), 40001), (0, (300, 7, 1000), 50003),
             (0, (1, 2, 3, 5, 8, 13, 21, 34, 55, 89), 50003),
             (0, widths, 16385)]
    cases += [(lead, widths, T_edge - 32) for lead in (1, 2, 3)]
    for lead, w, n in cases:
        what = f"edge[{lead}:] widths {w} stat_len {n}"
        e_err, e_diff = compare_boxcar(what, edge[lead:], w, n)
        edges.append(f"{what}: max abs err {e_err:.3g}, {e_diff} argbox "
                     f"cells differ")
    ms = cuda_time_ms(lambda: bx.boxcar_stats(ts, widths, stat_len))
    single_ms = single_call_ms(lambda: bx.boxcar_stats(ts, widths, stat_len))
    plain_ms = cuda_time_ms(lambda: bx._torch_boxcar_stats(ts, widths,
                                                           stat_len))
    D, T = ts.shape
    W = len(widths)
    nbytes = 4.0 * D * T + D * (8.0 + 8.0 * W)
    bms, by = bound(nbytes, float(D) * stat_len * (2 + 2 * W))
    report.append(dict(
        name="boxcar_stats", route="cuda",
        source="pypulsar_tpu_torch/ops/csrc/boxcar_stats.cu",
        replaces="pypulsar_tpu/ops/pallas_kernels.py:133",
        shape=f"ts [{D}, {T}], stat_len {stat_len}, widths {list(widths)}",
        max_abs_err=err, ms=ms, single_call_ms=single_ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None))
    print(f"boxcar_stats: [{D}x{T}] stat_len={stat_len}: kernel {ms:.3f} ms "
          f"(single calls {single_ms:.3f} ms), "
          f"plain {plain_ms:.3f} ms, bound {bms:.3f} ms ({by}: "
          f"{nbytes / 1e9:.3f} GB), max abs err {err:.3g}, "
          f"{n_diff} argbox cells differ (all at maxima within 1e-5); "
          f"ties kept first; " + "; ".join(edges))


def check_small_sweep(tmp):
    """The flat sweep of a small file on the card against the CPU."""
    import numpy as np

    from pypulsar_tpu_torch.io.filterbank import FilterbankFile
    from pypulsar_tpu_torch.io.synth import write_synthetic_fil
    from pypulsar_tpu_torch.parallel.staged import sweep_flat

    fn = os.path.join(tmp, "small.fil")
    write_synthetic_fil(fn, nchan=256, nsamp=1 << 16, dm=40.0,
                        period_samples=2048, seed=SEED)
    dms = np.arange(64) * 1.0
    res = {}
    for dev in ("cuda", "cpu"):
        with FilterbankFile(fn) as r:
            res[dev] = sweep_flat(r, dms, nsub=32, group_size=8,
                                  chunk_payload=20000,
                                  device=dev).steps[0].result
    a, b = res["cuda"], res["cpu"]
    if not (np.isfinite(a.snr).all() and a.snr.shape == (64, 6)):
        fail("small sweep: non-finite or misshapen SNR on the card")
    if not np.allclose(a.snr, b.snr, rtol=5e-6, atol=1e-4):
        fail(f"small sweep: card and CPU SNR differ by "
             f"{np.abs(a.snr - b.snr).max():.3g}")
    if a.best(1)[0]["dm"] != b.best(1)[0]["dm"]:
        fail("small sweep: card and CPU pick different best DMs")
    print(f"small sweep (256 chans, 2^16 samples, 64 trials): card vs CPU "
          f"max |dSNR| {np.abs(a.snr - b.snr).max():.3g}, peaks differing "
          f"{int((a.peak_sample != b.peak_sample).sum())}/{a.snr.size}, "
          f"best DM {a.best(1)[0]['dm']}")


def launch_counts() -> dict:
    """Every kernel's launch count, by the kernels line's names."""
    from pypulsar_tpu_torch.ops.boxcar_stats import boxcar_stats
    from pypulsar_tpu_torch.ops.fold import fold_parts_batch
    from pypulsar_tpu_torch.ops.gather_sum import shifted_gather_sum

    return {"gather_sum/stage1": shifted_gather_sum.launches["stage1"],
            "gather_sum/stage2": shifted_gather_sum.launches["stage2"],
            "boxcar_stats": boxcar_stats.launches,
            "fold_parts_batch": fold_parts_batch.launches}


SWEEP_KERNELS = ("gather_sum/stage1", "gather_sum/stage2", "boxcar_stats")


def sweep_launches() -> dict:
    """The launch counts of the sweep's kernels."""
    counts = launch_counts()
    return {k: counts[k] for k in SWEEP_KERNELS}


def reset_launch_counts() -> None:
    from pypulsar_tpu_torch.ops.boxcar_stats import boxcar_stats
    from pypulsar_tpu_torch.ops.fold import fold_parts_batch
    from pypulsar_tpu_torch.ops.gather_sum import shifted_gather_sum

    shifted_gather_sum.launches.clear()
    boxcar_stats.launches = 0
    fold_parts_batch.launches = 0


def write_obs(tmp):
    """The full-width file both driven paths read."""
    from pypulsar_tpu_torch.io.synth import write_synthetic_fil

    fn = os.path.join(tmp, "obs.fil")
    t0 = time.perf_counter()
    info = write_synthetic_fil(fn, nchan=1024, tsamp=64e-6, nsamp=1 << 20,
                               fch1=1500.0, bw=300.0, dm=70.0,
                               period_samples=4096, width=8, nbits=8,
                               seed=SEED)
    print(f"wrote {info['nsamp']} x {info['nchan']} 8-bit samples "
          f"({os.path.getsize(fn) / 1e9:.3f} GB) in "
          f"{time.perf_counter() - t0:.1f} s")
    return fn, info


def main_path(tmp, fn, info):
    """The CLI's entry point on the full-width file; returns its numbers."""
    import torch

    from pypulsar_tpu_torch.cli import sweep as cli

    out = os.path.join(tmp, "obs")
    argv = [fn, "--lodm", "0", "--dmstep", "0.5", "--numdms", "1024",
            "--nsub", "64", "-o", out, "--device", "cuda"]
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sweep_launches()
    if rc != 0:
        fail(f"sweep CLI exited {rc}")
    if min(launches.values()) < 1:
        fail(f"a kernel was not launched on the main path: {launches}")
    with open(out + ".cands") as f:
        rows = [ln.split() for ln in f.read().splitlines()[1:]]
    if not rows:
        fail("the sweep wrote no candidates")
    best = max(rows, key=lambda r: float(r[1]))
    if abs(float(best[0]) - 70.0) > 1.0:
        fail(f"best candidate at DM {best[0]}, not the injected 70")
    duration = info["nsamp"] * info["tsamp"]
    print(f"main path: 1024 trials x {info['nsamp']} samples x 1024 chans in "
          f"{wall:.3f} s wall: {1024 / wall:.1f} DM-trials/s, "
          f"{1024 * info['nsamp'] / wall / 1e9:.3f} G trial-samples/s, "
          f"real-time factor {duration / wall:.2f} ({duration:.1f} s of data); "
          f"best DM {best[0]} SNR {best[1]}; launches {launches}")
    profile_main_path(cli, argv)
    return launches, wall


def profile_main_path(cli, argv):
    """The main path once more under torch.profiler: device time by
    kernel and copy, against the wall time of the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = {}  # device-side events only: kernels, copies, sets
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            rows[ev.key] = (ev.self_device_time_total / 1e3, ev.count)
    busy_ms = sum(v[0] for k, v in rows.items() if "Memcpy" not in k)
    copy_ms = sum(v[0] for k, v in rows.items() if "Memcpy" in k)
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:10]
    print("profile: " + json.dumps({
        "wall_ms": wall * 1e3, "kernel_ms": busy_ms, "copy_ms": copy_ms,
        "kernel_idle_share": 1.0 - busy_ms / (wall * 1e3),
        "top": [[k[:80], round(v[0], 3), v[1]] for k, v in top]}))


ACCEL_BATTERY = [  # (f0 Hz, z bins over T, amplitude)
    (37.0, 0.0, 0.30), (61.0, 0.0, 0.18), (43.0, 8.0, 0.25),
    (29.0, -12.0, 0.25), (53.0, 4.0, 0.10), (71.0, 0.0, 0.07),
    (47.0, 0.0, 0.0), (83.0, -4.0, 0.20)]


def unmatched(a, b, floor, dr=0.5, dz=1.0, dsig=0.5):
    """Candidates of ``a`` above ``floor`` with no partner in ``b`` within
    (dr, dz, dsig): the matched-candidate contract's violations."""
    return [c for c in a if c.sigma > floor and not any(
        abs(c.r - o.r) < dr and abs(c.z - o.z) < dz
        and abs(c.sigma - o.sigma) < dsig for o in b)]


def check_small_accel(device):
    """Prep and search on the card against the port on the CPU."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.fourier import accelsearch as accel
    from pypulsar_tpu_torch.fourier import kernels

    n, dt = 1 << 15, 2.5e-4
    T = n * dt
    t = np.arange(n) * dt
    rng = np.random.default_rng(SEED)
    rows = []
    for f0, z, amp in ACCEL_BATTERY:
        ts = rng.standard_normal(n).astype(np.float32)
        ts += (amp * np.cos(2 * np.pi * (f0 * t + 0.5 * z / T ** 2 * t * t))
               ).astype(np.float32)
        rows.append(ts)
    series = np.stack(rows)
    cfg = accel.AccelSearchConfig(zmax=20.0, dz=2.0, numharm=4,
                                  sigma_min=3.0, seg_width=1 << 12)
    card = kernels.prep_spectra_batch(series, device=device)
    cpu = kernels.prep_spectra_batch(series, device="cpu")
    prep_err = float((card.cpu() - cpu).abs().max()
                     / cpu[:, 1:].abs().max())
    if not prep_err < 2e-5:
        fail(f"small accel: card and CPU spectra differ by {prep_err:.3g} "
             f"of the largest magnitude")
    got = accel.accel_search_batch(card, T, cfg, device=device)
    want = accel.accel_search_batch(cpu, T, cfg, device="cpu")
    bound = cfg.sigma_min + 0.5
    for i, (g, w) in enumerate(zip(got, want)):
        bad = unmatched(g, w, bound) + unmatched(w, g, bound)
        if bad:
            fail(f"small accel: spectrum {i} breaks the matched-candidate "
                 f"contract: {bad[:3]}")
    detecting = sum(any(c.sigma > bound for c in g) for g in got)
    if detecting < 6:
        fail(f"small accel: only {detecting}/8 spectra detect a tone")
    # the same spectra prepped and searched as two batches of 4
    halves = []
    for s in (slice(0, 4), slice(4, 8)):
        halves += accel.accel_search_batch(
            kernels.prep_spectra_batch(series[s], device=device), T, cfg,
            device=device)
    torch.cuda.synchronize()
    if halves != got:
        fail("small accel: the card's candidates differ between one batch "
             "of 8 and two batches of 4")
    print(f"small accel (8 x 2^15 samples, zmax 20, 4 harmonics, card vs "
          f"CPU): spectra max abs diff {prep_err:.3g} of the largest "
          f"magnitude; candidates {sum(map(len, got))} card / "
          f"{sum(map(len, want))} CPU, every one above {bound} matched; "
          f"{detecting}/8 spectra detect; batch of 8 and 2 x 4 on the card: "
          f"identical candidates")


def probe_batched_transforms(device):
    """Whether cuFFT gives a spectrum the same bits transformed alone and
    in a batch, at the shapes of the stage's search (a segment slice of
    L = 32,768 at an odd offset of the padded spectra, and the inverse
    FFT of its product with a 402-row bank) and of its prep (rfft of 2^20
    samples), and the device time of each form. The search transforms
    each spectrum alone (``accelsearch._run_stage_batch``); this measures
    what batching them would keep and save."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 4)

    def crandn(*shape):
        return torch.complex(
            torch.randn(shape, generator=gen, device=device),
            torch.randn(shape, generator=gen, device=device))

    L, rows, start = 32768, 402, 4097
    tf = crandn(rows, L)
    res = {}
    for B in (8, 32):
        pad = crandn(B, 2 * L + 13)
        one = torch.stack([torch.fft.fft(pad[b, start:start + L])
                           for b in range(B)])
        many = torch.fft.fft(pad[:, start:start + L])
        fwd_same = torch.equal(one, many)
        big = torch.fft.ifft(many[:, None] * tf, dim=2)
        inv_same = all(torch.equal(torch.fft.ifft(many[b] * tf, dim=1),
                                   big[b]) for b in range(B))
        del big, one

        def fwd_alone():
            for b in range(B):
                torch.fft.fft(pad[b, start:start + L])

        def inv_alone():
            for b in range(B):
                torch.fft.ifft(many[b] * tf, dim=1)

        res[f"B={B}"] = {
            "fft_same_bits": fwd_same, "ifft_same_bits": inv_same,
            "fft_ms_alone": cuda_time_ms(fwd_alone, reps=3),
            "fft_ms_batched": cuda_time_ms(
                lambda: torch.fft.fft(pad[:, start:start + L]), reps=3),
            "ifft_ms_alone": cuda_time_ms(inv_alone, reps=3),
            "ifft_ms_batched": cuda_time_ms(
                lambda: torch.fft.ifft(many[:, None] * tf, dim=2), reps=3)}
        del pad, many
        torch.cuda.empty_cache()
    series = torch.randn((32, 1 << 20), generator=gen, device=device)
    one = torch.stack([torch.fft.rfft(row) for row in series])
    res["rfft 32 x 2^20"] = {
        "same_bits": torch.equal(one, torch.fft.rfft(series)),
        "ms_alone": cuda_time_ms(
            lambda: [torch.fft.rfft(row) for row in series], reps=3),
        "ms_batched": cuda_time_ms(lambda: torch.fft.rfft(series), reps=3)}
    del series, one, tf
    torch.cuda.empty_cache()
    print("fft batching probe: " + json.dumps(res))


class Timed:
    """For one run, wrap ``module.name`` to add up the wall seconds of its
    calls (the device synchronized at the end of each), the kernel
    launches inside them, and keep its last result."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.seconds, self.calls, self.result = 0.0, 0, None
        self.launches = collections.Counter()

    def __enter__(self):
        import torch

        def wrapper(*a, **kw):
            before = collections.Counter(launch_counts())
            t0 = time.perf_counter()
            out = self.real(*a, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            self.launches.update(collections.Counter(launch_counts())
                                 - before)
            self.result = out
            return out

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


STAGE_LODM, STAGE_DMS = 54, 32  # the sweep stage's trials: DM 54..85


def check_stage_kernels(fn, device):
    """The kernels at the sweep stage's own shapes, on the card against
    the plain versions: both gather-sum stages of the first trial-group
    batch of each pass's plan (the single-pulse pass with the sweep's
    widths, the series pass with one width, both at the group size the
    stage picks over its whole grid), and boxcar on the single-pulse
    pass's series. Random channels; any difference fails."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.io.filterbank import FilterbankFile
    from pypulsar_tpu_torch.parallel import staged, sweep

    dms = STAGE_LODM + 1.0 * np.arange(STAGE_DMS)
    with FilterbankFile(fn) as r:
        src = staged.ReaderSource(r)
        g = sweep.choose_group_size(dms, src.frequencies, src.tsamp, 64)
        plan, payload, _ = staged.step_geometry(
            src, dms, 1, 64, g, sweep.DEFAULT_WIDTHS, None)
        passes = {"single-pulse pass": (plan, payload,
                                        payload + max(plan.widths))}
        plan, payload, _ = staged.dats_geometry(r, dms, nsub=64,
                                                group_size=g)
        passes["series pass"] = (plan, payload, payload)
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    done = []
    for what, (plan, payload, out_len) in passes.items():
        L1 = out_len + plan.max_shift2
        b = sweep.group_batches(plan.stage1_bins, plan.stage2_bins,
                                plan.nsub, L1, device)[0]
        data = torch.randn((len(plan.freqs), L1 + plan.max_shift1),
                           generator=gen, device=device)
        sub, _ = check_gather_exact(f"{what} stage 1", data, b.stage1, L1)
        del data
        ts, _ = check_gather_exact(f"{what} stage 2", sub, b.stage2, out_len)
        del sub
        B1, J1, _ = b.stage1.shifts.shape
        line = (f"{what} (group {plan.group_size}, widths "
                f"{list(plan.widths)}): stage 1 -> [{B1 * J1}x{L1}], "
                f"stage 2 -> [{ts.shape[0]}x{out_len}] exact")
        if plan.widths != (1,):
            err, n_diff = compare_boxcar(what, ts, plan.widths, payload)
            line += (f", boxcar stat_len {payload}: max abs err {err:.3g}, "
                     f"{n_diff} argbox cells differ")
        done.append(line)
        del ts
    torch.cuda.empty_cache()
    print("sweep stage kernels equal the plain versions: "
          + "; ".join(done))


def stage_argv(fn, out, lodm, numdms, extra=()):
    """The sweep stage's argv with the survey's defaults."""
    return [fn, "--lodm", str(lodm), "--dmstep", "1", "--numdms",
            str(numdms), "--nsub", "64", "--group-size", "0", "--threshold",
            "6", "-o", out, "--device", "cuda", "--accel-search",
            "--accel-zmax", "200", "--accel-dz", "2", "--accel-numharm", "8",
            "--accel-sigma", "2", "--accel-batch", "32", *extra]


def stage_path(tmp, fn, info):
    """The sweep stage with its streamed handoff at full width; returns
    the launches of its two passes."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.cli import sweep as cli
    from pypulsar_tpu_torch.fourier import accelsearch as accel
    from pypulsar_tpu_torch.io.prestocand import read_rzwcands
    from pypulsar_tpu_torch.parallel import accelpipe, staged

    out = os.path.join(tmp, "stage")
    D, lodm = STAGE_DMS, STAGE_LODM
    argv = stage_argv(fn, out, lodm, D, ["--write-dats"])
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with Timed(staged, "sweep_flat") as sp, \
            Timed(accelpipe, "sweep_accel_stream") as ho, \
            Timed(accelpipe, "stream_series") as ser, \
            Timed(accelpipe, "accel_search_batch") as srch:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = sweep_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0:
        fail(f"sweep stage exited {rc}")
    if min(launches.values()) < 1:
        fail(f"a kernel was not launched on the sweep stage: {launches}")
    for what, counts in (("single-pulse pass", sp.launches),
                         ("series pass", ser.launches)):
        if min(counts["gather_sum/stage1"], counts["gather_sum/stage2"]) < 1:
            fail(f"the {what} launched no gather-sum stage: {dict(counts)}")
    dms = lodm + np.arange(D)
    want = {".dat": D, ".inf": D, "_ACCEL_200.cand": D,
            "_ACCEL_200.txtcand": D}
    for suffix, n in want.items():
        got = len(glob.glob(f"{out}_DM*{suffix}"))
        if got != n:
            fail(f"sweep stage wrote {got} {suffix} files, not {n}")
    if not os.path.exists(out + ".cands"):
        fail("sweep stage wrote no .cands")
    i70 = int(np.nonzero(dms == 70)[0][0])
    series = ser.result[0]
    dat = np.fromfile(f"{out}_DM70.00.dat", dtype=np.float32)
    if not np.array_equal(dat, series[i70]):
        fail("the DM-70 .dat differs from the series the handoff searched")
    if not np.isfinite(series).all() or series.shape != (D, info["nsamp"]):
        fail(f"series buffer misshapen or non-finite: {series.shape}")
    T = info["nsamp"] * info["tsamp"]
    f0 = 1.0 / (info["period_samples"] * info["tsamp"])
    cands = read_rzwcands(f"{out}_DM70.00_ACCEL_200.cand")

    def harmonic(c):
        k = (c.r / T) / f0
        return k > 0.5 and abs(k - round(k)) < 0.02

    hits = [c for c in cands[:10] if harmonic(c) and abs(c.z) <= 2.0
            and c.sig > 10]
    if not hits:
        fail(f"the DM-70 table holds no harmonic of {f0:.4f} Hz with "
             f"|z| <= 2 and sigma > 10: {cands[:5]}")
    # the host's bank build, which the stage's first search call paid
    # for, timed once more from an empty cache; then the stage chunks the
    # search planned (host arithmetic on the banks)
    cfg = accel.AccelSearchConfig()
    N = info["nsamp"] // 2 + 1
    accel._BANK_CACHE.clear()
    accel._BANK_CACHE_BYTES[0] = 0
    t0 = time.perf_counter()
    setup = accel._search_setup(N, T, cfg)
    bank_build_s = time.perf_counter() - t0
    banks = setup[6]
    chunks = {}
    for H in cfg.stages:
        fixed = accel._stage_fixed_bytes(
            [banks[Fraction(b, H)][0] for b in range(1, H + 1)])
        per = accel._stage_chunk_bytes(len(cfg.zs), 1, cfg.seg_width)
        chunks[H] = max(1, min(D, (int(accel.ACCEL_HBM_BYTES) - fixed)
                               // per))
    accel_s = ho.seconds - ser.seconds
    numbers = {
        "trials": D, "samples": info["nsamp"], "spectral_bins": N,
        "wall_s": wall, "single_pulse_s": sp.seconds, "handoff_s": ho.seconds,
        "series_s": ser.seconds, "accel_s": accel_s,
        "search_calls_s": srch.seconds, "search_calls": srch.calls,
        "bank_build_s": bank_build_s,
        "spectra_per_s": D / accel_s, "peak_device_gb": peak_gb,
        "stage_chunk_spectra": chunks,
        "launches": launches,
        "launches_single_pulse": dict(sp.launches),
        "launches_series": dict(ser.launches),
        "dm70_best": [{"r": c.r, "z": c.z, "sigma": c.sig,
                       "harmonic": round((c.r / T) / f0)} for c in hits[:3]]}
    print("stage: " + json.dumps(numbers))
    profile_handoff(cli, fn, os.path.join(tmp, "prof"))
    return sp.launches, ser.launches


# op families of the handoff's device time, by the aten op that launched
# each kernel (its self device time)
FAMILIES = (
    ("fft/ifft", ("fft",)),
    ("multiply, |.|^2", ("aten::mul", "aten::abs", "aten::square",
                         "aten::pow")),
    ("stretch gather + accumulate", ("aten::index_select", "aten::gather",
                                     "aten::add")),
    ("topk/detection", ("aten::topk", "aten::ge", "aten::gt",
                        "aten::bitwise_and", "aten::__and__", "aten::where",
                        "aten::constant_pad_nd", "aten::index",
                        "aten::full_like", "aten::stack")),
    ("deredden sort", ("aten::sort",)),
)


def profile_handoff(cli, fn, out):
    """The handoff (``--accel-only``) over 8 trials from DM 66 under
    torch.profiler: device time by op family, and the device's idle
    share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    argv = stage_argv(fn, out, 66, 8, ["--accel-only"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if cli.main(argv) != 0:
            fail("profiled handoff failed")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernel_ms, copy_ms, ours = 0.0, 0.0, 0.0
    fam, other = collections.Counter(), collections.Counter()
    top = []
    for ev in prof.key_averages():
        ms = ev.self_device_time_total / 1e3
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if "Memcpy" in ev.key or "Memset" in ev.key:
                copy_ms += ms
            else:
                kernel_ms += ms
                top.append((ev.key[:70], round(ms, 3), ev.count))
            if "gather_sum" in ev.key or "boxcar" in ev.key:
                ours += ms
        elif ms > 0:
            name = next((f for f, keys in FAMILIES
                         if any(k in ev.key for k in keys)), "other ops")
            fam[name] += ms
            if name == "other ops":
                other[ev.key] += ms
    fam["dedispersion kernels (gather-sum)"] = ours
    top.sort(key=lambda r: -r[1])
    print("handoff profile: " + json.dumps({
        "trials": 8, "wall_ms": wall_ms, "kernel_ms": kernel_ms,
        "copy_ms": copy_ms, "idle_share": 1.0 - kernel_ms / wall_ms,
        "by_family_ms": dict(fam),
        "other_ops_ms": dict(other.most_common(8)),
        "top_kernels": top[:12]}))


FOLD_NBINS, FOLD_NPART = 64, 32  # the survey's fold stage (-n 64 --npart 32)


def fold_bins(series, dt, periods, nbins, npart):
    """[K, T] int32 bin indices of ``periods`` over ``series``, by the fold
    stage's own host prep."""
    from pypulsar_tpu_torch.parallel import foldpipe

    members = [(i, foldpipe.FoldCandidate(float(p), 70.0))
               for i, p in enumerate(periods)]
    _, _, _, bins, err = foldpipe._prep_group(
        (70.0, series, dt, {}, members), nbins, npart)
    if err is not None:
        raise err
    return bins


def compare_fold(what, s, b, nbins, npart):
    """The fold kernel against its plain version: counts exact, profiles
    rtol 1e-5 / atol 1e-3; returns (profiles, counts, max abs err)."""
    import torch

    from pypulsar_tpu_torch.ops import fold

    got_p, got_c = fold.fold_parts_batch(s, b, nbins, npart)
    want_p, want_c = fold._torch_fold_parts_batch(s, b, nbins, npart)
    torch.cuda.synchronize()
    if not torch.equal(got_c, want_c):
        fail(f"fold_parts_batch {what}: counts differ from the plain version")
    err = float((got_p - want_p).abs().max()) if got_p.numel() else 0.0
    if not torch.allclose(got_p, want_p, rtol=1e-5, atol=1e-3):
        fail(f"fold_parts_batch {what}: profiles differ from the plain "
             f"version (max abs err {err:.3g})")
    return got_p, got_c, err


def check_fold(device, report, datfn, dt):
    """The fold kernel at the fold stage's shapes (the DM-70 series, 32
    periods from 1.5 ms to 2 s that include the pulsar's, 64 bins, 32
    partitions) against its plain version, a candidate's bits in one batch
    of 32, two of 16 and alone, then the edge cases; timed beside its
    bound and one ``index_add_`` over precomputed flat indices."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.ops import fold

    series = np.fromfile(datfn, dtype=np.float32)
    T, nbins, npart = len(series), FOLD_NBINS, FOLD_NPART
    psr = 4096 * 64e-6
    periods = np.sort(np.append(np.geomspace(1.5e-3, 2.0, 31), psr))
    bins_np = fold_bins(series, dt, periods, nbins, npart)
    s = torch.from_numpy(series).to(device)
    b = torch.from_numpy(bins_np).to(device)
    K = b.shape[0]
    profs, counts, err = compare_fold("stage shapes", s, b, nbins, npart)
    halves = torch.cat([fold.fold_parts_batch(s, b[:16], nbins, npart)[0],
                        fold.fold_parts_batch(s, b[16:], nbins, npart)[0]])
    alone = torch.cat([fold.fold_parts_batch(s, b[k:k + 1], nbins, npart)[0]
                       for k in range(K)])
    torch.cuda.synchronize()
    if not (torch.equal(halves, profs) and torch.equal(alone, profs)):
        fail("fold_parts_batch: a candidate's profile changes with its batch")
    done = []
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    rng = np.random.default_rng(SEED + 5)
    # (what, series, bins, nbins, npart): 50 bins; T not a multiple of
    # npart with an odd part_len (3125) and bin rows off a 16-byte
    # boundary at odd k; a view whose samples start 4 bytes past one; a
    # lone candidate; every sample in one bin; the largest nbins
    odd = torch.randn(100003, generator=gen, device=device)
    cases = [
        ("nbins 50", s, torch.from_numpy(fold_bins(
            series, dt, periods[::8], 50, npart)).to(device), 50, npart),
        ("T 100003, part_len 3125", odd, torch.from_numpy(rng.integers(
            0, nbins, (5, 100003), dtype=np.int32)).to(device), nbins, npart),
        ("series view at +1 float, npart 7", odd[1:100002], torch.from_numpy(
            rng.integers(0, nbins, (3, 100001), dtype=np.int32)).to(device),
         nbins, 7),
        ("K 1", s, b[13:14], nbins, npart),
        ("one bin", odd, torch.full((2, 100003), 17, dtype=torch.int32,
                                    device=device), nbins, npart),
        (f"nbins {fold.MAX_NBINS}", odd[:8000], torch.from_numpy(
            rng.integers(0, fold.MAX_NBINS, (2, 8000),
                         dtype=np.int32)).to(device), fold.MAX_NBINS, 2),
    ]
    for what, es, eb, enb, enp in cases:
        _, _, e_err = compare_fold(what, es, eb, enb, enp)
        done.append(f"{what}: {fold.launch_threads(enb)} threads, max abs "
                    f"err {e_err:.3g}")
    try:
        fold.fold_parts_batch(odd[:8000], torch.zeros(
            (1, 8000), dtype=torch.int32, device=device),
            fold.MAX_NBINS + 1, 2)
    except ValueError as e:
        done.append(f"nbins {fold.MAX_NBINS + 1} refused ({e})")
    else:
        fail("fold_parts_batch launched past its largest nbins")
    ms = cuda_time_ms(lambda: fold.fold_parts_batch(s, b, nbins, npart))
    single_ms = single_call_ms(
        lambda: fold.fold_parts_batch(s, b, nbins, npart))
    plain_ms = cuda_time_ms(
        lambda: fold._torch_fold_parts_batch(s, b, nbins, npart), reps=3)
    # the library yardstick: one index_add_ of the same sums into a flat
    # [K * npart * nbins] buffer from precomputed flat indices (profiles
    # only, float atomics: a time, not a port)
    P = T // npart
    t = torch.arange(npart * P, device=device)
    flat = ((torch.arange(K, device=device)[:, None] * npart + t // P) * nbins
            + b[:, :npart * P].long()).reshape(-1)
    src = s[:npart * P].repeat(K)
    buf = torch.zeros(K * npart * nbins, device=device)
    library_ms = cuda_time_ms(lambda: buf.index_add_(0, flat, src))
    buf.zero_().index_add_(0, flat, src)
    lib_err = float((buf.reshape(K, npart, nbins) - profs).abs().max())
    del flat, src, buf
    nbytes = 4.0 * K * T + 4.0 * T + 8.0 * K * npart * nbins
    bms, by = bound(nbytes, float(K) * npart * P)
    report.append(dict(
        name="fold_parts_batch", route="cuda",
        source="pypulsar_tpu_torch/ops/csrc/fold_parts.cu",
        replaces="pypulsar_tpu/fold/engine.py:323",
        shape=f"series [{T}], bin_idx [{K}, {T}], nbins {nbins}, npart "
              f"{npart}; {fold.launch_threads(nbins)} threads per block",
        max_abs_err=err, ms=ms, single_call_ms=single_ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=library_ms))
    print(f"fold_parts_batch: series [{T}] x {K} candidates -> [{K}x{npart}x"
          f"{nbins}]: kernel {ms:.3f} ms (single calls {single_ms:.3f} ms), "
          f"plain {plain_ms:.3f} ms, index_add_ {library_ms:.3f} ms (max abs "
          f"diff {lib_err:.3g}), bound {bms:.3f} ms ({by}: "
          f"{nbytes / 1e9:.4f} GB), max abs err {err:.3g}, counts exact; "
          f"batch of 32, 2 x 16 and alone: identical bits; "
          + "; ".join(done))
    del s, b, profs, counts, halves, alone, odd
    torch.cuda.empty_cache()


def harmonic_of(period, psr):
    """(k, true period at that harmonic) when ``period`` is the pulsar's
    or a harmonic of it, |P k / psr - 1| < 1e-3 with k or 1/k an integer
    <= 8; else None."""
    ratio = period / psr
    m = round(1.0 / ratio) if ratio < 1 else round(ratio)
    if not 1 <= m <= 8:
        return None
    k = m if ratio < 1 else 1.0 / m
    if abs(period * k / psr - 1.0) >= 1e-3:
        return None
    return k, psr / k


def fold_stage(tmp, fn, info, device, report):
    """Phase 7: sift -> foldbatch -> pfd_snr on the sweep stage's output at
    the survey's settings, the stream source over the same list, a second
    ``--datbase`` fold at batch 7, then a profiled ``--datbase`` fold.
    Returns the launches of the ``.dat`` and the stream folds."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.cli import foldbatch, pfd_snr, sift
    from pypulsar_tpu_torch.fold import profile_snr
    from pypulsar_tpu_torch.io.accelcands import parse_candlist
    from pypulsar_tpu_torch.io.prestopfd import PfdFile

    stage = os.path.join(tmp, "stage")
    dt = info["tsamp"]
    check_fold(device, report, f"{stage}_DM70.00.dat", dt)
    cand_files = sorted(glob.glob(f"{stage}_DM*_ACCEL_200.cand"))
    sifted = os.path.join(tmp, "fold.accelcands")
    t0 = time.perf_counter()
    rc = sift.main(cand_files + ["-s", "4", "--min-hits", "2", "-o", sifted])
    sift_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"sift exited {rc}")
    n_sifted = len(parse_candlist(sifted))
    if n_sifted == 0:
        fail("sift kept no candidate")
    fold_args = ["--cands", sifted, "-n", str(FOLD_NBINS), "--npart",
                 str(FOLD_NPART), "--device", "cuda"]

    def run_fold(out, extra):
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = foldbatch.main(fold_args + ["-o", out, *extra])
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        if rc != 0:
            fail(f"foldbatch {' '.join(extra)} exited {rc}")
        with open(f"{out}_foldbatch.json") as f:
            summary = json.load(f)
        return (summary, took, launch_counts(),
                torch.cuda.max_memory_allocated() / 1e9)

    dats = os.path.join(tmp, "fold_dats")
    summ, fold_dats_s, l_dats, peak_dats = run_fold(
        dats, ["--datbase", stage, "--batch", "32"])
    t0 = time.perf_counter()
    rc = pfd_snr.main([f"{dats}_*.pfd", "--json", dats + "_snr.json"])
    pfd_snr_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"pfd_snr exited {rc}")
    stream = os.path.join(tmp, "fold_stream")
    _, fold_stream_s, l_stream, peak_stream = run_fold(
        stream, [fn, "-s", "64", "--group-size", "0"])
    b7 = os.path.join(tmp, "fold_b7")
    run_fold(b7, ["--datbase", stage, "--batch", "7"])
    if min(l_dats["fold_parts_batch"], l_stream["fold_parts_batch"]) < 1:
        fail(f"a fold source launched no fold kernel: {l_dats}, {l_stream}")
    if min(l_stream["gather_sum/stage1"], l_stream["gather_sum/stage2"]) < 1:
        fail(f"the stream fold launched no gather-sum stage: {l_stream}")
    results = summ["results"]
    if len(results) != n_sifted or summ["n_folded"] != n_sifted:
        fail(f"{summ['n_folded']} of {n_sifted} sifted candidates folded")
    for r in results:
        for base in (dats, stream, b7):
            if not os.path.exists(f"{base}_{r['name']}.pfd"):
                fail(f"no archive {base}_{r['name']}.pfd")
        with open(f"{dats}_{r['name']}.pfd", "rb") as a, \
                open(f"{b7}_{r['name']}.pfd", "rb") as c:
            if a.read() != c.read():
                fail(f"{r['name']}: archive bytes differ between --batch 32 "
                     f"and --batch 7")
    with open(dats + "_snr.json") as f:
        snr = {row["name"]: row["snr"] for row in json.load(f)}
    psr = info["period_samples"] * dt
    T_sec = FOLD_NPART * (info["nsamp"] // FOLD_NPART) * dt
    hits = []
    for r in results:
        h = harmonic_of(r["period"], psr)
        if h is None or abs(r["dm"] - 70.0) > 2.0 or not snr[r["name"]]:
            continue
        step = 4.0 / 32 * r["period"] ** 2 / T_sec  # one grid step in P
        if snr[r["name"]] > 10 and abs(r["best_period"] - h[1]) <= step:
            hits.append(dict(name=r["name"], dm=r["dm"], period=r["period"],
                             harmonic=h[0], snr=snr[r["name"]],
                             best_period=r["best_period"], true_period=h[1],
                             grid_step=step))
    if not hits:
        fail("no sifted candidate within 2 DM of 70 at the pulsar's period "
             "or a harmonic (k <= 8) folds to SNR > 10 with a refined "
             "period within one grid step")
    row = max(hits, key=lambda h: h["snr"])
    row["snr_stream"] = float(profile_snr.pfd_snr(
        PfdFile(f"{stream}_{row['name']}.pfd"))["snr"])
    if not row["snr_stream"] > 10:
        fail(f"the stream source folds the pulsar to SNR "
             f"{row['snr_stream']:.2f}")
    groups = collections.Counter(r["dm"] for r in results)
    numbers = {
        "sifted": n_sifted, "dm_groups": len(groups),
        "cands_per_group": sorted(groups.values(), reverse=True),
        "sift_s": sift_s, "fold_dats_s": fold_dats_s,
        "fold_stream_s": fold_stream_s, "pfd_snr_s": pfd_snr_s,
        "cands_per_s": {"dats": n_sifted / fold_dats_s,
                        "stream": n_sifted / fold_stream_s},
        "peak_device_gb": {"dats": peak_dats, "stream": peak_stream},
        "launches": {"dats": l_dats, "stream": l_stream},
        "pulsar": row, "pulsar_rows_found": len(hits)}
    print("fold stage: " + json.dumps(numbers))
    profile_fold(fold_args + ["-o", os.path.join(tmp, "fold_prof"),
                              "--datbase", stage])
    return l_dats, l_stream


def profile_fold(argv):
    """One more ``--datbase`` fold under torch.profiler: device time of the
    fold kernel, of ``refine_chi2``'s ops and of copies, the host prep's
    wall time (on the prefetch worker) and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from pypulsar_tpu_torch.cli import foldbatch
    from pypulsar_tpu_torch.fold import engine
    from pypulsar_tpu_torch.parallel import foldpipe

    real_prep, real_refine = foldpipe._prep_group, engine.refine_chi2
    prep_s = [0.0]

    def prep(*a, **kw):
        t0 = time.perf_counter()
        out = real_prep(*a, **kw)
        prep_s[0] += time.perf_counter() - t0
        return out

    def refine(*a, **kw):
        with record_function("refine_chi2"):
            return real_refine(*a, **kw)

    foldpipe._prep_group, engine.refine_chi2 = prep, refine
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if foldbatch.main(argv) != 0:
                fail("profiled fold failed")
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        foldpipe._prep_group, engine.refine_chi2 = real_prep, real_refine
    kernel_ms = copy_ms = fold_ms = refine_ms = 0.0
    h2d_ms, fold_n = 0.0, 0
    top, by_op = [], collections.Counter()
    for ev in prof.key_averages():
        ms = ev.self_device_time_total / 1e3
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if ev.key == "refine_chi2":
                continue  # the annotation's span on the device timeline
            if "Memcpy" in ev.key or "Memset" in ev.key:
                copy_ms += ms
                h2d_ms += ms if "HtoD" in ev.key else 0.0
            else:
                kernel_ms += ms
                top.append((ev.key[:70], round(ms, 3), ev.count))
            if "fold_parts" in ev.key:
                fold_ms += ms
                fold_n += ev.count
        elif ev.key == "refine_chi2":
            refine_ms += ev.device_time_total / 1e3
        elif ms > 0:
            by_op[ev.key] += ms
    top.sort(key=lambda r: -r[1])
    print("fold profile: " + json.dumps({
        "wall_ms": wall_ms, "kernel_ms": kernel_ms, "copy_ms": copy_ms,
        "h2d_ms": h2d_ms, "fold_kernel_ms": fold_ms,
        "fold_launches": fold_n, "refine_chi2_ms": refine_ms,
        "other_kernels_ms": kernel_ms - fold_ms - refine_ms,
        "host_prep_s": prep_s[0],
        "idle_share": 1.0 - kernel_ms / wall_ms,
        "by_op_ms": dict(by_op.most_common(8)), "top_kernels": top[:8]}))


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "pypulsar_tpu_torch")):
        fail("run from a checkout: pypulsar_tpu_torch/ is not beside "
             "chip_smoke.py")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the card only")
    sys.path.insert(0, HERE)
    from pypulsar_tpu_torch.ops import _build

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    print(f"kernels built in {_build.build_all():.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    report = []
    ts, payload = check_gather(device, report)
    check_gather_edges(device)
    check_boxcar(device, report, ts, payload)
    del ts
    torch.cuda.empty_cache()
    check_small_accel(device)
    probe_batched_transforms(device)
    with tempfile.TemporaryDirectory() as tmp:
        check_small_sweep(tmp)
        fn, info = write_obs(tmp)
        check_stage_kernels(fn, device)
        launches, _ = main_path(tmp, fn, info)
        stage_sp, stage_series = stage_path(tmp, fn, info)
        fold_dats, fold_stream = fold_stage(tmp, fn, info, device, report)
    paths = {"sweep_1024_trials": launches,
             "stage_single_pulse_pass": stage_sp,
             "stage_series_pass": stage_series,
             "fold_dats": fold_dats, "fold_stream": fold_stream}
    for k in report:
        k["launches_by_path"] = {p: c.get(k["name"], 0)
                                 for p, c in paths.items()}
        # the first path that drives the kernel: the 1024-trial sweep for
        # the dedispersion kernels, the --datbase fold for the fold
        k["launches"] = (fold_dats if k["name"] == "fold_parts_batch"
                         else launches)[k["name"]]
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
