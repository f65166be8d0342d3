#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``pypulsar_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result lines):

1. the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of every CUDA kernel of the sweep (one ``nvcc``
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
   of stage 1, of stage 2, boxcar) must have been launched by that run.

Then one JSON line of per-kernel numbers, the card line, and the last
line ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

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


def main_path(tmp):
    """The CLI's entry point on the full-width file; returns its numbers."""
    import torch

    from pypulsar_tpu_torch.cli import sweep as cli
    from pypulsar_tpu_torch.io.synth import write_synthetic_fil
    from pypulsar_tpu_torch.ops.boxcar_stats import boxcar_stats
    from pypulsar_tpu_torch.ops.gather_sum import shifted_gather_sum

    fn = os.path.join(tmp, "obs.fil")
    t0 = time.perf_counter()
    info = write_synthetic_fil(fn, nchan=1024, tsamp=64e-6, nsamp=1 << 20,
                               fch1=1500.0, bw=300.0, dm=70.0,
                               period_samples=4096, width=8, nbits=8,
                               seed=SEED)
    print(f"wrote {info['nsamp']} x {info['nchan']} 8-bit samples "
          f"({os.path.getsize(fn) / 1e9:.3f} GB) in "
          f"{time.perf_counter() - t0:.1f} s")
    out = os.path.join(tmp, "obs")
    argv = [fn, "--lodm", "0", "--dmstep", "0.5", "--numdms", "1024",
            "--nsub", "64", "-o", out, "--device", "cuda"]
    shifted_gather_sum.launches.clear()
    boxcar_stats.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"gather_sum/stage1": shifted_gather_sum.launches["stage1"],
                "gather_sum/stage2": shifted_gather_sum.launches["stage2"],
                "boxcar_stats": boxcar_stats.launches}
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
    with tempfile.TemporaryDirectory() as tmp:
        check_small_sweep(tmp)
        launches, _ = main_path(tmp)
    for k in report:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
