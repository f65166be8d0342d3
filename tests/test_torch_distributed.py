"""Several processes of the port (``parallel/distributed.py``,
``torch.distributed`` over gloo) on the CPU.

Contracts:
- a time-sharded sweep (flat, masked, downsampled, a DDplan's steps)
  merges to the single-process sweep with bit-identical peaks and SNR
  within 2e-6 relative (its float64 moment sums re-associate); the
  per-chunk peaks concatenate to the single sweep's;
- in one process the windows merge as in two; the port's merged windows
  meet the JAX package's merged windows within the sweep contract;
- two ranks over gloo give every rank the same result, the CLI's
  ``--time-shard --write-dats`` writes the single-process streamed
  writer's ``.dat`` bytes and the ``.cands``, and the multi-file sweep the per-file ``.cands`` of
  single runs and one merged table;
- a failed rendezvous raises; nothing falls back to one process.

The reference's ``test_local_rank_env_first`` has no counterpart: the
port reads no environment variable (its launcher grid is explicit).
"""

import glob
import json
import os
import socket
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from pypulsar_tpu.io import filterbank as jax_fb
from pypulsar_tpu.parallel import distributed as jax_dist
from pypulsar_tpu.parallel import sweep as jax_sweep
from pypulsar_tpu_torch.cli import rfifind as rfifind_cli
from pypulsar_tpu_torch.cli import sweep as cli
from pypulsar_tpu_torch.io.filterbank import FilterbankFile
from pypulsar_tpu_torch.io.rfimask import RfifindMask
from pypulsar_tpu_torch.io.synth import write_synthetic_fil
from pypulsar_tpu_torch.parallel import distributed as dist
from pypulsar_tpu_torch.parallel import staged, sweep
from tests.torch_hermetic import hermetic_tune_cache  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DMS = 10.0 * np.arange(8)
KW = dict(nsub=8, group_size=4, chunk_payload=1024)
CHILD_TIMEOUT_S = 240
#: a DDplan's two fields the staged sweeps read
DDPLAN = SimpleNamespace(DDsteps=[
    SimpleNamespace(downsamp=1, DMs=5.0 * np.arange(8)),
    SimpleNamespace(downsamp=2, DMs=40.0 + 10.0 * np.arange(4))])
CASES = {"flat": {}, "masked": {"mask": True}, "downsampled":
         {"downsamp": 2}}


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    fns = []
    for i, (dm, seed) in enumerate(((40.0, 3), (20.0, 5))):
        fn = str(d / f"f{i}.fil")
        write_synthetic_fil(fn, nchan=32, tsamp=5e-4, nsamp=9000,
                            fch1=1500.0, bw=128.0, dm=dm,
                            period_samples=300 + 50 * i, width=4, seed=seed)
        fns.append(fn)
    assert rfifind_cli.main([fns[0], "-o", str(d / "m"), "-t", "0.5",
                             "--device", "cpu"]) == 0
    return dict(dir=d, fns=fns, mask=str(d / "m_rfifind.mask"))


def _kw(files, case):
    extra = dict(CASES[case])
    mask = extra.pop("mask", False)
    return dict(KW, rfimask=RfifindMask(files["mask"]) if mask else None,
                **extra)


def _single(files, case):
    """The single-process sweep of file 0 for ``case``."""
    kw = _kw(files, case)
    with FilterbankFile(files["fns"][0]) as r:
        return staged.sweep_flat(r, DMS, device="cpu",
                                 keep_chunk_peaks=True,
                                 **kw).steps[0].result


def _assert_contract(got, ref):
    np.testing.assert_array_equal(got.peak_sample, ref.peak_sample)
    rel = np.abs(got.snr - ref.snr) / np.maximum(np.abs(ref.snr), 1.0)
    assert rel.max() <= 2e-6, f"SNR rel err {rel.max():.2e}"


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------


def test_the_grid_of_one_and_its_refusals():
    assert dist.initialize() is False and not dist.is_distributed()
    assert (dist.process_index(), dist.process_count()) == (0, 1)
    assert (dist.local_rank(), dist.local_count()) == (0, 1)
    assert dist.initialize("127.0.0.1:1", 1, 0) is False
    with pytest.raises(ValueError, match="coordinator"):
        dist.initialize(None, 2, 0)
    with pytest.raises(ValueError, match="num_processes"):
        dist.initialize("127.0.0.1:1", None, 0)
    with pytest.raises(ValueError, match="outside"):
        dist.initialize("127.0.0.1:1", 2, 2)
    dist.barrier()  # alone: no collective
    rows = np.arange(12.0).reshape(4, 3)
    np.testing.assert_array_equal(dist.allgather_candidates(rows, 6), rows)


def test_a_failed_rendezvous_raises():
    with pytest.raises(Exception):
        dist.initialize(f"127.0.0.1:{_free_port()}", 2, 1, timeout_s=2.0)
    assert not dist.is_distributed()


def test_shard_files_and_windows():
    files = [f"f{i}" for i in range(5)]
    assert dist.shard_files(files, 1, 2) == ["f1", "f3"]
    assert dist.shard_files(files, 0, 1) == files
    assert dist.shard_files(files[:1], 1, 2) == []
    with pytest.raises(ValueError, match="outside"):
        dist.shard_files(files, 2, 2)
    assert dist.time_shard_window(9000, 1024, 0, 2) == (0, 5120)
    assert dist.time_shard_window(9000, 1024, 1, 2) == (5120, 9000)
    assert dist.time_shard_window(1000, 1024, 1, 2) == (1000, 1000)


@pytest.mark.parametrize("count", (2, 3))
@pytest.mark.parametrize("case", sorted(CASES))
def test_windows_merge_to_the_single_sweep(files, case, count):
    ref = _single(files, case)
    parts = []
    with FilterbankFile(files["fns"][0]) as r:
        for rank in range(count):
            plan, local = dist.time_shard_local_accum(
                r, DMS, rank, count, device="cpu", keep_chunk_peaks=True,
                **_kw(files, case))
            parts.append(local)
    m = sweep.merge_accum_parts(parts)
    got = sweep.finalize_sweep(plan, m.n, m.s, m.ss, m.mb, m.ab,
                               m.baseline_sum, chunk_mb=list(m.chunk_mb),
                               chunk_ab=list(m.chunk_ab))
    _assert_contract(got, ref)
    np.testing.assert_array_equal(got.chunk_sample, ref.chunk_sample)
    # a grid other than the group's is refused, not merged short
    with pytest.raises(ValueError, match="process count"):
        dist._allgather_accums(parts[0], count)


def test_merged_windows_meet_the_jax_packages(files):
    fn = files["fns"][0]
    parts, jparts = [], []
    with FilterbankFile(fn) as r:
        for rank in range(2):
            plan, local = dist.time_shard_local_accum(r, DMS, rank, 2,
                                                      device="cpu", **KW)
            parts.append(local)
    jr = jax_fb.FilterbankFile(fn)
    try:
        for rank in range(2):
            jplan, jl = jax_dist.time_shard_local_accum(jr, DMS, rank, 2,
                                                        **KW)
            jparts.append(jl)
    finally:
        jr.close()
    m = sweep.merge_accum_parts(parts)
    got = sweep.finalize_sweep(plan, m.n, m.s, m.ss, m.mb, m.ab,
                               m.baseline_sum)
    jm = jax_sweep.merge_accum_parts(jparts)
    ref = jax_sweep.finalize_sweep(jplan, jm.n, jm.s, jm.ss, jm.mb, jm.ab,
                                   jm.baseline_sum)
    _assert_contract(got, ref)


# ---------------------------------------------------------------------------
# two processes over gloo
# ---------------------------------------------------------------------------

RUNNER = r"""
import json, sys
import numpy as np
from types import SimpleNamespace
from pypulsar_tpu_torch.cli import sweep as cli
from pypulsar_tpu_torch.io.filterbank import FilterbankFile
from pypulsar_tpu_torch.io.rfimask import RfifindMask
from pypulsar_tpu_torch.parallel import distributed as dist

cfg = json.loads(sys.argv[1])
rank, out = int(sys.argv[2]), cfg["out"]
assert dist.initialize(cfg["coord"], 2, rank, timeout_s=120.0)
dms = np.asarray(cfg["dms"])
kw = dict(nsub=8, group_size=4, chunk_payload=1024, device="cpu")
with FilterbankFile(cfg["fns"][0]) as r:
    for case, extra in (("flat", {}), ("downsampled", {"downsamp": 2}),
                        ("masked", {"rfimask": RfifindMask(cfg["mask"])})):
        res = dist.time_sharded_sweep(r, dms, keep_chunk_peaks=True,
                                      **kw, **extra)
        np.savez(f"{out}/r{rank}_{case}.npz", snr=res.snr,
                 peak=res.peak_sample, chunk=res.chunk_sample)
    plan = SimpleNamespace(DDsteps=[
        SimpleNamespace(downsamp=s["downsamp"], DMs=np.asarray(s["dms"]))
        for s in cfg["ddplan"]])
    st = dist.time_sharded_ddplan(r, plan, nsub=8, group_size=4,
                                  chunk_payload=1024, device="cpu")
    np.savez(f"{out}/r{rank}_ddplan.npz",
             **{f"snr{i}": s.result.snr for i, s in enumerate(st.steps)},
             **{f"peak{i}": s.result.peak_sample
                for i, s in enumerate(st.steps)})
sw = ["--lodm", "0", "--dmstep", "10", "--numdms", "8", "-s", "8",
      "--group-size", "4", "--chunk", "1024", "--device", "cpu"]
assert cli.main([cfg["fns"][0], "-o", f"{out}/ts", *sw, "--write-dats",
                 "--time-shard"]) == 0
assert cli.main([*cfg["fns"], "-o", f"{out}/mf", *sw]) == 0
assert dist.is_distributed()  # the CLI leaves a group it did not join
dist.barrier()
dist.shutdown()
print("RANK_DONE", rank)
"""


@pytest.fixture(scope="module")
def two_ranks(files):
    out = str(files["dir"] / "ranks")
    os.makedirs(out, exist_ok=True)
    cfg = json.dumps(dict(
        out=out, coord=f"127.0.0.1:{_free_port()}", fns=files["fns"],
        mask=files["mask"], dms=list(DMS),
        ddplan=[dict(downsamp=s.downsamp, dms=list(s.DMs))
                for s in DDPLAN.DDsteps]))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen([sys.executable, "-c", RUNNER, cfg, str(r)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a rank did not finish in time")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK_DONE {r}" in log, log[-3000:]
    return out


@pytest.mark.parametrize("rank", (0, 1))
@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_time_shard_meets_the_single_sweep(files, two_ranks,
                                                     case, rank):
    ref = _single(files, case)
    with np.load(f"{two_ranks}/r{rank}_{case}.npz") as z:
        got = SimpleNamespace(snr=z["snr"], peak_sample=z["peak"])
        chunk = z["chunk"]
    _assert_contract(got, ref)
    np.testing.assert_array_equal(chunk, ref.chunk_sample)
    with np.load(f"{two_ranks}/r{1 - rank}_{case}.npz") as z:
        np.testing.assert_array_equal(z["snr"], got.snr)  # every rank


def test_two_ranks_time_sharded_ddplan(files, two_ranks):
    with FilterbankFile(files["fns"][0]) as r:
        ref = staged.sweep_ddplan(r, DDPLAN, nsub=8, group_size=4,
                                  chunk_payload=1024, device="cpu")
    for rank in (0, 1):
        with np.load(f"{two_ranks}/r{rank}_ddplan.npz") as z:
            for i, st in enumerate(ref.steps):
                _assert_contract(SimpleNamespace(snr=z[f"snr{i}"],
                                                 peak_sample=z[f"peak{i}"]),
                                 st.result)


def test_two_ranks_cli_time_shard_writes_the_single_bytes(files, two_ranks,
                                                          tmp_path):
    one = str(tmp_path / "one")
    assert cli.main([files["fns"][0], "-o", one, "--lodm", "0", "--dmstep",
                     "10", "--numdms", "8", "-s", "8", "--group-size", "4",
                     "--chunk", "1024", "--device", "cpu"]) == 0
    # the time shards stream their windows: the single process's streamed
    # writer (the plain CLI streams only past the resident crossover)
    with FilterbankFile(files["fns"][0]) as reader:
        assert cli.write_dats_auto(
            one, reader, DMS, nsub=8, group_size=4, chunk_payload=1024,
            resident_limit=0, device="cpu") == "streamed"
    dats = sorted(glob.glob(one + "_DM*.dat"))
    assert len(dats) == 8
    for fn in dats:
        with open(fn, "rb") as a, \
                open(two_ranks + "/ts" + fn[len(one):], "rb") as b:
            assert a.read() == b.read(), fn
    for fn in sorted(glob.glob(one + "_DM*.inf")):
        # the same sidecars but their file names
        with open(fn) as a, open(two_ranks + "/ts" + fn[len(one):]) as b:
            assert a.readlines()[1:] == b.readlines()[1:], fn
    assert not glob.glob(two_ranks + "/ts_DM*.w*.dat")
    # the .cands rows: the same detections, SNR within the text's rounding
    got, want = (_cands(two_ranks + "/ts.cands"), _cands(one + ".cands"))
    assert [r[::2] for r in got] == [r[::2] for r in want]
    assert all(abs(a[1] - b[1]) <= 1.1e-3 for a, b in zip(got, want))


def _cands(path):
    with open(path) as f:
        return [tuple(float(x) for x in ln.split())
                for ln in f.read().splitlines()[1:]]


def test_two_ranks_multi_file_sweep(files, two_ranks, tmp_path):
    rows = []
    for i, fn in enumerate(files["fns"]):
        out = str(tmp_path / f"s{i}")
        assert cli.main([fn, "-o", out, "--lodm", "0", "--dmstep", "10",
                         "--numdms", "8", "-s", "8", "--group-size", "4",
                         "--chunk", "1024", "--device", "cpu"]) == 0
        with open(out + ".cands", "rb") as a, \
                open(os.path.splitext(fn)[0] + ".cands", "rb") as b:
            assert a.read() == b.read()
    with open(two_ranks + "/mf_merged.cands") as f:
        lines = f.read().splitlines()
    rows = [ln.split() for ln in lines[1:]]
    assert {r[-1] for r in rows} == set(files["fns"])
    snrs = [float(r[1]) for r in rows]
    assert snrs == sorted(snrs, reverse=True) and len(rows) == 16
