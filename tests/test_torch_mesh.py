"""Meshes and leases of the port (``parallel/mesh.py``) and the sweep's
sharded paths on the CPU: several mesh positions naming the one CPU
device, as a machine with one card names it several times.

Contracts:
- the 'dm'-sharded rows (SNR, peak samples, means) are bit-identical to
  the port's single-device rows at k = 1, 2, 4 and 8 on every engine, and
  the single-device rows meet JAX's single-device gather sweep within the
  sweep contract (2e-6 relative SNR, identical peaks); JAX's own sharded
  tests are no oracle (ROADMAP Queue 3);
- ``pad_groups_to`` and the mesh's padding change no real row;
- the 2-D 'dm' x 'time' mesh and ``sweep_ddplan_2d``: peaks bit-identical
  to the 1-D sweep at a payload of one time shard, SNR within 2e-6;
- the stream, spectral and tree-spectral handoffs write the
  single-device ``.cand`` bytes at k = 2 and 4;
- ``accel_search_batch(devices=)`` returns the unsharded candidates;
- a mesh wider than the lease or the host raises.
"""

import glob
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pypulsar_tpu.core.spectra import Spectra
from pypulsar_tpu.parallel import sweep as jax_sweep
from pypulsar_tpu_torch.fourier.accelsearch import (
    AccelSearchConfig,
    accel_search_batch,
)
from pypulsar_tpu_torch.io.filterbank import FilterbankFile
from pypulsar_tpu_torch.io.synth import write_synthetic_fil
from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.ops import tree_dedisperse as tdd
from pypulsar_tpu_torch.parallel import accelpipe, mesh, staged, sweep

ENGINES = ("gather", "scan", "tree", "fourier")
KS = (1, 2, 4, 8)
CPU = torch.device("cpu")


def _cpu_mesh(*sizes, names=("dm",)):
    return mesh.make_mesh(list(sizes), names,
                          devices=["cpu"] * int(np.prod(sizes)))


def _pulsed(C=32, T=2000, dt=1e-3, seed=7):
    rng = np.random.default_rng(seed)
    freqs = (1500.0 - 2.0 * np.arange(C)).astype(np.float64)
    data = rng.standard_normal((C, T)).astype(np.float32) + np.float32(96.0)
    bins = np.round((4149.377593360996 * 40.0 * (freqs ** -2.0
                                                 - freqs.max() ** -2.0))
                    / dt).astype(int)
    for c in range(C):
        if 700 + bins[c] < T:
            data[c, 700 + bins[c]] += 6.0
    return freqs, dt, data


DMS = np.linspace(0.0, 76.0, 12)  # 3 groups of 4: padded for k = 2, 4, 8
KW = dict(nsub=8, group_size=4, chunk_payload=700, device="cpu")


@pytest.fixture(scope="module")
def single():
    """The port's single-device rows of every engine."""
    freqs, dt, data = _pulsed()
    return {e: sweep.sweep_spectra(data, freqs, dt, DMS, engine=e, **KW)
            for e in ENGINES}


# ---------------------------------------------------------------------------
# meshes and leases
# ---------------------------------------------------------------------------


def test_mesh_axes_positions_and_ids():
    m = _cpu_mesh(2, 3, names=("dm", "time"))
    assert dict(m.shape) == {"dm": 2, "time": 3} and m.shape["dm"] == 2
    assert m.size == 6 and m.axis_devices("dm") == [CPU, CPU]
    assert m.axis_ids("time", dm=1) == [3, 4, 5]
    assert m.axis_ids("dm", time=2) == [2, 5]
    with pytest.raises(ValueError, match="multiply"):
        mesh.make_mesh([4], ("dm",), devices=["cpu"] * 3)
    one = _cpu_mesh(3)
    assert dict(one.shape) == {"dm": 3} and list(one.ids.flat) == [0, 1, 2]


def test_lease_devices_resolution_and_refusals():
    # outside a lease the CPU host offers its one device
    assert mesh.current_lease() is None and mesh.lease_device_ids() is None
    assert mesh.lease_devices(1, "cpu") == [CPU]
    with pytest.raises(ValueError, match="lease"):
        mesh.lease_devices(2, "cpu")
    with pytest.raises(ValueError, match="lease"):
        mesh.gang_mesh(2, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.lease_devices(1)
    # a lease may name one device several times; a mesh past it raises
    with mesh.device_lease(["cpu"] * 3, ids=[5, 6, 7]):
        assert mesh.lease_devices() == [CPU] * 3
        assert mesh.lease_device_ids() == [5, 6, 7]
        g = mesh.gang_mesh(2, "cpu")
        assert g.axis_ids("dm") == [5, 6]  # the lease ids, not an index
        with pytest.raises(ValueError, match="only 3"):
            mesh.lease_devices(4, "cpu")
        with mesh.device_lease(["cpu"]):  # an inner lease shadows
            assert mesh.lease_devices() == [CPU]
        assert mesh.lease_device_ids() == [5, 6, 7]
    assert mesh.current_lease() is None
    with pytest.raises(ValueError, match="lease ids"):
        with mesh.device_lease(["cpu"] * 2, ids=[1]):
            pass


def test_replicate_copies_once_per_distinct_device_and_gathers_in_order():
    x = torch.arange(6.0).reshape(2, 3)
    reps = mesh.replicate(x, [CPU, CPU, CPU])
    assert all(r is x for r in reps)
    assert mesh.device_key("cpu") == mesh.device_key(CPU)
    got = mesh.gather_rows([(x, x + 1), (x + 2, x + 3)], CPU)
    assert torch.equal(got[0], torch.cat([x, x + 2]))
    assert torch.equal(got[1], torch.cat([x + 1, x + 3]))


@pytest.mark.parametrize("source", ["host", "card0"])
def test_replicate_counts_only_host_copies_in_h2d_bytes(monkeypatch, source):
    """Two fake cards (``cuda:0``/``cuda:1`` keys over CPU tensors): a
    host block crosses to each distinct card once in ``h2d.bytes``; a
    block already on card 0 reaches card 1 in ``d2d.bytes`` only."""
    def key(d):
        d = str(d)
        if d == "cpu":
            return ("cuda", 0) if source == "card0" else ("cpu", None)
        return ("cuda", int(d.split(":")[1]))

    monkeypatch.setattr(mesh, "device_key", key)
    monkeypatch.setattr(mesh, "_norm", lambda d: CPU)
    x = torch.zeros(4, 8)
    nbytes = x.numel() * x.element_size()
    with telemetry.session() as tlm:
        reps = mesh.replicate(x, ["cuda:0", "cuda:1", "cuda:0", "cuda:1"])
        totals = tlm.counter_totals()
    assert len(reps) == 4 and reps[0] is reps[2] and reps[1] is reps[3]
    if source == "host":
        assert totals.get("h2d.bytes") == 2 * nbytes
        assert "d2d.bytes" not in totals
    else:
        assert "h2d.bytes" not in totals
        assert totals.get("d2d.bytes") == nbytes


def test_device_health_quarantine_keeps_a_host_usable():
    h = mesh.reset_device_health(limit=1)
    assert mesh.device_health() is h
    cuda = [torch.device("cuda", i) for i in range(2)]
    h.strike(0, kind="oom")
    assert mesh.healthy_devices(cuda) == [cuda[1]]
    h.strike(1, kind="oom")
    assert mesh.healthy_devices(cuda) == cuda  # degraded beats dead
    assert mesh.healthy_devices([CPU]) == [CPU]
    mesh.reset_device_health()


# ---------------------------------------------------------------------------
# sharded rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_single_device_rows_meet_the_jax_gather_sweep(single, engine):
    freqs, dt, data = _pulsed()
    ref = jax_sweep.sweep_spectra(Spectra(freqs, dt, data), DMS, nsub=8,
                                  group_size=4, chunk_payload=700,
                                  engine="gather")
    got = single[engine]
    rel = np.abs(got.snr - ref.snr) / np.maximum(np.abs(ref.snr), 1.0)
    assert rel.max() <= 2e-6, f"{engine}: SNR rel err {rel.max():.2e}"
    np.testing.assert_array_equal(got.peak_sample, ref.peak_sample)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("engine", ENGINES)
def test_sharded_rows_are_the_single_device_bits(single, engine, k):
    freqs, dt, data = _pulsed()
    got = sweep.sweep_spectra(data, freqs, dt, DMS, engine=engine,
                              mesh=_cpu_mesh(k), **KW)
    one = single[engine]
    for f in ("snr", "peak_sample", "mean", "std"):
        np.testing.assert_array_equal(getattr(got, f), getattr(one, f), f)
    assert got.engine_info["mesh_dm"] == k


@pytest.mark.parametrize("k", (2, 4))
def test_sweep_resident_on_a_mesh_with_padded_groups(single, k):
    freqs, dt, data = _pulsed()
    kw = dict(KW, chunk_payload=500)
    got = sweep.sweep_resident(torch.from_numpy(data), freqs, dt, DMS,
                               mesh=_cpu_mesh(k), pad_groups_to=2 * k + 4,
                               **kw)
    one = sweep.sweep_resident(torch.from_numpy(data), freqs, dt, DMS, **kw)
    np.testing.assert_array_equal(got.snr, one.snr)
    np.testing.assert_array_equal(got.peak_sample, one.peak_sample)
    assert got.snr.shape == (len(DMS), 6)


def test_pad_groups_to_repeats_the_last_dm_and_is_checked():
    freqs, dt, _ = _pulsed()
    p = sweep.make_sweep_plan(DMS, freqs, dt, nsub=8, group_size=4,
                              pad_groups_to=8)
    assert p.n_groups == 8 and p.n_real_trials == 12
    assert np.all(p.dms[12:] == DMS[-1])
    with pytest.raises(ValueError, match="pad_groups_to"):
        sweep.make_sweep_plan(DMS, freqs, dt, nsub=8, group_size=4,
                              pad_groups_to=2)
    assert sweep.padded_group_count(5, 4) == 8
    assert sweep.mesh_pad_groups(12, 4, None) is None
    assert sweep.mesh_pad_groups(12, 4, _cpu_mesh(2)) == 4
    # a group count that does not divide the mesh is refused
    with pytest.raises(ValueError, match="divide"):
        sweep.ShardedChunkEngine(_cpu_mesh(2), "gather", p.stage1_bins[:3],
                                 p.stage2_bins[:3], 8, 100, 10, 200)


@pytest.mark.parametrize("engine", ENGINES)
def test_sharded_chunk_factories_are_the_single_device_kernels(engine):
    freqs, dt, data = _pulsed(T=1200)
    p = sweep.make_sweep_plan(DMS, freqs, dt, nsub=8, group_size=4,
                              pad_groups_to=4)
    x = torch.from_numpy(data - data.mean(axis=1, keepdims=True))
    out_len = 700 + 32
    m = _cpu_mesh(4)
    got = sweep.make_sharded_sweep_chunk(
        m, 8, out_len, p.max_shift2, p.widths, 700, engine)(
            x, p.stage1_bins, p.stage2_bins)
    want = sweep.sweep_chunk(x, p.stage1_bins, p.stage2_bins, 8, out_len,
                             p.max_shift2, p.widths, 700, engine=engine)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ser = sweep.make_sharded_series_chunk(m, 8, out_len, p.max_shift2,
                                          engine)(x, p.stage1_bins,
                                                  p.stage2_bins)
    assert torch.equal(ser, sweep.dedisperse_series_chunk(
        x, p.stage1_bins, p.stage2_bins, 8, out_len, p.max_shift2,
        engine=engine))


def test_sharded_tree_plans_split_the_groups():
    freqs, dt, data = _pulsed(T=1200)
    p = sweep.make_sweep_plan(DMS, freqs, dt, nsub=8, group_size=4,
                              pad_groups_to=6)
    x = torch.from_numpy(data)
    ser = tdd.make_sharded_tree_series_chunk(_cpu_mesh(3), 700)(
        x, p.stage1_bins, p.stage2_bins)
    assert torch.equal(ser, tdd.dedisperse_series_tree(
        x, p.stage1_bins, p.stage2_bins, 700))
    got = tdd.make_sharded_tree_sweep_chunk(_cpu_mesh(3), 700, p.widths,
                                            600)(x, p.stage1_bins,
                                                 p.stage2_bins)
    want = tdd.sweep_chunk_tree(x, p.stage1_bins, p.stage2_bins, 700,
                                p.widths, 600)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # each position's engine holds the tree plan of its own groups
    eng = sweep.ShardedChunkEngine(_cpu_mesh(3), "tree", p.stage1_bins,
                                   p.stage2_bins, 8, 100, 10, 200)
    assert [s.tree.plan.n_trials for s in eng.shards] == [8, 8, 8]
    assert eng.info()["mesh_dm"] == 3
    with pytest.raises(ValueError, match="divide"):
        sweep.ShardedChunkEngine(_cpu_mesh(4), "tree", p.stage1_bins,
                                 p.stage2_bins, 8, 100, 10, 200)


@pytest.mark.parametrize("nd,nt", [(1, 2), (2, 2), (4, 3)])
def test_dm_time_mesh_peaks_bit_identical_snr_within_2e6(nd, nt):
    freqs, dt, data = _pulsed()
    T = 2000
    lp = T // nt
    p = sweep.make_sweep_plan(DMS, freqs, dt, nsub=8, group_size=4,
                              pad_groups_to=sweep.padded_group_count(3, nd))
    x = torch.from_numpy(data)[:, :lp * nt]
    base = x.mean(dim=1, keepdim=True)
    fn = sweep.make_sharded_sweep_chunk_2d(
        _cpu_mesh(nd, nt, names=("dm", "time")), 8, lp, p.min_overlap,
        p.max_shift2, p.widths)
    s, ss, mb, ab = fn(x - base, p.stage1_bins, p.stage2_bins)
    got = sweep.finalize_sweep(p, lp * nt, s, ss, mb, ab,
                               float(base.double().sum()))
    ref = sweep.sweep_spectra(x, freqs, dt, DMS, nsub=8, group_size=4,
                              chunk_payload=lp, device="cpu")
    np.testing.assert_array_equal(got.peak_sample, ref.peak_sample)
    rel = np.abs(got.snr - ref.snr) / np.maximum(np.abs(ref.snr), 1.0)
    assert rel.max() <= 2e-6
    with pytest.raises(ValueError, match="tree"):
        sweep.make_sharded_sweep_chunk_2d(
            _cpu_mesh(nd, nt, names=("dm", "time")), 8, lp, p.min_overlap,
            p.max_shift2, p.widths, engine="tree")


def test_sweep_ddplan_2d_meets_the_1d_sweep_of_each_step(tmp_path):
    fn = str(tmp_path / "d.fil")
    write_synthetic_fil(fn, nchan=32, tsamp=5e-4, nsamp=1 << 12,
                        fch1=1500.0, bw=128.0, dm=30.0, period_samples=512,
                        width=4, seed=9)
    # the two fields the staged sweeps read of a DDplan's steps
    plan = SimpleNamespace(DDsteps=[
        SimpleNamespace(downsamp=1, DMs=5.0 * np.arange(8)),
        SimpleNamespace(downsamp=2, DMs=40.0 + 10.0 * np.arange(6))])
    m = _cpu_mesh(2, 2, names=("dm", "time"))
    with FilterbankFile(fn) as r:
        got = staged.sweep_ddplan_2d(r, plan, m, nsub=8, group_size=2)
        src = staged.ReaderSource(r)
        for step, sr in zip(plan.DDsteps, got.steps):
            f = int(step.downsamp)
            n_ds = src.nsamples // f
            lp = n_ds // 2
            x = torch.cat([b for _, b in staged.downsampled_blocks(
                src, f, n_ds, 0, CPU)], dim=1)[:, :2 * lp]
            ref = sweep.sweep_spectra(x, src.frequencies, src.tsamp * f,
                                      step.DMs, nsub=8, group_size=2,
                                      chunk_payload=lp, device="cpu")
            res = sr.result
            np.testing.assert_array_equal(res.peak_sample, ref.peak_sample)
            rel = np.abs(res.snr - ref.snr) / np.maximum(np.abs(ref.snr), 1)
            assert rel.max() <= 2e-6
            np.testing.assert_allclose(res.mean, ref.mean, rtol=1e-6)


# ---------------------------------------------------------------------------
# the handoffs and the batch search
# ---------------------------------------------------------------------------

CFG = AccelSearchConfig(zmax=8.0, numharm=2, sigma_min=3.0)


@pytest.fixture(scope="module")
def obs_fil(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_handoff")
    fn = str(d / "h.fil")
    write_synthetic_fil(fn, nchan=32, tsamp=5e-4, nsamp=1 << 12,
                        fch1=1500.0, bw=128.0, dm=40.0, period_samples=256,
                        width=4, seed=3)
    return d, fn


HANDOFFS = {"stream": dict(engine="gather"),
            "spectral": dict(engine="gather", spectral=True),
            "tree_spectral": dict(engine="tree", spectral=True)}


def _handoff(d, fn, kind, k):
    tag = str(d / f"{kind}_k{k}")
    with FilterbankFile(fn) as r:
        summary = accelpipe.sweep_accel_stream(
            r, 10.0 * np.arange(6), CFG, tag, batch=3, nsub=8,
            group_size=2, device="cpu",
            mesh=None if k == 0 else _cpu_mesh(k), **HANDOFFS[kind])
    assert summary["n_searched"] == 6 and summary["serial_fallbacks"] == 0
    return tag


@pytest.mark.parametrize("k", (2, 4))
@pytest.mark.parametrize("kind", sorted(HANDOFFS))
def test_handoff_cand_bytes_do_not_depend_on_k(obs_fil, kind, k):
    d, fn = obs_fil
    one = str(d / f"{kind}_k0")
    if not os.path.exists(one + "_DM50.00_ACCEL_8.cand"):
        _handoff(d, fn, kind, 0)
    tag = _handoff(d, fn, kind, k)
    want = sorted(glob.glob(one + "_DM*_ACCEL_8.*cand"))
    assert len(want) == 12
    for w in want:
        with open(w, "rb") as a, open(tag + w[len(one):], "rb") as b:
            assert a.read() == b.read(), w


def test_accel_search_batch_over_devices_and_its_refusals():
    rng = np.random.default_rng(1)
    n = 2048
    t = np.arange(2 * (n - 1))
    series = rng.standard_normal((4, t.size)) + 0.3 * np.sin(
        2 * np.pi * 0.05 * t)[None]
    spec = np.fft.rfft(series, axis=1)
    spec /= np.sqrt(np.mean(np.abs(spec[:, 1:]) ** 2, axis=1,
                            keepdims=True))
    spec = spec.astype(np.complex64)
    T = float(t.size) * 1e-3
    one = accel_search_batch(spec, T, CFG, device="cpu")
    for k in (2, 4):
        got = accel_search_batch(spec, T, CFG, device="cpu",
                                 devices=["cpu"] * k)
        assert got == one
    with mesh.device_lease(["cpu"] * 2):
        assert accel_search_batch(spec, T, CFG, device="cpu",
                                  devices=mesh.lease_devices(2, "cpu")) \
            == one
    with pytest.raises(ValueError, match="divisible"):
        accel_search_batch(spec[:3], T, CFG, device="cpu",
                           devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="lease"):
        accel_search_batch(spec, T, CFG, device="cpu",
                           devices=mesh.lease_devices(2, "cpu"))
