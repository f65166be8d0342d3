"""Host downsampling of the port's staged sweep (``parallel/staged.py``:
``host_downsample_wins``, ``host_ds_acc_dtype`` and the host-summed
blocks of ``downsampled_blocks``) on the CPU, against its own device path
and the JAX package.

Contracts:
- host sums are opt-in (``host_downsample=True``), and then taken where
  the reference's ``_host_downsample_wins`` takes them with its override
  set: one integer SIGPROC file of 16 bits or fewer, unmasked, 16-bit only
  up to factor 256; the accumulator is the reference's (uint16, or uint32
  for 16-bit samples and factors past 257);
- the host-summed blocks have the device path's positions and bits at
  factors 4 and 8 on 8-, 4- and 16-bit files, and what ships is one
  accumulator row per output sample;
- a sweep and a DDplan have the same bits either way, meet the JAX
  package's sweep within the sweep's tolerance, and a DDplan killed
  inside a host-downsampled step resumes to the uninterrupted bits.
"""

import os

import numpy as np
import pytest

from pypulsar_tpu.io import filterbank as jax_fb
from pypulsar_tpu.parallel import staged as jax_staged
from pypulsar_tpu_torch.io.filterbank import FilterbankFile, write_filterbank
from pypulsar_tpu_torch.io.rfimask import RfifindMask, write_mask
from pypulsar_tpu_torch.parallel import staged, sweep
from pypulsar_tpu_torch.plan.ddplan import Observation

C, DT = 32, 1e-3
FREQS = 1500.0 - 4.0 * np.arange(C)


class Killed(Exception):
    """The kill of a run under test."""


def _fil(path, nbits, T=8192, seed=0, ascending=False):
    """Integer noise with a dispersed pulse train at DM 60."""
    rng = np.random.default_rng(seed)
    hi, amp = {16: (40000, 9000), 8: (160, 60), 4: (12, 3)}[nbits]
    vals = rng.integers(0, hi, size=(T, C)).astype(np.int64)
    bins = np.round((4149.377593360996 * 60.0
                     * (FREQS ** -2.0 - FREQS.max() ** -2.0)) / DT)
    for t0 in range(500, T, 2300):
        for c in range(C):
            t = t0 + int(bins[c])
            vals[t:t + 4, c] += amp
    vals = np.minimum(vals, (1 << nbits) - 1)
    hdr = dict(nchans=C, tsamp=DT, fch1=1500.0, foff=-4.0, nbits=nbits,
               tstart=58000.0)
    if ascending:
        vals = vals[:, ::-1]
        hdr.update(fch1=1500.0 - 4.0 * (C - 1), foff=4.0)
    write_filterbank(path, hdr, vals)
    return path


def test_policy_is_the_references(tmp_path, monkeypatch):
    f8 = FilterbankFile(_fil(str(tmp_path / "a8.fil"), 8, T=1000))
    f16 = FilterbankFile(_fil(str(tmp_path / "a16.fil"), 16, T=1000))
    f4 = FilterbankFile(_fil(str(tmp_path / "a4.fil"), 4, T=1000))
    src8 = staged.ReaderSource(f8)
    wins = staged.host_downsample_wins
    assert not wins(src8, 4) and not wins(src8, 300)  # opt-in
    assert wins(src8, 4, True) and wins(src8, 8, True)
    assert wins(src8, 2, True) and wins(src8, 300, True)
    assert not wins(src8, 1, True) and not wins(src8, 4, False)
    src4 = staged.ReaderSource(f4)
    assert wins(src4, 4, True) and not wins(src4, 8)
    src16 = staged.ReaderSource(f16)
    assert wins(src16, 8, True) and wins(src16, 256, True)
    assert not wins(src16, 512, True)
    mfn = str(tmp_path / "m.mask")
    write_mask(mfn, nchan=C, nint=2, ptsperint=500, zap_chans=[3],
               zap_ints=[1])
    masked = staged.make_source(f8, RfifindMask(mfn), "cpu")
    assert not wins(masked, 8, True)
    # the reference with its override set is the port's opt-in
    monkeypatch.setenv("PYPULSAR_TPU_HOST_DOWNSAMP", "1")
    for nbits, factor in ((8, 2), (8, 4), (8, 257), (8, 258), (4, 4),
                          (4, 64), (16, 4), (16, 256), (16, 512)):
        assert staged.host_ds_acc_dtype(nbits, factor) is \
            jax_staged._host_ds_acc_dtype(nbits, factor)
        jsrc = jax_staged._ReaderSource(jax_fb.FilterbankFile(
            {8: f8, 4: f4, 16: f16}[nbits].filename))
        assert wins(staged.ReaderSource({8: f8, 4: f4, 16: f16}[nbits]),
                    factor, True) == \
            jax_staged._host_downsample_wins(jsrc, factor)
    for f in (f8, f16, f4):
        f.close()


def _shipped(monkeypatch):
    """(dtype, shape) of every host array the ship-ahead is handed."""
    real = staged.ship_ahead
    seen = []

    def ship_ahead(raw_blocks, device, depth=2):
        def record():
            for pos, block in raw_blocks:
                seen.append((block.dtype, block.shape))
                yield pos, block

        return real(record(), device, depth)

    monkeypatch.setattr(staged, "ship_ahead", ship_ahead)
    return seen


@pytest.mark.parametrize("ascending", [False, True])
@pytest.mark.parametrize("nbits,factor", [(8, 4), (8, 8), (4, 4), (4, 8),
                                          (16, 4), (16, 8)])
def test_host_blocks_are_the_device_blocks(tmp_path, monkeypatch, nbits,
                                           factor, ascending):
    """Same positions and bits as the device path (a ragged tail block
    included); the host ships one accumulator row per output sample, in
    the accumulator's dtype, where the device path ships native rows."""
    fn = _fil(str(tmp_path / "b.fil"), nbits, T=5003, seed=nbits + factor,
              ascending=ascending)
    payload, overlap = 301, 57
    with FilterbankFile(fn) as r:
        src = staged.ReaderSource(r)
        with monkeypatch.context() as m:
            host_ships = _shipped(m)
            host = list(staged.downsampled_blocks(src, factor, payload,
                                                  overlap, "cpu", True))
        with monkeypatch.context() as m:
            dev_ships = _shipped(m)
            dev = list(staged.downsampled_blocks(src, factor, payload,
                                                 overlap, "cpu", False))
    assert [p for p, _ in host] == [p for p, _ in dev]
    for (_, a), (_, b) in zip(host, dev):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.numpy(), b.numpy())
    acc = np.uint16 if nbits <= 8 else np.uint32
    assert {d for d, _ in host_ships} == {np.dtype(acc)}
    assert [s for _, s in host_ships] == [(b.shape[1], C) for _, b in dev]
    native = np.uint8 if nbits <= 8 else np.uint16
    assert {d for d, _ in dev_ships} == {np.dtype(native)}
    assert sum(np.prod(s) * np.dtype(acc).itemsize for _, s in host_ships) \
        < sum(np.prod(s) * np.dtype(native).itemsize for _, s in dev_ships)


def test_window_seam_check_on_the_host_path(tmp_path):
    fn = _fil(str(tmp_path / "w.fil"), 8, T=5000)
    with FilterbankFile(fn) as r:
        with pytest.raises(ValueError, match="whole multiple"):
            list(staged.downsampled_blocks(staged.ReaderSource(r, 0, 2500),
                                           4, 250, 30, "cpu", True))
        whole = list(staged.downsampled_blocks(staged.ReaderSource(r), 4,
                                               250, 30, "cpu", True))
        part = list(staged.downsampled_blocks(
            staged.ReaderSource(r, 2000, 4000), 4, 250, 30, "cpu", True))
    assert [p for p, _ in part] == [500, 750]
    for (p, b), (q, w) in zip(part, whole[2:4]):
        assert p == q and np.array_equal(b.numpy(), w.numpy())


@pytest.mark.parametrize("nbits,factor", [(8, 4), (8, 8), (4, 8)])
def test_sweep_flat_host_equals_device_and_meets_reference(tmp_path, nbits,
                                                           factor):
    """The port of the JAX package's host-downsample test: the host-summed
    sweep has the device path's bits, and meets the JAX sweep at the
    same downsampling (SNR rtol 5e-6 / atol 1e-4, the same peaks)."""
    fn = _fil(str(tmp_path / "s.fil"), nbits, seed=9)
    dms = np.linspace(0.0, 100.0, 12)
    kw = dict(downsamp=factor, nsub=8, group_size=4, chunk_payload=400)
    with FilterbankFile(fn) as r:
        assert staged.host_downsample_wins(staged.ReaderSource(r), factor,
                                           True)
        host = staged.sweep_flat(r, dms, device="cpu", host_downsample=True,
                                 **kw).steps[0].result
        dev = staged.sweep_flat(r, dms, device="cpu", **kw).steps[0].result
    for f in ("snr", "peak_sample", "mean", "std"):
        np.testing.assert_array_equal(getattr(host, f), getattr(dev, f),
                                      err_msg=f)
    ref = jax_staged.sweep_flat(jax_fb.FilterbankFile(fn), dms,
                                engine="gather", **kw).steps[0].result
    np.testing.assert_allclose(host.snr, ref.snr, rtol=5e-6, atol=1e-4)
    np.testing.assert_array_equal(host.peak_sample, ref.peak_sample)
    np.testing.assert_allclose(host.mean, ref.mean, rtol=1e-6)


def test_series_chunks_host_equal_device(tmp_path):
    fn = _fil(str(tmp_path / "c.fil"), 8, seed=4)
    dms = np.linspace(0.0, 100.0, 8)
    kw = dict(downsamp=4, nsub=8, group_size=4, chunk_payload=500,
              device="cpu")
    with FilterbankFile(fn) as r:
        host = list(staged.iter_device_chunks(r, dms, host_downsample=True,
                                              **kw))
        dev = list(staged.iter_device_chunks(r, dms, **kw))
    assert len(host) == len(dev) > 1
    for (p, v, a), (q, w, b) in zip(host, dev):
        assert (p, v) == (q, w) and np.array_equal(a.numpy(), b.numpy())


def _ddplan():
    """Steps at downsampling 1, 2 and 4 over the 32-channel band."""
    obs = Observation(dt=DT, fctr=float(FREQS.mean()),
                      BW=float(FREQS.max() - FREQS.min() + 4.0), numchan=C)
    plan = obs.gen_ddplan(0.0, 800.0)
    assert [int(s.downsamp) for s in plan.DDsteps] == [1, 2, 4]
    return plan


def _same_steps(got, ref):
    assert len(got.steps) == len(ref.steps)
    for a, b in zip(got.steps, ref.steps):
        assert (a.downsamp, a.dt) == (b.downsamp, b.dt)
        for f in ("snr", "peak_sample", "mean", "std"):
            np.testing.assert_array_equal(getattr(a.result, f),
                                          getattr(b.result, f), err_msg=f)


def test_ddplan_killed_inside_a_host_step_resumes_bit_identical(
        tmp_path, monkeypatch):
    """The DDplan's downsamp-4 step is host-summed on request; killed
    after its second checkpoint save, the resume loads steps 0 and 1
    from their markers, re-roots step 2 at its cursor (its first host
    block starts there) and ends with the uninterrupted bits, which are
    also the device path's."""
    fn = _fil(str(tmp_path / "d.fil"), 8, T=16384, seed=12)
    kw = dict(nsub=8, group_size=4, chunk_payload=600, device="cpu",
              host_downsample=True)
    base = str(tmp_path / "stg")
    plan = _ddplan()
    with FilterbankFile(fn) as r:
        ref = staged.sweep_ddplan(r, plan, **kw)
        _same_steps(ref, staged.sweep_ddplan(r, plan, **dict(
            kw, host_downsample=False)))
        real_save = sweep.SweepCheckpoint.save
        saves = []

        def save(self, *a, **k):
            real_save(self, *a, **k)
            if self.path.endswith(".step2.npz"):
                saves.append(self.path)
                if len(saves) == 2:
                    raise Killed()

        with monkeypatch.context() as m:
            m.setattr(sweep.SweepCheckpoint, "save", save)
            with pytest.raises(Killed):
                staged.sweep_ddplan(r, plan, checkpoint_path=base,
                                    checkpoint_every=1, **kw)
        with np.load(base + ".step2.npz") as z:
            cursor = int(z["cursor"])
        assert cursor == 2 * 600
        starts = []
        real_host = staged._host_downsampled_blocks

        def host_blocks(src, factor, *a):
            starts.append((factor, src.start))
            return real_host(src, factor, *a)

        with monkeypatch.context() as m:
            m.setattr(staged, "_host_downsampled_blocks", host_blocks)
            got = staged.sweep_ddplan(r, plan, checkpoint_path=base,
                                      checkpoint_every=1, **kw)
    assert starts == [(4, 4 * cursor)]
    _same_steps(got, ref)
    assert not [f for f in os.listdir(tmp_path) if f.startswith("stg")]
