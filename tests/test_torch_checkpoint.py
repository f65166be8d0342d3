"""Kill and resume of the port's sweep on the CPU:
``parallel/sweep.py``'s ``SweepCheckpoint``, ``parallel/staged.py``'s
seek-resume (``ReaderSource(start=)``, ``reroot_source``) and DDplan step
markers, and ``cli.sweep --checkpoint/--resume``.

Contracts:
- a sweep killed mid-stream (a block source that raises, or a kill right
  after a checkpoint save) and resumed has the uninterrupted port sweep's
  bits: SNR, peaks, mean and std and, with chunk peaks, every chunk's SNR
  and start (the gather, tree and fourier engines; flat and DDplan);
- a resume re-roots the stream at the checkpoint's cursor: its first
  block starts there (``.fil``, 4-bit PSRFITS, a two-file
  ``FilterbankObs``, a masked ``.fil``), and no earlier chunk is swept;
- a checkpoint of other parameters, engine or chunk-peak setting, and a
  corrupt one, start the sweep from scratch; a DDplan marker written for
  another input (the probe of its first samples) is not loaded;
- the resumed CLI's ``.cands`` have the uninterrupted CLI's bytes and meet
  the JAX package's uninterrupted ``cli.sweep`` (SNR within 2e-6 relative
  plus the print's last digit, the same peaks or float64-proven ties:
  ``tests/test_torch_sweep.py``'s rule).
"""

import os
import shutil

import numpy as np
import pytest

from pypulsar_tpu.cli import sweep as jax_cli
from pypulsar_tpu_torch.cli import sweep as cli
from pypulsar_tpu_torch.io.fbobs import FilterbankObs
from pypulsar_tpu_torch.io.filterbank import FilterbankFile, write_filterbank
from pypulsar_tpu_torch.io.psrfits import PsrfitsFile
from pypulsar_tpu_torch.io.rfimask import RfifindMask, write_mask
from pypulsar_tpu_torch.parallel import staged, sweep
from pypulsar_tpu_torch.plan.ddplan import Observation
from tests.torch_hermetic import hermetic_tune_cache  # noqa: F401

C, DT = 32, 1e-3
FREQS = 1500.0 - 4.0 * np.arange(C)


class Killed(Exception):
    """The kill of a run under test."""


def _data(T, seed):
    """[C, T] float32 noise with per-channel offsets (a resume that took
    another baseline would change bits) and two pulses."""
    rng = np.random.default_rng(seed)
    data = (rng.standard_normal((C, T))
            + rng.uniform(0.0, 50.0, (C, 1))).astype(np.float32)
    data[:, T // 9] += 4.0
    data[:, 5 * T // 8] += 4.0
    return data


def _blocks(data, plan, payload, start=0):
    ov = plan.min_overlap
    T = data.shape[1]
    for pos in range(start, T, payload):
        yield pos, data[:, pos:pos + min(payload + ov, T - pos)]


def _killing(blocks, n):
    for i, item in enumerate(blocks):
        if i >= n:
            raise Killed()
        yield item


def _assert_same(got, ref, peaks=False):
    for f in ("snr", "peak_sample", "mean", "std"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    if peaks:
        np.testing.assert_array_equal(got.chunk_snr, ref.chunk_snr)
        np.testing.assert_array_equal(got.chunk_sample, ref.chunk_sample)


def _cursor(path):
    with np.load(path) as z:
        return int(z["cursor"])


@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("engine", ["gather", "tree", "fourier"])
def test_killed_stream_resumes_bit_identical(tmp_path, engine, keep):
    """The reference's tests/test_sweep.py kill-and-resume cases on the
    port: 14 trials padded to 16 (real rows are checkpointed), 8 chunks,
    killed with 3 drained; the resumed stream is re-rooted at the
    cursor."""
    T, payload = 15000, 2048
    data = _data(T, seed=11)
    plan = sweep.make_sweep_plan(np.linspace(0.0, 60.0, 14), FREQS, DT,
                                 nsub=8, group_size=4)
    kw = dict(engine=engine, device="cpu", keep_chunk_peaks=keep)
    ref = sweep.sweep_stream(plan, _blocks(data, plan, payload), payload,
                             **kw)
    ck = str(tmp_path / "s.ckpt.npz")
    with pytest.raises(Killed):
        sweep.sweep_stream(plan, _killing(_blocks(data, plan, payload), 6),
                           payload, checkpoint=sweep.SweepCheckpoint(ck, 1),
                           **kw)
    cursor = _cursor(ck)
    assert cursor == 3 * payload
    seen = []

    def factory(at):
        for pos, block in _blocks(data, plan, payload, start=at):
            seen.append(pos)
            yield pos, block

    got = sweep.sweep_stream(plan, _blocks(data, plan, payload), payload,
                             checkpoint=sweep.SweepCheckpoint(ck, 1),
                             block_factory=factory, **kw)
    assert seen[0] == cursor
    _assert_same(got, ref, peaks=keep)
    if keep:
        assert got.events(4.0) == ref.events(4.0)
        assert len({e["sample"] // payload for e in ref.events(4.0)}) >= 2
    assert not os.path.exists(ck)


def test_resume_without_a_factory_skips_accumulated_chunks(tmp_path):
    """Without a factory the stream replays from its start and the chunks
    before the cursor are skipped (the backstop): the same bits."""
    T, payload = 12000, 2048
    data = _data(T, seed=12)
    plan = sweep.make_sweep_plan(np.linspace(0.0, 60.0, 16), FREQS, DT,
                                 nsub=8, group_size=4)
    ref = sweep.sweep_stream(plan, _blocks(data, plan, payload), payload,
                             device="cpu")
    ck = str(tmp_path / "b.ckpt.npz")
    with pytest.raises(Killed):
        sweep.sweep_stream(plan, _killing(_blocks(data, plan, payload), 5),
                           payload, device="cpu",
                           checkpoint=sweep.SweepCheckpoint(ck, 1))
    assert _cursor(ck) > 0
    got = sweep.sweep_stream(plan, _blocks(data, plan, payload), payload,
                             device="cpu",
                             checkpoint=sweep.SweepCheckpoint(ck, 1))
    _assert_same(got, ref)


def _spoil(path, how):
    if how == "corrupt":
        with open(path, "r+b") as f:
            f.seek(40)
            f.write(b"\xff" * 64)
    elif how == "truncated":
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)


@pytest.mark.parametrize("case", ["other_dms", "other_engine", "no_peaks",
                                  "corrupt", "truncated"])
def test_foreign_or_corrupt_checkpoint_restarts(tmp_path, case):
    """A checkpoint of other trials, another engine, written without chunk
    peaks for a run that keeps them, or unreadable: the sweep starts from
    scratch (the factory is never asked for a seek) and gives its own
    uninterrupted bits."""
    T, payload = 10000, 2048
    data = _data(T, seed=13)
    plan_a = sweep.make_sweep_plan(np.linspace(0.0, 60.0, 8), FREQS, DT,
                                   nsub=8, group_size=4)
    plan_b = (sweep.make_sweep_plan(np.linspace(0.0, 80.0, 8), FREQS, DT,
                                    nsub=8, group_size=4)
              if case == "other_dms" else plan_a)
    engine_b = "tree" if case == "other_engine" else "gather"
    keep_b = case == "no_peaks"
    ck = str(tmp_path / "x.npz")
    with pytest.raises(Killed):
        sweep.sweep_stream(plan_a, _killing(_blocks(data, plan_a, payload),
                                            4),
                           payload, device="cpu",
                           checkpoint=sweep.SweepCheckpoint(ck, 1))
    _spoil(ck, case)
    kw = dict(engine=engine_b, keep_chunk_peaks=keep_b, device="cpu")
    ref = sweep.sweep_stream(plan_b, _blocks(data, plan_b, payload),
                             payload, **kw)

    def factory(at):
        raise AssertionError(f"resumed at {at} from a foreign checkpoint")

    got = sweep.sweep_stream(plan_b, _blocks(data, plan_b, payload), payload,
                             checkpoint=sweep.SweepCheckpoint(ck, 1),
                             block_factory=factory, **kw)
    _assert_same(got, ref, peaks=keep_b)


def test_checkpoint_state_holds_real_rows_and_peaks(tmp_path):
    """The file holds the real trials' rows, the cursor, the baseline and
    one [n_real, W] peak record a drained chunk; a load at the plan's
    padded width repeats the last real row."""
    T, payload = 9000, 2048
    data = _data(T, seed=14)
    plan = sweep.make_sweep_plan(np.linspace(0.0, 60.0, 14), FREQS, DT,
                                 nsub=8, group_size=4)
    ck = str(tmp_path / "p.npz")
    with pytest.raises(Killed):
        sweep.sweep_stream(plan, _killing(_blocks(data, plan, payload), 4),
                           payload, device="cpu", keep_chunk_peaks=True,
                           checkpoint=sweep.SweepCheckpoint(ck, 1))
    with np.load(ck) as z:
        assert z["s"].shape == (14,) and z["mb"].shape == (14, 6)
        assert z["chunk_mb"].shape == (1, 14, 6)
        assert z["chunk_mb"].dtype == np.float32
        assert z["baseline"].shape == (C, 1)
        assert int(z["cursor"]) == payload
    ctx = "engine=gather"
    acc, cursor, base = sweep.SweepCheckpoint(ck).load(
        plan, payload, ctx, keep_chunk_peaks=True)
    assert cursor == payload and acc.s.shape == (16,)
    np.testing.assert_array_equal(acc.mb[14], acc.mb[13])
    np.testing.assert_array_equal(acc.mb[15], acc.mb[13])
    assert sweep.SweepCheckpoint(ck).load(plan, payload, ctx) is None
    assert sweep.SweepCheckpoint(ck).load(plan, payload + 1, ctx,
                                          keep_chunk_peaks=True) is None


# ---------------------------------------------------------------------------
# seek-resume through the readers, and the DDplan's markers
# ---------------------------------------------------------------------------

def _kill_after_saves(monkeypatch, n):
    """Kill the run right after its n-th checkpoint save."""
    real = sweep.SweepCheckpoint.save
    count = [0]

    def save(self, *a, **kw):
        real(self, *a, **kw)
        count[0] += 1
        if count[0] >= n:
            raise Killed()

    monkeypatch.setattr(sweep.SweepCheckpoint, "save", save)


def _record_blocks(monkeypatch):
    """The (window start, first block position) of every reader source
    streamed from now on."""
    real = staged.ReaderSource.chan_major_blocks
    seen = []

    def blocks(self, payload, overlap, device):
        first = True
        for pos, block in real(self, payload, overlap, device):
            if first:
                seen.append((self.start, pos))
                first = False
            yield pos, block

    monkeypatch.setattr(staged.ReaderSource, "chan_major_blocks", blocks)
    return seen


def _fil(path, T, seed):
    """An 8-bit ``.fil`` of integer noise with a pulse at DM 40 every 1500
    samples; returns (path, [time, chan] values)."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 64, size=(T, C)).astype(np.int64)
    bins = np.round((4149.377593360996 * 40.0
                     * (FREQS ** -2.0 - FREQS.max() ** -2.0)) / DT)
    for t0 in range(300, T, 1500):
        for c in range(C):
            t = t0 + int(bins[c])
            vals[t:t + 3, c] += 30
    write_filterbank(path, dict(nchans=C, tsamp=DT, fch1=1500.0, foff=-4.0,
                                nbits=8, tstart=58000.0), vals)
    return path, vals


def _open(kind, tmp_path):
    """A reader of each kind the source seeks, and a mask or None."""
    T = 12000
    if kind in ("fil", "masked_fil"):
        fn, _ = _fil(str(tmp_path / "a.fil"), T, seed=5)
        mask = None
        if kind == "masked_fil":
            mfn = str(tmp_path / "a.mask")
            write_mask(mfn, nchan=C, nint=12, ptsperint=1000,
                       zap_chans=[3, 17], zap_ints=[2, 9])
            mask = RfifindMask(mfn)
        return FilterbankFile(fn), mask
    if kind == "psrfits4":
        from test_torch_psrfits import write_fits

        return PsrfitsFile(write_fits(str(tmp_path / "a.fits"), nbits=4,
                                      T=T, seed=7)), None
    _, vals = _fil(str(tmp_path / "whole.fil"), T, seed=6)
    parts = []
    for i, (a, b) in enumerate(((0, 5000), (5000, T))):
        p = str(tmp_path / f"part{i}.fil")
        write_filterbank(p, dict(nchans=C, tsamp=DT, fch1=1500.0, foff=-4.0,
                                 nbits=8,
                                 tstart=58000.0 + a * DT / 86400.0),
                         vals[a:b])
        parts.append(p)
    return FilterbankObs(parts), None


@pytest.mark.parametrize("kind", ["fil", "psrfits4", "fbobs", "masked_fil"])
def test_flat_sweep_seeks_to_the_cursor(tmp_path, monkeypatch, kind):
    """``sweep_flat(checkpoint_path=)`` killed after its second save
    resumes with its reader seeked to the cursor (downsampled by 2: the
    raw window starts at twice the cursor) and the uninterrupted bits."""
    reader, mask = _open(kind, tmp_path)
    dms = np.linspace(0.0, 90.0, 12)
    kw = dict(downsamp=2, nsub=8, group_size=4, chunk_payload=700,
              rfimask=mask, device="cpu")
    ref = staged.sweep_flat(reader, dms, keep_chunk_peaks=True, **kw)
    base = str(tmp_path / "flat.ckpt")
    with monkeypatch.context() as m:
        _kill_after_saves(m, 2)
        with pytest.raises(Killed):
            staged.sweep_flat(reader, dms, checkpoint_path=base,
                              checkpoint_every=1, keep_chunk_peaks=True,
                              **kw)
    cursor = _cursor(base)
    assert cursor == 2 * 700
    with monkeypatch.context() as m:
        seen = _record_blocks(m)
        got = staged.sweep_flat(reader, dms, checkpoint_path=base,
                                checkpoint_every=1, keep_chunk_peaks=True,
                                **kw)
    assert seen == [(2 * cursor, 2 * cursor)]
    _assert_same(got.steps[0].result, ref.steps[0].result, peaks=True)
    assert got.events(5.0) == ref.events(5.0)
    assert not os.path.exists(base)


def test_reader_source_window_and_seam_check(tmp_path):
    fn, _ = _fil(str(tmp_path / "w.fil"), 5000, seed=8)
    with FilterbankFile(fn) as r:
        whole = list(staged.ReaderSource(r).chan_major_blocks(1000, 300,
                                                              "cpu"))
        part = list(staged.ReaderSource(r, 2000, 4000).chan_major_blocks(
            1000, 300, "cpu"))
        assert [p for p, _ in part] == [2000, 3000]
        for (p, b), (q, w) in zip(part, whole[2:4]):
            assert p == q and np.array_equal(b.numpy(), w.numpy())
            assert b.shape[1] == 1300  # the overlap reads past the window
        with pytest.raises(ValueError, match="whole multiple"):
            list(staged.ReaderSource(r, 0, 2500).chan_major_blocks(
                1000, 300, "cpu"))
        with pytest.raises(ValueError, match="bad window"):
            staged.ReaderSource(r, 4000, 3000)


def _ddplan(T):
    obs = Observation(dt=DT, fctr=float(FREQS.mean()),
                      BW=float(FREQS.max() - FREQS.min() + 4.0), numchan=C)
    plan = obs.gen_ddplan(0.0, 400.0)
    assert len(plan.DDsteps) >= 2, "the test needs a multi-step plan"
    return plan


def _count_steps(monkeypatch, fail_at=None):
    """Count run_step calls; raise Killed at call ``fail_at``."""
    real = staged.run_step
    calls = []

    def run_step(*a, **kw):
        calls.append(a[2])  # the step's downsampling
        if fail_at is not None and len(calls) == fail_at:
            raise Killed()
        return real(*a, **kw)

    monkeypatch.setattr(staged, "run_step", run_step)
    return calls


def _same_steps(got, ref):
    assert len(got.steps) == len(ref.steps)
    for a, b in zip(got.steps, ref.steps):
        assert (a.downsamp, a.dt) == (b.downsamp, b.dt)
        _assert_same(a.result, b.result)


def test_ddplan_resumes_from_step_markers(tmp_path, monkeypatch):
    """Killed before step 1: step 0's done marker is loaded, not swept,
    and the plan's result has the uninterrupted bits; the markers go when
    the plan finishes."""
    fn, _ = _fil(str(tmp_path / "d.fil"), 16384, seed=9)
    kw = dict(nsub=8, group_size=4, chunk_payload=3000, device="cpu")
    base = str(tmp_path / "stg")
    with FilterbankFile(fn) as r:
        plan = _ddplan(r.nspec)
        ref = staged.sweep_ddplan(r, plan, **kw)
        with monkeypatch.context() as m:
            _count_steps(m, fail_at=2)
            with pytest.raises(Killed):
                staged.sweep_ddplan(r, plan, checkpoint_path=base, **kw)
        assert os.path.exists(base + ".step0.done.npz")
        with monkeypatch.context() as m:
            calls = _count_steps(m)
            got = staged.sweep_ddplan(r, plan, checkpoint_path=base, **kw)
    assert len(calls) == len(plan.DDsteps) - 1
    _same_steps(got, ref)
    assert not [f for f in os.listdir(tmp_path) if f.startswith("stg")]


def test_ddplan_resumes_inside_a_step(tmp_path, monkeypatch):
    """Killed inside step 1 (after its second save): the resume loads
    step 0's marker, re-roots step 1 at its cursor and sweeps the rest."""
    fn, _ = _fil(str(tmp_path / "d.fil"), 16384, seed=10)
    kw = dict(nsub=8, group_size=4, chunk_payload=1500, device="cpu")
    base = str(tmp_path / "stg")
    with FilterbankFile(fn) as r:
        plan = _ddplan(r.nspec)
        ref = staged.sweep_ddplan(r, plan, **kw)
        real_save = staged._save_step_result
        with monkeypatch.context() as m:
            # the kill counts step 1's saves only: arm it at step 0's
            # marker
            def arm(*a):
                real_save(*a)
                _kill_after_saves(m, 2)

            m.setattr(staged, "_save_step_result", arm)
            with pytest.raises(Killed):
                staged.sweep_ddplan(r, plan, checkpoint_path=base,
                                    checkpoint_every=1, **kw)
        cursor = _cursor(base + ".step1.npz")
        ds1 = plan.DDsteps[1].downsamp
        with monkeypatch.context() as m:
            seen = _record_blocks(m)
            got = staged.sweep_ddplan(r, plan, checkpoint_path=base,
                                      checkpoint_every=1, **kw)
    # the probe reads the file's head; step 1 starts at its cursor
    assert seen[0] == (0, 0) and seen[1] == (cursor * ds1, cursor * ds1)
    assert len(seen) == 1 + len(plan.DDsteps) - 1
    _same_steps(got, ref)


def test_ddplan_marker_of_another_input_is_not_loaded(tmp_path,
                                                      monkeypatch):
    """Two files of one geometry: a marker left by a run on A is ignored
    by a run on B (the probe of B's first samples differs), which sweeps
    every step and gives B's own bits."""
    fa, _ = _fil(str(tmp_path / "a.fil"), 16384, seed=21)
    fb, _ = _fil(str(tmp_path / "b.fil"), 16384, seed=22)
    kw = dict(nsub=8, group_size=4, chunk_payload=3000, device="cpu")
    base = str(tmp_path / "stg")
    with FilterbankFile(fa) as ra, FilterbankFile(fb) as rb:
        plan = _ddplan(ra.nspec)
        with monkeypatch.context() as m:
            _count_steps(m, fail_at=2)
            with pytest.raises(Killed):
                staged.sweep_ddplan(ra, plan, checkpoint_path=base, **kw)
        assert os.path.exists(base + ".step0.done.npz")
        ref = staged.sweep_ddplan(rb, plan, **kw)
        with monkeypatch.context() as m:
            calls = _count_steps(m)
            got = staged.sweep_ddplan(rb, plan, checkpoint_path=base, **kw)
    assert len(calls) == len(plan.DDsteps)
    _same_steps(got, ref)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

SWEEP = ["--lodm", "0", "--dmstep", "4", "--numdms", "24", "-s", "8",
         "--group-size", "8", "--threshold", "6"]


def _rows(path):
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[0].startswith("# DM")
    return [(float(p[0]), float(p[1]), int(p[3]), int(p[4]), int(p[5]))
            for p in (ln.split() for ln in lines[1:])]


def test_cli_resume_equals_uninterrupted_and_jax(tmp_path, monkeypatch):
    """``--checkpoint X --checkpoint-every 1`` killed after its third save,
    then ``--resume``: the ``.cands``, ``.events`` and ``.pulses`` bytes of
    the uninterrupted port run; the ``.cands`` rows meet the JAX
    package's uninterrupted ``cli.sweep`` (peaks equal, or a float64-
    proven tie on the file's integer samples)."""
    from test_torch_sweep import _assert_peaks_match, _exact_boxes

    fn, vals = _fil(str(tmp_path / "c.fil"), 14000, seed=31)
    flags = SWEEP + ["--chunk", "2000", "--all-events", "--device", "cpu"]
    full = str(tmp_path / "full")
    assert cli.main([fn, "-o", full, *flags]) == 0
    ck = str(tmp_path / "c.ckpt")
    res = str(tmp_path / "res")
    with monkeypatch.context() as m:
        _kill_after_saves(m, 3)
        with pytest.raises(Killed):
            cli.main([fn, "-o", res, *flags, "--checkpoint", ck,
                      "--checkpoint-every", "1"])
    assert _cursor(ck) == 3 * 2000
    assert not os.path.exists(res + ".cands")
    with monkeypatch.context() as m:
        seen = _record_blocks(m)
        assert cli.main([fn, "-o", res, *flags, "--checkpoint", ck,
                         "--checkpoint-every", "1", "--resume"]) == 0
    assert seen == [(6000, 6000)]
    assert not os.path.exists(ck)
    for ext in (".cands", ".events", ".pulses"):
        with open(full + ext, "rb") as a, open(res + ext, "rb") as b:
            assert a.read() == b.read(), ext
    ref = str(tmp_path / "jax")
    assert jax_cli.main([fn, "-o", ref, *SWEEP, "--chunk", "2000",
                         "--engine", "gather"]) == 0
    got, want = _rows(res + ".cands"), _rows(ref + ".cands")
    assert len(got) == len(want) > 0
    plan = sweep.make_sweep_plan(4.0 * np.arange(24), FREQS, DT, nsub=8,
                                 group_size=8)
    boxes = _exact_boxes(vals, plan, 2000, sweep.DEFAULT_WIDTHS)
    widths = list(sweep.DEFAULT_WIDTHS)
    for g, r in zip(got, want):
        assert (g[0], g[3], g[4]) == (r[0], r[3], r[4]), (g, r)
        assert abs(g[1] - r[1]) <= 2e-6 * abs(r[1]) + 1e-3, (g, r)
        if g[2] != r[2]:
            d, wi = int(round(g[0] / 4.0)), widths.index(g[3])
            _assert_peaks_match(np.array([[g[2]]]), np.array([[r[2]]]),
                                boxes[d:d + 1, wi:wi + 1])


def test_cli_ddplan_resume_equals_uninterrupted(tmp_path, monkeypatch):
    """``--ddplan --checkpoint`` killed between steps, then ``--resume``:
    the uninterrupted ``.cands`` bytes, and no marker left behind. A run
    without ``--resume`` removes stale checkpoints first."""
    fn, _ = _fil(str(tmp_path / "d.fil"), 16384, seed=41)
    flags = ["--ddplan", "--lodm", "0", "--hidm", "1000", "-s", "8",
             "--group-size", "8", "--chunk", "3000", "--device", "cpu"]
    full = str(tmp_path / "full")
    assert cli.main([fn, "-o", full, *flags]) == 0
    ck = str(tmp_path / "d.ckpt")
    res = str(tmp_path / "res")
    with monkeypatch.context() as m:
        _count_steps(m, fail_at=2)
        with pytest.raises(Killed):
            cli.main([fn, "-o", res, *flags, "--checkpoint", ck])
    assert os.path.exists(ck + ".step0.done.npz")
    keep = str(tmp_path / "keep.npz")
    shutil.copy(ck + ".step0.done.npz", keep)
    with monkeypatch.context() as m:
        calls = _count_steps(m)
        assert cli.main([fn, "-o", res, *flags, "--checkpoint", ck,
                         "--resume"]) == 0
    n_steps = len(calls) + 1
    with open(full + ".cands", "rb") as a, open(res + ".cands", "rb") as b:
        assert a.read() == b.read()
    assert not os.path.exists(ck + ".step0.done.npz")
    shutil.copy(keep, ck + ".step0.done.npz")
    with monkeypatch.context() as m:
        calls = _count_steps(m)
        assert cli.main([fn, "-o", res, *flags, "--checkpoint", ck]) == 0
    assert len(calls) == n_steps  # the stale marker was removed, not used


@pytest.mark.parametrize("flags,message", [
    (["--numdms", "8", "--resume"], "--resume requires --checkpoint"),
    (["--ddplan", "--hidm", "300", "--all-events"],
     "--all-events is a flat-mode option"),
])
def test_cli_refusals_are_the_references(tmp_path, capsys, flags, message):
    fn, _ = _fil(str(tmp_path / "r.fil"), 2000, seed=3)
    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit) as e:
            main([fn, "-o", str(tmp_path / "x"), *flags])
        assert e.value.code == 2
        assert message in capsys.readouterr().err
