"""The port's standalone acceleration search (``cli.accelsearch``) and
``cli.plot_accelcands`` against the JAX package's on the CPU, on ``.dat``
and ``.fft`` files made from a seed.

Contracts:
- every mode (serial, batched with device or host prep, ``.fft`` input,
  ``--zapfile``, ``--coarse-dz``, the jerk search, ``--skip-existing``):
  each file's candidates under the matched-candidate contract against
  the reference's run with the same flags, (dr, dz, dsig) = (0.5, 1.0,
  0.5) above ``sigma + 0.5``, and the injected tone found;
- within the port, ``.cand`` bytes are equal across ``--batch 1/2/4`` and
  ``--prefetch 0/4`` for one prep kind, between a ``.dat`` and its
  ``write_fft`` ``.fft`` under the host prep, and between the grouped
  device prep and the same group prepped in budget-capped slices;
- ``plot_accelcands`` prints the reference's zap rows and collects the
  reference's arrays (the same numpy code: exactly equal).
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pypulsar_tpu.cli import accelsearch as jax_cli
from pypulsar_tpu.cli import plot_accelcands as jax_plot
from pypulsar_tpu.io import prestocand as jax_prestocand
from pypulsar_tpu_torch.cli import accelsearch as cli
from pypulsar_tpu_torch.cli import plot_accelcands
from pypulsar_tpu_torch.fourier import accelsearch, kernels
from pypulsar_tpu_torch.fourier.prestofft import write_fft
from pypulsar_tpu_torch.io import prestocand
from pypulsar_tpu_torch.io.datfile import write_dat
from pypulsar_tpu_torch.io.infodata import InfoData
from tests.torch_hermetic import hermetic_tune_cache  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, DT = 1 << 15, 5e-4
T = N * DT
SIGMA = 3.0
# (f0 Hz, drift z in bins over T, amplitude) of each file
TONES = [(41.0, 0.0, 0.2), (48.0, 6.0, 0.22), (55.0, -8.0, 0.18),
         (62.0, 0.0, 0.0)]
BASE_FLAGS = ["-z", "10", "-n", "2", "-s", str(SIGMA)]


def _series(f0, z, amp, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(N) * DT
    ts = rng.standard_normal(N).astype(np.float32)
    if amp:
        ts += amp * np.cos(2 * np.pi * (f0 * t + 0.5 * z / T ** 2 * t * t)
                           ).astype(np.float32)
    return ts


def _inf(n=N, dt=DT):
    inf = InfoData()
    inf.epoch = 55000.0
    inf.dt = dt
    inf.N = n
    inf.telescope = "Fake"
    inf.lofreq = 1400.0
    inf.BW = 100.0
    inf.numchan = 1
    inf.chan_width = 100.0
    inf.object = "FAKE"
    return inf


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Four .dat/.inf pairs (three tones, one noise) and the .fft of each
    (``write_fft`` of numpy's rfft rounded to complex64)."""
    d = tmp_path_factory.mktemp("accelcli")
    bases = []
    for i, (f0, z, amp) in enumerate(TONES):
        base = str(d / f"beam{i}")
        ts = _series(f0, z, amp, seed=20 + i)
        write_dat(base, ts, _inf())
        write_fft(str(d / f"spec{i}.fft"),
                  np.fft.rfft(ts).astype(np.complex64), _inf())
        bases.append(base)
    with open(d / "zap.txt", "w") as f:
        f.write("# centre width (Hz)\n48.0 0.5\n")
    return dict(dir=d, bases=bases, dats=[b + ".dat" for b in bases])


def _out(files, tag, i):
    return str(files["dir"] / f"{tag}{i}")


def _run(main, inputs, files, tag, flags):
    """Run ``main`` over ``inputs`` with each output under ``<tag><i>``
    (one call per input when -o is needed, one call otherwise)."""
    if len(inputs) == 1:
        return main([inputs[0], *flags, "-o", _out(files, tag, 0)])
    rc = main([*inputs, *flags])
    for i, inp in enumerate(inputs):
        base = os.path.splitext(inp)[0]
        for ext in ("cand", "txtcand"):
            for fn in glob.glob(f"{base}_ACCEL_*.{ext}"):
                suffix = fn[len(base):]
                os.replace(fn, _out(files, tag, i) + suffix)
    return rc


def _cands(prefix, zmax=10, reader=prestocand.read_rzwcands, jerk=""):
    return reader(f"{prefix}_ACCEL_{zmax}{jerk}.cand")


def _assert_contract(ref, got, floor=SIGMA + 0.5, dr=0.5, dz=1.0,
                     dsig=0.5):
    def matches(c, pool):
        return any(abs(c.r - o.r) < dr and abs(c.z - o.z) < dz
                   and abs(c.sig - o.sig) < dsig for o in pool)

    for a, b, side in ((ref, got, "reference"), (got, ref, "port")):
        for c in a:
            if not matches(c, b):
                assert c.sig <= floor, (
                    f"unmatched {side} candidate r={c.r:.2f} z={c.z:.2f} "
                    f"sigma={c.sig:.2f} above {floor}")


def _found(cands, f0, z):
    """The tone among the first 5 candidates: within 1.5 bins of its mean
    frequency (f0 at the start, z bins of drift), 2 sigma above the
    floor."""
    return any(abs(c.r - (f0 * T + 0.5 * z)) < 1.5 and c.sig > SIGMA + 2
               for c in cands[:5])


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


MODES = {
    # name: (inputs by file index or .fft, flags, jerk tag)
    "serial": ("dat", [0, 1], [], ""),
    "batch_device_prep": ("dat", [0, 1, 2, 3], ["--batch", "4"], ""),
    "batch_host_prep": ("dat", [0, 1, 2], ["--batch", "2",
                                           "--no-device-prep"], ""),
    "fft": ("fft", [0, 1], ["--batch", "2"], ""),
    "zapfile": ("dat", [1, 2], ["--batch", "2", "--zapfile", "ZAP"], ""),
    "coarse": ("dat", [1, 2], ["--batch", "2", "--coarse-dz", "4"], ""),
    "jerk": ("dat", [1], ["-w", "20", "--dw", "20"], "_JERK_20"),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cli_matches_reference_under_contract(files, mode):
    kind, idx, flags, jerk = MODES[mode]
    flags = [str(files["dir"] / "zap.txt") if f == "ZAP" else f
             for f in flags]
    if kind == "dat":
        inputs = [files["dats"][i] for i in idx]
    else:
        inputs = [str(files["dir"] / f"spec{i}.fft") for i in idx]
    assert _run(jax_cli.main, inputs, files, f"ref_{mode}",
                BASE_FLAGS + flags) == 0
    assert _run(cli.main, inputs, files, f"port_{mode}",
                BASE_FLAGS + flags + ["--device", "cpu"]) == 0
    for j, i in enumerate(idx):
        ref = _cands(_out(files, f"ref_{mode}", j),
                     reader=jax_prestocand.read_rzwcands, jerk=jerk)
        got = _cands(_out(files, f"port_{mode}", j), jerk=jerk)
        _assert_contract(ref, got)
        f0, z, amp = TONES[i]
        zapped = mode == "zapfile" and i == 1
        if amp and not zapped:
            assert _found(got, f0, z), (mode, i, got[:3])
        if zapped:  # the zaplist blanks the 48 Hz tone
            assert not any(abs(c.r / T - 48.0) < 0.3 for c in got)


def test_cand_bytes_do_not_depend_on_batch_or_prefetch(files):
    """The same prep kind gives the same bytes at --batch 1/2/4 and
    --prefetch 0/4; device and host prep each."""
    dats = files["dats"][:3]
    runs = {
        "host_b1": ["--batch", "1"],
        "host_b2": ["--batch", "2", "--no-device-prep"],
        "host_b4_p0": ["--batch", "4", "--no-device-prep", "--prefetch",
                       "0"],
        "dev_b2": ["--batch", "2"],
        "dev_b4_p0": ["--batch", "4", "--prefetch", "0"],
        "dev_b4": ["--batch", "4", "--device-prep"],
    }
    for tag, flags in runs.items():
        assert _run(cli.main, dats, files, tag,
                    BASE_FLAGS + flags + ["--device", "cpu"]) == 0
    for i in range(3):
        for kind, tags in (("host", ("host_b1", "host_b2", "host_b4_p0")),
                           ("dev", ("dev_b2", "dev_b4_p0", "dev_b4"))):
            for ext in ("cand", "txtcand"):
                got = {tag: _bytes(f"{_out(files, tag, i)}_ACCEL_10.{ext}")
                       for tag in tags}
                assert len(set(got.values())) == 1, (kind, i, ext)


def test_dat_and_its_fft_give_the_same_bytes(files):
    """Under the host prep a .dat and the .fft of its float64 rfft
    (rounded to complex64) search the same spectrum."""
    for i in (0, 1):
        assert cli.main([files["dats"][i], *BASE_FLAGS, "--device", "cpu",
                         "-o", _out(files, "from_dat", i)]) == 0
        assert cli.main([str(files["dir"] / f"spec{i}.fft"), *BASE_FLAGS,
                         "--device", "cpu", "-o",
                         _out(files, "from_fft", i)]) == 0
        for ext in ("cand", "txtcand"):
            assert _bytes(f"{_out(files, 'from_dat', i)}_ACCEL_10.{ext}") \
                == _bytes(f"{_out(files, 'from_fft', i)}_ACCEL_10.{ext}")


def test_device_prep_cap_chunks_the_prep(files, monkeypatch):
    """ACCEL_HBM_BYTES bounds the series one device prep takes (budget //
    (24 n)); the capped slices give the whole group's bytes."""
    dats = files["dats"]
    calls = []
    real_prep = kernels.prep_spectra_batch

    def spy(series, *a, **kw):
        calls.append(np.asarray(series).shape[0])
        return real_prep(series, *a, **kw)

    monkeypatch.setattr(kernels, "prep_spectra_batch", spy)
    flags = BASE_FLAGS + ["--batch", "4", "--device", "cpu"]
    accelsearch.COUNTERS.clear()
    assert _run(cli.main, dats, files, "cap_whole", flags) == 0
    assert calls == [4] and accelsearch.COUNTERS["accel.prep_cap"] == 4
    calls.clear()
    accelsearch.COUNTERS.clear()
    monkeypatch.setattr(accelsearch, "ACCEL_HBM_BYTES", 24 * N * 2)
    assert _run(cli.main, dats, files, "cap_two", flags) == 0
    assert calls == [2, 2] and accelsearch.COUNTERS["accel.prep_cap"] == 2
    assert accelsearch.COUNTERS["accel.bytes_read"] == 4 * 4 * N
    assert accelsearch.COUNTERS["accel.serial_fallbacks"] == 0
    for i in range(4):
        assert _bytes(f"{_out(files, 'cap_whole', i)}_ACCEL_10.cand") == \
            _bytes(f"{_out(files, 'cap_two', i)}_ACCEL_10.cand")


def _fail_first(monkeypatch, exc):
    """Make the first batched search raise ``exc``; later calls (the
    serial retries search batches of one) run the real search."""
    real = accelsearch.accel_search_batch
    state = {"n": 0}

    def flaky(*a, **kw):
        state["n"] += 1
        if state["n"] == 1:
            raise exc
        return real(*a, **kw)

    monkeypatch.setattr(accelsearch, "accel_search_batch", flaky)
    return state


def test_batch_failure_falls_back_serially_and_counts(files, monkeypatch):
    """An ordinary failure of a device-prep batch is retried file by file
    by the host prep (counted), with the serial path's bytes."""
    dats = files["dats"][:3]
    flags = BASE_FLAGS + ["--device", "cpu"]
    assert _run(cli.main, dats, files, "serial_ref", flags) == 0
    state = _fail_first(monkeypatch, RuntimeError("synthetic batch failure"))
    accelsearch.COUNTERS.clear()
    assert _run(cli.main, dats, files, "fallback",
                flags + ["--batch", "3"]) == 0
    assert state["n"] >= 4 and accelsearch.COUNTERS["accel.serial_fallbacks"] == 1
    for i in range(3):
        assert _bytes(f"{_out(files, 'fallback', i)}_ACCEL_10.cand") == \
            _bytes(f"{_out(files, 'serial_ref', i)}_ACCEL_10.cand")


@pytest.mark.parametrize("exc", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
])
def test_device_faults_raise_instead_of_falling_back(files, monkeypatch,
                                                     exc):
    _fail_first(monkeypatch, exc)
    accelsearch.COUNTERS.clear()
    with pytest.raises(type(exc)):
        cli.main([*files["dats"][:2], *BASE_FLAGS, "--batch", "2",
                  "--device", "cpu"])
    assert accelsearch.COUNTERS["accel.serial_fallbacks"] == 0


@pytest.mark.parametrize("batch", ["1", "2"])
def test_one_bad_file_fails_alone(files, tmp_path, batch):
    """A file that cannot be read fails alone: exit 1, the others
    searched."""
    bad = str(tmp_path / "bad.dat")
    with open(bad, "wb") as f:
        f.write(b"\0" * 64)
    with open(str(tmp_path / "bad.inf"), "w") as f:
        f.write("garbage\n")
    good = []
    for i in (0, 2):
        good.append(str(tmp_path / f"g{i}.dat"))
        write_dat(good[-1][:-4], _series(*TONES[i], seed=20 + i), _inf())
    rc = cli.main([good[0], bad, good[1], *BASE_FLAGS, "--batch", batch,
                   "--device", "cpu"])
    assert rc == 1
    for g in good:
        assert os.path.exists(g[:-4] + "_ACCEL_10.cand")
    assert not os.path.exists(str(tmp_path / "bad_ACCEL_10.cand"))


def test_skip_existing_skips_only_complete_pairs(files, tmp_path, capsys):
    dats = []
    for i in (0, 1):
        dats.append(str(tmp_path / f"s{i}.dat"))
        write_dat(dats[-1][:-4], _series(*TONES[i], seed=20 + i), _inf())
    flags = BASE_FLAGS + ["--batch", "2", "--device", "cpu",
                          "--skip-existing"]
    assert cli.main(dats + flags) == 0
    first = [_bytes(d[:-4] + "_ACCEL_10.cand") for d in dats]
    with open(dats[1][:-4] + "_ACCEL_10.cand", "r+b") as f:
        f.truncate(40)  # a killed run's partial record
    capsys.readouterr()
    accelsearch.COUNTERS.clear()
    assert cli.main(dats + flags) == 0
    err = capsys.readouterr().err
    assert "exists, skipping" in err and "FAILS validation" in err
    assert accelsearch.COUNTERS["accel.bytes_read"] == 4 * N  # only s1 re-read
    assert [_bytes(d[:-4] + "_ACCEL_10.cand") for d in dats] == first


@pytest.mark.parametrize("argv,msg", [
    (["--fault-inject", "oops:accel.batch_dispatch:1"],
     "unknown fault kind"),
    (["--fault-inject", "oom"], "kind:point[:N]"),
    (["--fault-inject", "netstall:fleet.heartbeat:x"], "kind:point[:N]"),
    (["--device-prep"], "--batch >= 2"),
    (["--device-prep", "--batch", "1"], "--batch >= 2"),
    (["EXTRA", "-o", "x"], "single input"),
])
def test_cli_refusals(files, capsys, argv, msg):
    argv = [files["dats"][0] if a == "EXTRA" else a for a in argv]
    with pytest.raises(SystemExit) as exc:
        cli.main([files["dats"][1], *argv, "--device", "cpu"])
    assert exc.value.code == 2
    assert msg in capsys.readouterr().err


def test_batch_auto_is_the_reference_default(tmp_path):
    """``--batch auto`` resolves after the tuning consult: on a miss (an
    empty cache) it is the reference's default of 32."""
    args = cli.build_parser().parse_args(
        ["x.dat", "--batch", "auto", "--tune-cache",
         str(tmp_path / "tune.json"), "--device", "cpu"])
    assert args.batch == "auto"
    cli.apply_tuning(args)
    assert args.batch == 32


def test_cli_defaults_to_the_card_and_writes_nothing(files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default path would run")
    out = str(tmp_path / "card")
    for flags in ([], ["--batch", "2"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([files["dats"][0], *BASE_FLAGS, *flags, "-o", out])
    assert not glob.glob(out + "*")


def _zero_cands(files, prefix):
    """The port's zmax-0 tables of the four files (plot_accelcands reads
    ``_ACCEL_0.cand``), beside each ``.inf``."""
    infs = []
    for i, dat in enumerate(files["dats"]):
        base = str(files["dir"] / f"{prefix}{i}")
        write_dat(base, np.fromfile(dat, dtype=np.float32), _inf())
        infs.append(base + ".inf")
    assert cli.main([b[:-4] + ".dat" for b in infs]
                    + ["-z", "0", "-n", "1", "-s", "3", "--batch", "4",
                       "--device", "cpu"]) == 0
    return infs


def test_plot_accelcands_matches_reference(files, capsys, tmp_path):
    infs = _zero_cands(files, "z")
    got = plot_accelcands.collect_candidates(infs)
    want = jax_plot.collect_candidates(infs)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert [str(i) for i in got[3]] == [str(i) for i in want[3]]
    assert len(got[0]) > 0
    capsys.readouterr()
    out = str(tmp_path / "cands.npz")
    assert plot_accelcands.main(infs + ["--min-hits", "0", "--no-plot",
                                        "-o", out]) == 0
    printed = capsys.readouterr().out
    assert jax_plot.main(infs + ["--min-hits", "0", "--no-plot"]) == 0
    ref_rows = capsys.readouterr().out
    assert printed.splitlines()[:-1] == ref_rows.splitlines()
    arr = np.load(out)
    np.testing.assert_array_equal(arr["freqs"], want[0])
    np.testing.assert_array_equal(arr["filenums"], want[2])
    zapped = [i for i in want[3] if i.numelements > 0]
    np.testing.assert_array_equal(arr["zap_fcent"],
                                  [i.fcent for i in zapped])


def test_plot_accelcands_npz_imports_no_matplotlib(files, tmp_path):
    infs = _zero_cands(files, "m")
    out = str(tmp_path / "c.npz")
    code = ("import sys\n"
            "from pypulsar_tpu_torch.cli import plot_accelcands as p\n"
            f"assert p.main({infs!r} + ['-o', {out!r}]) == 0\n"
            "assert not [m for m in sys.modules if m.startswith("
            "'matplotlib')]\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert np.load(out)["freqs"].size > 0


def test_plot_accelcands_draws_with_matplotlib(files, tmp_path):
    import matplotlib

    matplotlib.use("Agg", force=True)
    infs = _zero_cands(files, "p")
    out = str(tmp_path / "cands.png")
    assert plot_accelcands.main(infs + ["-o", out, "--min-hits", "2"]) == 0
    assert os.path.getsize(out) > 1000
