"""The PyTorch port stands alone: importing every module of
``pypulsar_tpu_torch`` loads no ``jax`` and nothing of ``pypulsar_tpu``,
no source of the port names them, and its entry points refuse to run on
the CPU unless asked."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "pypulsar_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "pypulsar_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_forbidden_prefix_rule():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("pypulsar_tpu") and _forbidden("pypulsar_tpu.io")
    assert not _forbidden("pypulsar_tpu_torch")
    assert not _forbidden("pypulsar_tpu_torch.ops.gather_sum")
    assert not _forbidden("jaxtyping_like")


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pypulsar_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'pypulsar_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(len(names))\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert int(lines[0]) >= 30  # every module was imported
    # the batch broker and the lane among them
    assert {"pypulsar_tpu_torch.parallel.broker",
            "pypulsar_tpu_torch.survey.lane",
            "pypulsar_tpu_torch.ops.fold"} <= set(lines[1:])
    loaded = [m for m in lines[1:] if _forbidden(m)]
    assert loaded == []


def test_no_source_of_the_port_imports_jax():
    offenders = []
    for dirpath, _, files in os.walk(PKG):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                offenders += [(path, n) for n in names if _forbidden(n)]
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            offenders += [("chip_smoke.py", a.name) for a in node.names
                          if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and _forbidden(node.module):
            offenders.append(("chip_smoke.py", node.module))
    assert offenders == []


def test_entry_points_default_to_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default path would run")
    from pypulsar_tpu_torch.parallel.sweep import sweep_spectra, sweep_stream
    from pypulsar_tpu_torch.parallel.sweep import make_sweep_plan

    freqs = 1500.0 - np.arange(16)
    data = np.zeros((16, 500), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep_spectra(data, freqs, 1e-3, [0.0, 5.0], nsub=4)
    plan = make_sweep_plan([0.0], freqs, 1e-3, nsub=4, group_size=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep_stream(plan, iter([(0, data)]), 400)
    # asked explicitly, the CPU runs
    res = sweep_spectra(data, freqs, 1e-3, [0.0, 5.0], nsub=4, device="cpu")
    assert res.snr.shape == (2, 6)
    _spectra_entry_points_default_to_the_card(tmp_path)


def _spectra_entry_points_default_to_the_card(tmp_path):
    """The Spectra loaders, detrend_blocks and the waterfaller,
    zero_dm_filter, spectrogram and freq_time CLIs raise without a card
    and write nothing; asked for the CPU, they run."""
    from pypulsar_tpu_torch.cli import (
        freq_time,
        spectrogram,
        waterfaller,
        zero_dm_filter,
    )
    from pypulsar_tpu_torch.io import psrfits
    from pypulsar_tpu_torch.io.datfile import Datfile
    from pypulsar_tpu_torch.io.fbobs import FilterbankObs
    from pypulsar_tpu_torch.io.filterbank import FilterbankFile
    from pypulsar_tpu_torch.io.synth import write_synthetic_fil
    from pypulsar_tpu_torch.parallel.staged import make_dat_inf
    from pypulsar_tpu_torch.utils.detrend import detrend_blocks

    fil = str(tmp_path / "s.fil")
    write_synthetic_fil(fil, nchan=16, nsamp=4096, period_samples=256)
    fits = str(tmp_path / "s.fits")
    psrfits.write_psrfits(fits, np.ones((16, 512)), 1500.0 - np.arange(16),
                          1e-3, nsamp_per_subint=128)
    dat = str(tmp_path / "s.dat")
    np.arange(4096, dtype=np.float32).tofile(dat)
    with FilterbankFile(fil) as r:
        make_dat_inf(dat[:-4], r, 0.0, 4096, float(r.tsamp),
                     r.frequencies).to_file(dat[:-4] + ".inf")
    out = str(tmp_path / "o")
    calls = [
        lambda: waterfaller.main([fil, "-T", "0", "-t", "0.1", "-o",
                                  out + ".png"]),
        lambda: zero_dm_filter.main([fil, "-o", out + ".fil"]),
        lambda: spectrogram.main([dat, "-t", "0.05", "-o", out + ".png"]),
        lambda: freq_time.main([fil, "-o", out + ".png"]),
        lambda: FilterbankFile(fil).get_spectra(0, 100),
        lambda: psrfits.PsrfitsFile(fits).get_spectra(0, 100),
        lambda: FilterbankObs([fil]).get_spectra(0, 100),
        lambda: detrend_blocks(np.ones((1, 8)), np.ones((1, 8)),
                               np.zeros((1, 8), bool))]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not list(tmp_path.glob("o*"))
    # asked explicitly, the CPU runs
    assert waterfaller.main([fil, "-T", "0", "-t", "0.1", "-o", out + ".png",
                             "--device", "cpu"]) == 0
    assert zero_dm_filter.main([fil, "-o", out + ".fil", "--device",
                                "cpu"]) == 0
    assert spectrogram.main([dat, "-t", "0.05", "-o", out + "s.png",
                             "--device", "cpu"]) == 0
    assert freq_time.main([fil, "-o", out + "f.png", "--device", "cpu"]) == 0
    with Datfile(dat) as d:
        assert d.read_Nsamples(4096).size == 4096


def test_engine_spectral_and_ddplan_entry_points_default_to_the_card(
        tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default path would run")
    from pypulsar_tpu_torch.fourier.accelsearch import AccelSearchConfig
    from pypulsar_tpu_torch.io.filterbank import FilterbankFile
    from pypulsar_tpu_torch.io.synth import write_synthetic_fil
    from pypulsar_tpu_torch.parallel import accelpipe, specfuse, staged
    from pypulsar_tpu_torch.parallel.sweep import sweep_spectra
    from pypulsar_tpu_torch.plan.ddplan import Observation

    fil = str(tmp_path / "a.fil")
    write_synthetic_fil(fil, nchan=16, nsamp=4096, period_samples=256)
    data = np.zeros((16, 500), np.float32)
    freqs = 1500.0 - np.arange(16)
    for engine in ("tree", "fourier"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sweep_spectra(data, freqs, 1e-3, [0.0, 5.0], nsub=4,
                          engine=engine)
    with FilterbankFile(fil) as r:
        plan = Observation(float(r.tsamp), 1400.0, 100.0, 16).gen_ddplan(
            0.0, 50.0)
        calls = [
            lambda: staged.sweep_ddplan(r, plan, nsub=4),
            lambda: specfuse.fused_spectra_slice(r, [0.0, 5.0], nsub=4),
            lambda: accelpipe.sweep_accel_stream(
                r, [0.0, 5.0], AccelSearchConfig(), str(tmp_path / "o"),
                nsub=4, spectral=True)]
        for call in calls:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    assert not list(tmp_path.glob("o*"))


def test_psrfits_and_multi_file_entry_points_default_to_the_card(tmp_path):
    """The sweep, the mask stage and the fold's stream source on a PSRFITS
    file and on several .fil files raise without a card and write
    nothing; asked for the CPU, they run."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default path would run")
    from pypulsar_tpu_torch.cli import foldbatch, rfifind, sweep
    from pypulsar_tpu_torch.io import psrfits
    from pypulsar_tpu_torch.io.fbobs import FilterbankObs
    from pypulsar_tpu_torch.io.filterbank import write_filterbank
    from pypulsar_tpu_torch.ops import rfifind as ops_rfifind
    from pypulsar_tpu_torch.parallel import staged

    rng = np.random.default_rng(1)
    data = rng.integers(0, 200, (16, 4096)).astype(np.float32)
    freqs = 1500.0 - np.arange(16)
    fits = str(tmp_path / "a.fits")
    psrfits.write_psrfits(fits, data, freqs, 1e-3, nsamp_per_subint=256)
    fils = []
    for i in range(2):
        fils.append(str(tmp_path / f"p{i}.fil"))
        write_filterbank(fils[-1], dict(nchans=16, tsamp=1e-3, fch1=1500.0,
                                        foff=-1.0, nbits=8,
                                        tstart=58000.0 + i * 2.048 / 86400),
                         data[:, i * 2048:(i + 1) * 2048].T)
    cands = str(tmp_path / "c.txt")
    with open(cands, "w") as f:
        f.write("0.05 10.0\n")
    out = str(tmp_path / "o")
    calls = [
        lambda: sweep.main([fits, "--numdms", "4", "-o", out, "-s", "4"]),
        lambda: rfifind.main([fits, "-o", out]),
        lambda: rfifind.main([*fils, "-o", out]),
        lambda: foldbatch.main(["--cands", cands, fits, "-o", out, "-s",
                                "4", "-n", "16", "--npart", "4"]),
        lambda: ops_rfifind.rfifind(psrfits.PsrfitsFile(fits)),
        lambda: ops_rfifind.rfifind(FilterbankObs(fils)),
        lambda: staged.sweep_flat(psrfits.PsrfitsFile(fits), [0.0, 5.0],
                                  nsub=4),
        lambda: staged.sweep_flat(FilterbankObs(fils), [0.0, 5.0], nsub=4)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not list(tmp_path.glob("o*"))
    # asked explicitly, the CPU runs
    assert sweep.main([fits, "--numdms", "4", "-o", out, "-s", "4",
                       "--device", "cpu"]) == 0
    assert rfifind.main([*fils, "-o", out, "--device", "cpu"]) == 0


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_prints_no_result_off_the_card(tmp_path, where):
    """Without a card, or copied away from the package, chip_smoke.py
    fails and prints nothing on stdout (no ok line)."""
    import shutil

    import torch

    if where == "checkout" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke test would run")
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "FAIL" in out.stderr


def test_kernel_wrappers_dispatch_on_tensor_device():
    """CPU tensors take the plain versions and count no launch."""
    import torch

    from pypulsar_tpu_torch.ops.boxcar_stats import boxcar_stats
    from pypulsar_tpu_torch.ops.gather_sum import (
        gather_tables,
        shifted_gather_sum,
    )

    n0, m0 = dict(shifted_gather_sum.launches), boxcar_stats.launches
    data = torch.ones((4, 64))
    tables = gather_tables(np.zeros((1, 3)), np.zeros((1, 2, 3)),
                           np.arange(2)[None, :], "cpu", "stage1")
    out = shifted_gather_sum(data, tables, 32)
    assert torch.equal(out, torch.full((2, 32), 3.0))
    boxcar_stats(out, (1, 2), 16)
    assert (dict(shifted_gather_sum.launches), boxcar_stats.launches) == \
        (n0, m0)


def test_prepfold_and_fold_engine_default_to_the_card(tmp_path):
    """prepfold and the engine's channel folds run on the card unless
    asked for the CPU: without one they raise and write nothing."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default path would run")
    from pypulsar_tpu_torch.cli import prepfold
    from pypulsar_tpu_torch.fold import engine
    from pypulsar_tpu_torch.io.synth import write_synthetic_fil

    fil = str(tmp_path / "p.fil")
    write_synthetic_fil(fil, nchan=16, nsamp=4096, period_samples=256)
    out = str(tmp_path / "p.pfd")
    argv = [fil, "-p", "0.016384", "--nsub", "4", "--npart", "4", "-o", out]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepfold.main(argv)
    assert not os.path.exists(out)
    data = np.ones((2, 64), np.float32)
    bins = np.zeros(64, np.int32)
    calls = [lambda: engine.fold_bins(data, bins, 4),
             lambda: engine.fold_parts(data, bins, 4, 2),
             lambda: engine.fold_stats(data, bins, 4, 2,
                                       np.zeros((3, 2), np.float32)),
             lambda: engine.fold_snr_stats(data, bins, 4, 2, 1e-3, 0.1),
             lambda: engine.fold_timeseries(data[0], 1e-3, 4, period=0.1),
             lambda: engine.fold_spectra(data, 1e-3, 4, period=0.1)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asked explicitly, the CPU runs
    assert prepfold.main(argv + ["--device", "cpu"]) == 0
    assert os.path.exists(out)


def test_fold_chan_dispatches_on_tensor_device():
    """A CPU tensor takes the channel fold's plain version and counts no
    launch; fold_bins of CPU tensors runs where they lie."""
    import torch

    from pypulsar_tpu_torch.fold import engine
    from pypulsar_tpu_torch.ops.fold import fold_chan

    n0 = fold_chan.launches
    data = torch.ones((3, 16))
    bins = torch.arange(16, dtype=torch.int32) % 4
    profs, counts = fold_chan(data, bins, 4, 2)
    assert torch.equal(profs, torch.full((2, 3, 4), 2.0))
    assert torch.equal(counts, torch.full((2, 4), 2, dtype=torch.int32))
    prof, cnt = engine.fold_bins(data, bins, 4)  # default device: ignored
    assert prof.device.type == "cpu" and torch.equal(prof,
                                                     torch.full((3, 4), 4.0))
    assert fold_chan.launches == n0
