"""The port's sweep CLI against the reference CLI on one small file.

Both write ``{outbase}.cands``; the parsed rows must agree in DM, sample,
width and downsample factor, and in SNR within 1e-3 (the file prints SNR
with three decimals).
"""

import numpy as np
import pytest

from pypulsar_tpu.cli import sweep as jax_cli
from pypulsar_tpu_torch.cli import sweep as cli
from pypulsar_tpu_torch.io import filterbank
from tests.torch_hermetic import hermetic_tune_cache  # noqa: F401


def _read_cands(path):
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[0].startswith("# DM")
    return [(float(p[0]), float(p[1]), float(p[2]), int(p[3]), int(p[4]),
             int(p[5])) for p in (ln.split() for ln in lines[1:])]


def _write(path, T=12000, C=64, dt=5e-4, seed=11):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 200, size=(T, C))
    freqs = 1500.0 - 4.0 * np.arange(C)
    bins = np.round((4149.377593360996 * 120.0
                     * (freqs ** -2.0 - freqs.max() ** -2.0)) / dt).astype(int)
    for t0 in (1500, 7300):
        for c in range(C):
            vals[t0 + bins[c]:t0 + bins[c] + 4, c] += 40
    filterbank.write_filterbank(path, dict(fch1=1500.0, foff=-4.0, nchans=C,
                                           tsamp=dt, nbits=8), vals)


@pytest.mark.parametrize("extra", [[], ["--downsamp", "2"]])
def test_cli_cands_match_reference(tmp_path, capsys, extra):
    fn = str(tmp_path / "obs.fil")
    _write(fn)
    common = [fn, "--lodm", "60", "--dmstep", "4", "--numdms", "32",
              "--nsub", "16", "--chunk", "4000", "--threshold", "7"] + extra
    assert cli.main(common + ["-o", str(tmp_path / "port"),
                              "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "DM trials swept" in out
    assert jax_cli.main(common + ["-o", str(tmp_path / "ref"),
                                  "--engine", "gather"]) == 0
    got = _read_cands(str(tmp_path / "port.cands"))
    ref = _read_cands(str(tmp_path / "ref.cands"))
    assert len(ref) > 0 and len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g[0], g[3], g[4], g[5]) == (r[0], r[3], r[4], r[5]), (g, r)
        assert abs(g[1] - r[1]) <= 1e-3 + 1e-9, (g, r)
        assert abs(g[2] - r[2]) <= 1e-6
    best = max(got, key=lambda row: row[1])
    assert abs(best[0] - 120.0) <= 8.0


def test_cli_device_defaults_to_cuda(tmp_path):
    """Without --device the CLI asks for the card; with no CUDA device it
    stops instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default path would run")
    fn = str(tmp_path / "obs.fil")
    _write(fn, T=2000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([fn, "--numdms", "4", "--nsub", "16"])
    assert not (tmp_path / "obs.cands").exists()
