"""The sweep stage's accel handoff with the host prep
(``cli.sweep --accel-search --no-accel-device-prep``) against the JAX
package's on the CPU, on one 8-bit file made from a seed.

Contracts:
- every trial's ``.cand`` under the matched-candidate contract against
  the reference's host-prep run, (dr, dz, dsig) = (0.5, 1.0, 0.5) above
  ``sigma_min + 0.5``, and the injected pulsar found in its DM's table;
- within the port, each trial's ``.cand``/``.txtcand`` has the bytes that
  ``cli.accelsearch``'s host prep gives the trial's ``.dat`` (both the
  float64 numpy rfft, rounded to complex64, dereddened);
- the journal fingerprint hashes the prep: a journalled rerun under the
  other prep redoes every accel unit, under the same prep none;
- ``--spectral`` with the host prep is refused, as in the reference.
"""

import glob
import os

import numpy as np
import pytest

from pypulsar_tpu.cli import sweep as jax_cli
from pypulsar_tpu.io import prestocand as jax_prestocand
from pypulsar_tpu_torch.cli import accelsearch as accel_cli
from pypulsar_tpu_torch.cli import sweep as cli
from pypulsar_tpu_torch.fourier.accelsearch import AccelSearchConfig
from pypulsar_tpu_torch.io import prestocand
from pypulsar_tpu_torch.io.filterbank import FilterbankFile
from pypulsar_tpu_torch.io.synth import write_synthetic_fil
from pypulsar_tpu_torch.parallel import accelpipe

DT, NSAMP, PERIOD, DM = 5e-4, 1 << 14, 256, 40.0
SIGMA = 3.0
SWEEP = ["--lodm", "0", "--dmstep", "10", "--numdms", "8", "-s", "8",
         "--group-size", "4", "--threshold", "6"]
ACCEL = ["--accel-search", "--accel-zmax", "20", "--accel-numharm", "4",
         "--accel-sigma", str(SIGMA), "--accel-batch", "4"]
HOST = ["--no-accel-device-prep"]


def _cand_files(prefix):
    return sorted(glob.glob(f"{prefix}_DM*_ACCEL_20.cand"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("hostprep")
    fil = str(d / "obs.fil")
    write_synthetic_fil(fil, nchan=64, tsamp=DT, nsamp=NSAMP, fch1=1500.0,
                        bw=256.0, dm=DM, period_samples=PERIOD, width=4,
                        seed=7)
    port, ref = str(d / "port"), str(d / "ref")
    assert cli.main([fil, "-o", port, *SWEEP, *ACCEL, *HOST, "--write-dats",
                     "--device", "cpu"]) == 0
    assert jax_cli.main([fil, "-o", ref, *SWEEP, *ACCEL, *HOST,
                         "--engine", "gather"]) == 0
    return dict(dir=d, fil=fil, port=port, ref=ref)


def test_host_prep_handoff_matches_reference(runs):
    port, ref = runs["port"], runs["ref"]
    ref_cands = _cand_files(ref)
    assert len(ref_cands) == len(_cand_files(port)) == 8
    for fr in ref_cands:
        fp = port + fr[len(ref):]
        a = jax_prestocand.read_rzwcands(fr)
        b = prestocand.read_rzwcands(fp)
        for x, pool, side in ((a, b, "reference"), (b, a, "port")):
            for c in x:
                if not any(abs(c.r - o.r) < 0.5 and abs(c.z - o.z) < 1.0
                           and abs(c.sig - o.sig) < 0.5 for o in pool):
                    assert c.sig <= SIGMA + 0.5, (side, fp, c.r, c.sig)
    T = NSAMP * DT
    f0 = 1.0 / (PERIOD * DT)
    best = prestocand.read_rzwcands(f"{port}_DM{DM:.2f}_ACCEL_20.cand")
    assert any(abs((c.r / T) / f0 - round((c.r / T) / f0)) < 0.02
               and round((c.r / T) / f0) >= 1 and c.sig > 8
               for c in best[:5])


def test_host_prep_handoff_gives_the_cli_bytes(runs, tmp_path):
    """Each trial's pair is what cli.accelsearch's host prep writes for
    the trial's .dat."""
    port = runs["port"]
    for fp in _cand_files(port):
        dat = fp[:-len("_ACCEL_20.cand")] + ".dat"
        out = str(tmp_path / os.path.basename(dat)[:-4])
        assert accel_cli.main([dat, "-z", "20", "-n", "4", "-s", str(SIGMA),
                               "--device", "cpu", "-o", out]) == 0
        for ext in ("cand", "txtcand"):
            with open(fp[:-len("cand")] + ext, "rb") as a, \
                    open(f"{out}_ACCEL_20.{ext}", "rb") as b:
                assert a.read() == b.read(), (fp, ext)


def test_journal_hashes_the_prep(runs, capsys):
    """A journal written under the device prep is restarted under the
    host prep (every accel unit redone); the same prep redoes none."""
    out = str(runs["dir"] / "jr")
    journal = out + ".jsonl"
    argv = [runs["fil"], "-o", out, *SWEEP, *ACCEL, "--journal", journal,
            "--device", "cpu"]
    assert cli.main(argv) == 0
    capsys.readouterr()
    assert cli.main(argv + HOST) == 0
    said = capsys.readouterr().out
    assert "accel handoff: 8 trials searched, 0 skipped" in said
    assert cli.main(argv + HOST) == 0
    said = capsys.readouterr().out
    assert "accel handoff: 0 trials searched, 8 skipped" in said


def test_spectral_with_host_prep_is_refused(runs):
    with pytest.raises(SystemExit) as exc:
        cli.main([runs["fil"], "-o", str(runs["dir"] / "x"), *SWEEP,
                  *ACCEL, *HOST, "--spectral", "--device", "cpu"])
    assert exc.value.code == 2
    with FilterbankFile(runs["fil"]) as reader, \
            pytest.raises(ValueError, match="IS device prep"):
        accelpipe.sweep_accel_stream(
            reader, np.array([0.0]), AccelSearchConfig(zmax=20.0),
            str(runs["dir"] / "y"), spectral=True, device_prep=False,
            device="cpu")
    assert not glob.glob(str(runs["dir"] / "x*"))
