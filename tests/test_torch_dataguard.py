"""The data guard's recipes in the port (``resilience/dataguard.py``:
``corrupt_file``, ``fuzz_mutate``, ``run_reader_fuzz``,
``reader_quality``; ``guard_source(enabled=)`` and ``MAX_BAD_FRAC`` for
the reference's environment switches) on the CPU, against the JAX
package.

Contracts:
- ``corrupt_file`` gives the reference's bytes for each kind and seed,
  on a SIGPROC file (payload after its header) and on a headerless one;
- ``fuzz_mutate`` gives the reference's bytes for a seeded generator;
- ``run_reader_fuzz`` over the port's own readers (``filterbank``,
  ``psrfits``, ``dat``), 60 mutations each at seed 11 (the reference's
  tier-1 slice): no failure, and the reference's outcome counts;
- the switches: ``guard_source(src, enabled=False)`` is the source
  itself, ``MAX_BAD_FRAC`` the reference's default.
"""

import os
import shutil

import numpy as np
import pytest

from pypulsar_tpu.resilience import dataguard as jax_dg
from pypulsar_tpu_torch.io.datfile import write_dat
from pypulsar_tpu_torch.io.errors import DataFormatError
from pypulsar_tpu_torch.io.filterbank import FilterbankFile, write_filterbank
from pypulsar_tpu_torch.io.infodata import InfoData
from pypulsar_tpu_torch.resilience import dataguard, faultinject


@pytest.fixture(autouse=True)
def _clean_faults():
    faultinject.reset()
    yield
    faultinject.reset()


def _fil(path, nbits=32, T=1024, C=16, seed=3):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((T, C)).astype(np.float32) * 4.0 + 30.0
    if nbits == 8:
        data = np.clip(np.round(data), 0, 255).astype(np.uint8)
    write_filterbank(str(path), dict(nchans=C, tsamp=1e-3, fch1=1500.0,
                                     foff=-1.0, nbits=nbits), data)
    return str(path)


def _twins(tmp_path, make, name):
    """The same file in two directories under one basename (the recipe
    seeds from the basename), the port's and the reference's copy."""
    for side in ("port", "ref"):
        (tmp_path / side).mkdir(exist_ok=True)
    a = make(tmp_path / "port" / name)
    b = str(tmp_path / "ref" / name)
    shutil.copyfile(a, b)
    return a, b


@pytest.mark.parametrize("nbits", [32, 8])
@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("kind", dataguard.CORRUPT_KINDS)
def test_corrupt_file_gives_the_references_bytes(tmp_path, kind, seed,
                                                 nbits):
    assert dataguard.CORRUPT_KINDS == jax_dg.CORRUPT_KINDS
    a, b = _twins(tmp_path, lambda p: _fil(p, nbits=nbits), "obs.fil")
    with open(a, "rb") as f:
        pristine = f.read()
    desc = dataguard.corrupt_file(a, kind, seed=seed)
    ref = jax_dg.corrupt_file(b, kind, seed=seed)
    with open(a, "rb") as f, open(b, "rb") as g:
        got, want = f.read(), g.read()
    assert got == want and got != pristine
    assert {k: v for k, v in desc.items() if k != "path"} == \
        {k: v for k, v in ref.items() if k != "path"}


def test_corrupt_file_on_a_headerless_file_and_a_bad_kind(tmp_path):
    def dat(p):
        inf = InfoData()
        inf.epoch, inf.dt, inf.DM = 55000.0, 1e-3, 10.0
        base = str(p)[:-4]
        write_dat(base, np.arange(512, dtype=np.float32), inf)
        return base + ".dat"

    for kind in ("dropblock", "nanburst", "dcjump", "bitflip"):
        a, b = _twins(tmp_path, dat, f"{kind}.dat")
        dataguard.corrupt_file(a, kind, seed=2)
        jax_dg.corrupt_file(b, kind, seed=2)
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read()
    with pytest.raises(ValueError, match="unknown corruption kind"):
        dataguard.corrupt_file(a, "gamma_ray")


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_mutate_gives_the_references_bytes(seed):
    base = bytes(range(256)) * 8
    for tag in ("t", "fuzz:filterbank"):
        mine = dataguard._rng(seed, tag)
        ref = jax_dg._rng(seed, tag)
        for _ in range(25):
            assert dataguard.fuzz_mutate(base, mine) == \
                jax_dg.fuzz_mutate(base, ref)
    assert dataguard.fuzz_mutate(b"", dataguard._rng(seed, "t")) == b""


@pytest.mark.parametrize("fmt", dataguard.FUZZ_FORMATS)
def test_reader_fuzz_has_no_failure(fmt, tmp_path):
    counts, failures = dataguard.run_reader_fuzz(
        fmt, 60, 11, str(tmp_path / "port"), device="cpu")
    assert not failures, f"contract violations: {failures[:5]}"
    assert sum(counts.values()) == 60
    ref, ref_failures = jax_dg.run_reader_fuzz(fmt, 60, 11,
                                               str(tmp_path / "ref"))
    assert not ref_failures and counts == ref


def test_reader_fuzz_refuses_an_unknown_format(tmp_path):
    with pytest.raises(ValueError, match="unknown fuzz format"):
        dataguard.run_reader_fuzz("wapp", 1, 0, str(tmp_path))


def test_reader_quality_reports_a_salvaged_prefix(tmp_path):
    fn = _fil(tmp_path / "cut.fil")
    fb = FilterbankFile(fn)
    try:
        assert dataguard.reader_quality(fb) is None
    finally:
        fb.close()
    dataguard.corrupt_file(fn, "truncate", seed=1)
    with pytest.warns(UserWarning):
        fb = FilterbankFile(fn)
    try:
        q = dataguard.reader_quality(fb)
        assert q is not None and q["missing_samples"] > 0
    finally:
        fb.close()
    dataguard.corrupt_file(fn, "header", seed=1)
    with pytest.raises(DataFormatError):
        FilterbankFile(fn)


def test_the_reference_switches_are_a_keyword_and_a_constant():
    class FloatSource:
        frequencies = np.array([1500.0])
        tsamp = 1e-3
        nsamples = 8

    src = FloatSource()
    assert isinstance(dataguard.guard_source(src), dataguard.GuardedSource)
    assert dataguard.guard_source(src, enabled=False) is src
    assert dataguard.MAX_BAD_FRAC == jax_dg.max_bad_frac_default()
