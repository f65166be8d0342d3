"""The host modules behind ``sift --known-sources`` and ``pfd_snr``'s model
and sky-temperature options, against the JAX package on the CPU:
``candstore/match.py``, ``astro/healpix.py``, ``astro/skytemp.py``,
``astro/sextant.py``, ``fold/profile_snr.py``'s model alignment and
``core/psrmath.py``'s ``rotate`` and ``gaussian_profile``.

Contracts: the same float64 numpy arithmetic, so results are equal (exact
unless a tolerance is stated); the map writer's bytes are the JAX
package's (its no-astropy FITS codec, which it uses where astropy is not
installed).
"""

import json
import warnings

import numpy as np
import pytest

from pypulsar_tpu.astro import healpix as jax_healpix
from pypulsar_tpu.astro import sextant as jax_sextant
from pypulsar_tpu.astro import skytemp as jax_skytemp
from pypulsar_tpu.candstore import match as jax_match
from pypulsar_tpu.core import psrmath as jax_psrmath
from pypulsar_tpu.fold import profile_snr as jax_profile_snr
from pypulsar_tpu_torch.astro import healpix, sextant, skytemp
from pypulsar_tpu_torch.candstore import match
from pypulsar_tpu_torch.core import psrmath
from pypulsar_tpu_torch.fold import profile_snr

# ---------------------------------------------------------------------------
# candstore/match.py
# ---------------------------------------------------------------------------

CATALOG_TEXT = """# name   period_s   dm   [tol_p_frac]   [tol_dm]
B0531+21 0.0333924  56.77
J0437-47 0.00575745 2.64  0.0005        0.3
PSRX     0.262144   70.0
"""


def _catalogs(tmp_path):
    txt = tmp_path / "cat.txt"
    txt.write_text(CATALOG_TEXT)
    js = tmp_path / "cat.json"
    js.write_text(json.dumps([
        {"name": "B0531+21", "p_s": 0.0333924, "dm": 56.77},
        {"p_s": 0.262144, "dm": 70.0, "tol_p": 0.002},
        {"name": "J0437-47", "p_s": 0.00575745, "dm": 2.64, "tol_dm": 0.3}]))
    return str(txt), str(js)


def test_load_catalog_and_match_equal_reference(tmp_path):
    for fn in _catalogs(tmp_path):
        got, want = match.load_catalog(fn), jax_match.load_catalog(fn)
        assert [tuple(s) for s in got] == [tuple(s) for s in want]
        rng = np.random.default_rng(3)
        probes = [(0.262144, 70.0), (0.524288, 70.2), (0.131072, 69.8),
                  (0.262144 * 3 / 2, 70.0), (0.0333924, 56.0),
                  (0.00575745, 2.9), (0.00575745, 2.5), (0.3, 70.0)]
        probes += [(float(p), float(d)) for p, d in zip(
            rng.uniform(0.001, 2.0, 50), rng.uniform(0.0, 100.0, 50))]
        for p, dm in probes:
            a = match.match_known(p, dm, got)
            b = jax_match.match_known(p, dm, want)
            assert (a is None) == (b is None), (p, dm)
            if a is not None:
                assert tuple(a[0]) == tuple(b[0]) and a[1] == b[1]
                assert match.format_ratio(a[1]) == \
                    jax_match.format_ratio(b[1])
    for p, p0, tol in ((0.5, 0.25, 1e-3), (0.25, 0.5, 1e-3),
                       (0.75, 0.5, 1e-3), (0.0, 0.5, 1e-3),
                       (0.2501, 0.25, 1e-4), (0.25, 0.25, 0.0)):
        assert match.harmonic_ratio(p, p0, tol) == \
            jax_match.harmonic_ratio(p, p0, tol)


def test_catalog_errors_and_digest_equal_reference(tmp_path):
    bad = {"short.txt": "PSR 0.1\n", "nonnum.txt": "PSR x 10\n",
           "bad.json": "[{\"name\": 1", "nodm.json": "[{\"p_s\": 0.1}]"}
    for name, text in bad.items():
        fn = tmp_path / name
        fn.write_text(text)
        with pytest.raises(match.CatalogError) as got:
            match.load_catalog(str(fn))
        with pytest.raises(jax_match.CatalogError) as want:
            jax_match.load_catalog(str(fn))
        assert str(got.value) == str(want.value)
    with pytest.raises(match.CatalogError):
        match.load_catalog(str(tmp_path / "absent.txt"))
    txt, js = _catalogs(tmp_path)
    for fn in (txt, js, str(tmp_path / "absent.txt")):
        assert match.catalog_digest(fn) == jax_match.catalog_digest(fn)
    assert match.catalog_digest(str(tmp_path / "absent.txt")) == "missing"


# ---------------------------------------------------------------------------
# astro/healpix.py, astro/skytemp.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nside", [1, 4, 32])
def test_healpix_equals_reference(nside):
    n = healpix.npix(nside)
    assert n == jax_healpix.npix(nside)
    assert healpix.nside_from_npix(n) == nside
    for bad in (13, 47):
        with pytest.raises(ValueError):
            healpix.nside_from_npix(bad)
    pix = np.arange(n)
    for a, b in zip(healpix.pix2ang(nside, pix),
                    jax_healpix.pix2ang(nside, pix)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(nside)
    theta = np.arccos(rng.uniform(-1.0, 1.0, 400))
    phi = rng.uniform(-np.pi, 3 * np.pi, 400)
    theta[:4] = (0.0, np.pi, np.pi / 2, 1e-9)
    np.testing.assert_array_equal(healpix.ang2pix(nside, theta, phi),
                                  jax_healpix.ang2pix(nside, theta, phi))
    np.testing.assert_array_equal(healpix.ang2pix(nside, *healpix.pix2ang(
        nside, pix)), pix)
    m = rng.standard_normal(n)
    np.testing.assert_array_equal(healpix.get_interp_val(m, theta, phi),
                                  jax_healpix.get_interp_val(m, theta, phi))
    assert healpix.get_interp_val(m, 0.3, 1.0).shape == (1,)


def _plane_map(nside=32):
    pix = np.arange(healpix.npix(nside))
    theta, _ = healpix.pix2ang(nside, pix)
    return 10.0 + 40.0 * np.exp(-((theta - np.pi / 2) / 0.2) ** 2)


def test_write_healpix_map_bytes_equal_reference(tmp_path):
    m = _plane_map()
    a, b = str(tmp_path / "a.fits"), str(tmp_path / "b.fits")
    skytemp.write_healpix_map(a, m)
    jax_skytemp.write_healpix_map(b, m)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    np.testing.assert_array_equal(skytemp.read_map(a),
                                  m.astype(np.float32).astype(np.float64))
    odd = np.arange(healpix.npix(2), dtype=float)  # 48 pixels: one row
    skytemp.write_healpix_map(a, odd)
    jax_skytemp.write_healpix_map(b, odd)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_get_skytemp_on_a_synthetic_map(tmp_path):
    """The reference's synthetic-map test, and equality with the JAX
    ``get_skytemp`` on the same map at any (l, b) and frequency."""
    fn = str(tmp_path / "haslam.fits")
    skytemp.write_healpix_map(fn, _plane_map())
    assert skytemp.get_skytemp(0.0, 0.0, freq=408.0, mapfn=fn) == \
        pytest.approx(50.0, rel=0.05)
    assert skytemp.get_skytemp(0.0, 85.0, freq=408.0, mapfn=fn) == \
        pytest.approx(10.0, rel=0.05)
    rng = np.random.default_rng(5)
    gl, gb = rng.uniform(0, 360, 64), rng.uniform(-90, 90, 64)
    for freq, index in ((408.0, -2.7), (1400.0, -2.7), (1400.0, 0.0)):
        np.testing.assert_array_equal(
            skytemp.get_skytemp(gl, gb, freq=freq, index=index, mapfn=fn),
            jax_skytemp.get_skytemp(gl, gb, freq=freq, index=index,
                                    mapfn=fn))
    with pytest.raises((OSError, ValueError)):
        skytemp.get_skytemp(1.0, 1.0, mapfn=str(tmp_path / "absent.fits"))


def test_no_map_warns_and_approximates_as_the_reference(monkeypatch):
    monkeypatch.delenv("PYPULSAR_TPU_HASLAM", raising=False)
    gl, gb = np.array([0.0, 30.0, 300.0]), np.array([0.0, -5.0, 60.0])
    with pytest.warns(UserWarning, match="Haslam map unavailable"):
        got = skytemp.get_skytemp(gl, gb, freq=1400.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_skytemp.get_skytemp(gl, gb, freq=1400.0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(skytemp.approx_skytemp_408(gl, gb),
                                  jax_skytemp.approx_skytemp_408(gl, gb))
    assert skytemp.change_obsfreq(20.0, 408.0, 1400.0) == \
        jax_skytemp.change_obsfreq(20.0, 408.0, 1400.0)


# ---------------------------------------------------------------------------
# astro/sextant.py
# ---------------------------------------------------------------------------

RADEC = [("00:00:00.00", "00:00:00.00"), ("18:00:00.00", "-20:00:00.00"),
         ("05:34:31.94", "22:00:52.2"), ("12:30:00", "89:59:00")]


def test_sextant_equals_reference():
    for ra, dec in RADEC:
        for out in ("deg", "rad"):
            for j2000 in (True, False):
                a = sextant.equatorial_to_galactic(ra, dec, output=out,
                                                   J2000=j2000)
                b = jax_sextant.equatorial_to_galactic(ra, dec, output=out,
                                                       J2000=j2000)
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
        for fn in ("equatorial_to_ecliptic", "precess_J2000_to_B1950",
                   "precess_B1950_to_J2000"):
            assert getattr(sextant, fn)(ra, dec) == \
                getattr(jax_sextant, fn)(ra, dec), fn
        assert sextant.angsep(ra, dec, "06:00:00", "10:00:00") == \
            jax_sextant.angsep(ra, dec, "06:00:00", "10:00:00")
    for args in ((30.0, 40.0, 0.6), (300.0, -10.0, -0.4)):
        assert sextant.hadec_to_altaz(*args, input="deg") == \
            jax_sextant.hadec_to_altaz(*args, input="deg")
        assert sextant.altaz_to_hadec(*args) == \
            jax_sextant.altaz_to_hadec(*args)
        assert sextant.ecliptic_to_equatorial(*args[:2]) == \
            jax_sextant.ecliptic_to_equatorial(*args[:2])
    assert sextant.ha_from_lst(5.0, 3.5) == jax_sextant.ha_from_lst(5.0, 3.5)
    assert sextant.ha_from_mjdlon(58000.0, -79.8, 3.5) == \
        jax_sextant.ha_from_mjdlon(58000.0, -79.8, 3.5)


# ---------------------------------------------------------------------------
# fold/profile_snr.py's model alignment, core/psrmath.py's profiles
# ---------------------------------------------------------------------------

def test_psrmath_profiles_equal_reference():
    a = np.arange(17.0)
    for k in (0, 3, 17, -2, 40):
        np.testing.assert_array_equal(psrmath.rotate(a, k),
                                      jax_psrmath.rotate(a, k))
    for args in ((64, 0.2, 0.06), (128, 0.97, 0.1), (50, -0.3, 0.02)):
        np.testing.assert_array_equal(psrmath.gaussian_profile(*args),
                                      jax_psrmath.gaussian_profile(*args))


def test_gaussfitfile_equals_reference(tmp_path):
    """The reference's inputs (``tests/test_snr_stack.py``): two
    components and a constant; and a file whose counts differ."""
    fn = str(tmp_path / "g.gaussians")
    with open(fn, "w") as f:
        f.write("const = 1.0 +/- 0\n")
        f.write("phas1 = 0.25 +/- 0\nampl1 = 5.0 +/- 0\nfwhm1 = 0.05 +/- 0\n")
        f.write("phas2 = 0.60 +/- 0\nampl2 = 2.0 +/- 0\nfwhm2 = 0.10 +/- 0\n")
    comps, const = profile_snr.read_gaussfitfile(fn, 128)
    want, want_const = jax_profile_snr.read_gaussfitfile(fn, 128)
    np.testing.assert_array_equal(comps, want)
    assert const == want_const
    assert comps.shape == (2, 128) and np.argmax(comps[0]) == 32
    with open(fn, "a") as f:
        f.write("phas3 = 0.9 +/- 0\n")
    with pytest.raises(profile_snr.OnPulseError, match="differ"):
        profile_snr.read_gaussfitfile(fn, 128)


def test_model_alignment_equals_reference():
    """The reference's alignment case (``tests/test_snr_stack.py``): a
    Gaussian model rolled right by 10 bins, scaled and offset; and a
    two-component von Mises model on a noisy profile."""
    proflen = 64
    model = psrmath.gaussian_profile(proflen, 0.2, 0.06)
    prof = np.roll(model, 10) * 3 + 1
    rot = profile_snr.get_rotation(prof, model)
    assert rot == jax_profile_snr.get_rotation(prof, model)
    assert rot == pytest.approx(54.0 / 64.0, abs=1.0 / 64)
    np.testing.assert_array_equal(profile_snr.transform(model, rot, 3.0, 1.0),
                                  jax_profile_snr.transform(model, rot, 3.0,
                                                            1.0))
    mask = profile_snr.onpulse_from_model(prof, model)
    np.testing.assert_array_equal(mask,
                                  jax_profile_snr.onpulse_from_model(prof,
                                                                     model))
    assert mask[np.argmax(prof)]
    rng = np.random.default_rng(11)
    vm = (profile_snr.vonmises_profile(128, 0.3, 300.0)
          + 0.5 * profile_snr.vonmises_profile(128, 0.45, 80.0))
    np.testing.assert_array_equal(
        vm, jax_profile_snr.vonmises_profile(128, 0.3, 300.0)
        + 0.5 * jax_profile_snr.vonmises_profile(128, 0.45, 80.0))
    noisy = np.roll(vm, 37) * 8.0 + rng.standard_normal(128)
    for frac in (0.05, 0.3):
        np.testing.assert_array_equal(
            profile_snr.onpulse_from_model(noisy, vm, frac),
            jax_profile_snr.onpulse_from_model(noisy, vm, frac))
    got = profile_snr.find_scale_and_phase(noisy, vm)
    want = jax_profile_snr.find_scale_and_phase(noisy, vm)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    assert got[1] == want[1]
    with pytest.raises(profile_snr.OnPulseError):
        profile_snr.onpulse_from_model(noisy, np.zeros(128))
