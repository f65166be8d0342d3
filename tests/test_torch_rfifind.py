"""The port's mask stage (``ops/rfifind.py``, ``io/rfimask.py``,
``cli/rfifind.py``) and its mask fill (``ops/masking.py``) against the
JAX package on the CPU, on numpy inputs made from a seed.

Contracts:
- block statistics within the reference test's bounds of the float64
  twin and of JAX's (mean and std atol 1e-5, max power rtol 2e-3);
- the flags, and so the ``.mask`` bytes, equal JAX's; a differing flag
  must lie within those bounds of its threshold in the float64 twin
  (``decision_margins``), as the sweep proves ties;
- the fill values (``channel_maskvals``) and the filled block equal
  JAX's bit for bit: the medians are JAX's midpoint, not torch's lower
  middle value.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypulsar_tpu.cli import rfifind as jax_cli
from pypulsar_tpu.io.filterbank import FilterbankFile as JaxFilterbankFile
from pypulsar_tpu.io import rfimask as jax_rfimask
from pypulsar_tpu.ops import kernels as jax_kernels
from pypulsar_tpu.ops import rfifind as jax_rfifind
from pypulsar_tpu_torch.cli import rfifind as cli
from pypulsar_tpu_torch.io import rfimask
from pypulsar_tpu_torch.io.filterbank import FilterbankFile, write_filterbank
from pypulsar_tpu_torch.ops import masking, rfifind
from tests.torch_hermetic import hermetic_tune_cache  # noqa: F401

DT = 64e-6


def make_rfi_data(seed, C=64, nint=20, pts=512, offset=0.0, scale=1.0):
    """``tests/test_rfifind.py``'s interference on seeded noise: channel
    37 loud (20x std), intervals 5-6 broadband (+30 std), channel 50 a
    strong tone (period 16 samples)."""
    rng = np.random.RandomState(seed)
    T = nint * pts
    data = rng.randn(C, T).astype(np.float32)
    data[37 % C] *= 20.0
    data[:, 5 * pts:7 * pts] += 30.0
    t = np.arange(T)
    data[50 % C] += 12.0 * np.sin(2 * np.pi * t / 16.0).astype(np.float32)
    return data * np.float32(scale) + np.float32(offset), pts


def eight_bit_fil(path, data, dt=DT):
    """``data`` ([chan, time], high-frequency-first rows) rounded and
    clipped to 8 bits in a descending-band SIGPROC file."""
    C = data.shape[0]
    hdr = dict(nchans=C, tsamp=dt, fch1=1500.0, foff=-0.5, nbits=8,
               tstart=59000.0, source_name="RFI")
    write_filterbank(path, hdr,
                     np.clip(np.round(data.T), 0, 255).astype(np.uint8))
    return path


def both_rfifind(fil, **kw):
    """The port's ``rfifind`` (on the CPU) and JAX's on one file."""
    with FilterbankFile(fil) as r:
        ours = rfifind.rfifind(r, device="cpu", **{
            k: (v + "_port" if k == "outbase" else v) for k, v in kw.items()})
    with JaxFilterbankFile(fil) as r:
        theirs = jax_rfifind.rfifind(r, **{
            k: (v + "_ref" if k == "outbase" else v) for k, v in kw.items()})
    return ours, theirs


def decoded(data):
    """The samples ``eight_bit_fil`` stores for ``data``."""
    return np.clip(np.round(data), 0, 255).astype(np.float32)


def assert_flags_match(got, want, twin):
    """Equal flag tables, or every differing cell at its threshold."""
    diff = got != want
    if diff.any():
        assert (rfifind.decision_margins(twin)[diff] <= 1.0).all(), \
            np.argwhere(diff)


@pytest.mark.parametrize("C,nint,pts,offset,scale", [
    (8, 4, 100, 0.0, 1.0),  # the reference test's shape
    (16, 5, 333, 100.0, 40.0),  # offset-dominated, odd interval
    (32, 3, 1024, 0.0, 1.0),  # a power-of-two interval
])
def test_block_stats_match_twin_and_jax(C, nint, pts, offset, scale):
    rng = np.random.RandomState(C + pts)
    data = (rng.randn(C, nint * pts + 7) * scale + offset).astype(np.float32)
    got = [x.numpy() for x in rfifind.block_stats(torch.from_numpy(data),
                                                  pts)]
    twin = rfifind.block_stats_numpy(data, pts)
    ref = [np.asarray(x) for x in jax_rfifind.block_stats(data, pts)]
    for want in (twin, ref):
        assert got[0].shape == (nint, C)
        np.testing.assert_allclose(got[0], want[0], atol=1e-5)
        np.testing.assert_allclose(got[1], want[1], atol=1e-5)
        np.testing.assert_allclose(got[2], want[2], rtol=2e-3)
    for a, b in zip(twin, jax_rfifind.block_stats_numpy(data, pts)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 2, 3, 100, 1000, 1024, 1025, 15625])
def test_fourier_chunk_len_matches_jax(n):
    from pypulsar_tpu.ops.fourier_dedisperse import fourier_chunk_len

    assert rfifind.fourier_chunk_len(n) == fourier_chunk_len(n)


@pytest.mark.parametrize("T", [4, 5, 9, 10, 15, 16, 25, 101, 1000, 1001])
@pytest.mark.parametrize("kind", ["ties", "floats", "eight_bit",
                                  "offset"])
def test_channel_maskvals_equal_jax(T, kind):
    """The median-mid80 on even and odd lengths, both sides of numpy's
    half-to-even rounding of 0.1 T (T = 5, 15, 25): small integers with
    ties, float noise, decoded 8-bit samples, and noise on a large offset
    (where ``(lo + hi) * 0.5`` rounds in float32)."""
    rng = np.random.RandomState(T)
    data = {
        "ties": lambda: rng.randint(0, 6, size=(6, T)),
        "floats": lambda: rng.randn(6, T),
        "eight_bit": lambda: rng.randint(0, 256, size=(6, T)),
        "offset": lambda: rng.randn(6, T) * 3.0 + 1e5,
    }[kind]().astype(np.float32)
    got = masking.channel_maskvals(torch.from_numpy(data))
    want = np.asarray(jax_kernels.channel_maskvals(jnp.asarray(data),
                                                   "median-mid80"))
    np.testing.assert_array_equal(got.numpy(), want)


def test_median_is_the_midpoint_not_torchs_lower_value():
    # four samples cut none at either end: the whole row's median
    data = torch.tensor([[1.0, 2.0, 3.0, 10.0]])
    assert masking.channel_maskvals(data).item() == 2.5
    assert torch.median(data, dim=-1).values.item() == 2.0


def test_masked_equals_jax():
    rng = np.random.RandomState(3)
    data = rng.randint(0, 200, size=(16, 777)).astype(np.float32)
    mask = rng.rand(16, 777) < 0.2
    got = masking.masked(torch.from_numpy(data), torch.from_numpy(mask))
    want = jax_kernels.masked(jnp.asarray(data), jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[~mask], data[~mask])


@pytest.mark.parametrize("seed", [11, 12])
def test_rfifind_flags_and_mask_bytes_equal_jax(seed, tmp_path):
    data, pts = make_rfi_data(seed, offset=100.0, scale=8.0)
    # rows written reversed, so mask channel c is row c of ``data``
    fil = eight_bit_fil(str(tmp_path / "rfi.fil"), data[::-1])
    (stats, flags, fn), (ref_stats, ref_flags, ref_fn) = both_rfifind(
        fil, time=pts * DT, outbase=str(tmp_path / "x"))
    assert stats.nint == 20 and stats.nchan == 64
    assert flags[:, 37].all() and flags[:, 50].all()
    assert flags[5].mean() > 0.8 and flags[6].mean() > 0.8
    twin = rfifind.RfiStats(*rfifind.block_stats_numpy(decoded(data), pts),
                            pts, pts * DT, 0.0, 0.0)
    assert_flags_match(flags, ref_flags, twin)
    if (flags == ref_flags).all():
        with open(fn, "rb") as a, open(ref_fn, "rb") as b:
            assert a.read() == b.read()
    assert stats.mask_coverage == pytest.approx(ref_stats.mask_coverage)
    back = rfifind.RfiStats.load(str(tmp_path / "x_port_rfifind.stats.npz"))
    np.testing.assert_array_equal(back.maxpow, stats.maxpow)
    assert back.mask_coverage == stats.mask_coverage


@pytest.mark.parametrize("nint,tail,want", [(3, 120, 4), (3, 50, 3),
                                             (4, 100, 5), (2, 0, 2)])
def test_partial_tail_interval_like_jax(nint, tail, want, tmp_path):
    """A tail of half an interval or more is padded with its last sample
    into one more interval; a shorter one is dropped."""
    data = np.random.RandomState(nint + tail).randn(
        8, nint * 200 + tail) * 20.0 + 128.0
    fil = eight_bit_fil(str(tmp_path / "t.fil"), data)
    (stats, _, _), (ref, _, _) = both_rfifind(fil, time=200 * DT)
    assert stats.nint == ref.nint == want
    np.testing.assert_allclose(stats.mean, ref.mean, atol=1e-5)
    np.testing.assert_allclose(stats.std, ref.std, atol=1e-5)


def test_cli_mask_bytes_equal_jax(tmp_path):
    """The CLI on an 8-bit file, read in several blocks with a carry
    (``ints_per_read`` 16 over 20 intervals plus a padded tail), against
    the JAX CLI on the same file, with extra zaps."""
    data, pts = make_rfi_data(7, C=32, nint=20, pts=256, offset=100.0,
                              scale=8.0)
    data = np.concatenate([data, data[:, :200]], axis=1)
    fil = eight_bit_fil(str(tmp_path / "rfi.fil"), data)
    argv = ["-t", str(pts * DT), "--zapchan", "2,9:10", "--zapints", "13"]
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    assert cli.main([fil, "-o", ours, *argv, "--device", "cpu"]) == 0
    assert jax_cli.main([fil, "-o", theirs, *argv]) == 0
    got = rfifind.RfiStats.load(ours + "_rfifind.stats.npz")
    want = jax_rfifind.RfiStats.load(theirs + "_rfifind.stats.npz")
    assert got.nint == want.nint == 21
    np.testing.assert_allclose(got.mean, want.mean, atol=1e-5)
    np.testing.assert_allclose(got.std, want.std, atol=1e-5)
    np.testing.assert_allclose(got.maxpow, want.maxpow, rtol=2e-3)
    with open(ours + "_rfifind.mask", "rb") as a, \
            open(theirs + "_rfifind.mask", "rb") as b:
        assert a.read() == b.read()
    mask = rfimask.RfifindMask(ours + "_rfifind.mask")
    # file rows are high-frequency-first: loud row 37 % 32 = 5 is mask
    # channel 26, the tone's row 50 % 32 = 18 is channel 13
    assert {2, 9, 10, 13, 26} <= mask.mask_zap_chans_set
    assert 13 in mask.mask_zap_ints.tolist()
    assert mask.lofreq == pytest.approx(1500.0 - 0.5 * 31)
    assert mask.MJD == 59000.0


def test_mask_files_read_the_same_in_both_packages(tmp_path):
    kw = dict(nchan=12, nint=5, ptsperint=100, zap_chans=[7, 1],
              zap_ints=[3], zap_chans_per_int=[[2], [], [4, 0], [], [11]])
    ours, theirs = str(tmp_path / "a.mask"), str(tmp_path / "b.mask")
    rfimask.write_mask(ours, **kw)
    jax_rfimask.write_mask(theirs, **kw)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert not os.path.exists(ours + ".tmp")
    for fn in (ours, theirs):
        a, b = rfimask.RfifindMask(fn), jax_rfimask.RfifindMask(fn)
        np.testing.assert_array_equal(a._zap_table, b._zap_table)
        np.testing.assert_array_equal(a.get_sample_mask(250, 400),
                                      b.get_sample_mask(250, 400))
        assert (a.nchan, a.nint, a.ptsperint, a.dtint) == \
            (b.nchan, b.nint, b.ptsperint, b.dtint)


def test_mask_products_like_jax():
    flags = np.random.RandomState(2).rand(10, 16) < 0.3
    flags[:, 3] = True
    flags[7, :12] = True
    args = dict(chanfrac=0.7, intfrac=0.3, extra_zap_chans=[12],
                extra_zap_ints=[1])
    assert rfifind.mask_products(flags, **args) == \
        jax_rfifind.mask_products(flags, **args)
    for bad in (dict(extra_zap_chans=[16]), dict(extra_zap_ints=[10])):
        with pytest.raises(ValueError):
            rfifind.mask_products(flags, **bad)


def test_decision_margins_locate_thresholds():
    """A max power placed on the Fourier threshold has margin 0, a clean
    cell a margin far above 1."""
    data, pts = make_rfi_data(5, C=16, nint=10, pts=256)
    stats = rfifind.RfiStats(*rfifind.block_stats_numpy(data, pts), pts,
                             pts * 1e-3, 0.0, 0.0)
    stats.maxpow[4, 3] = rfifind.power_threshold(pts, 4.0)
    m = rfifind.decision_margins(stats)
    assert m.shape == (10, 16)
    assert m[4, 3] == 0.0
    assert np.median(m) > 10


def _card_default(tmp_path, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default path would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def test_rfifind_defaults_to_the_card(tmp_path):
    data, _ = make_rfi_data(1, C=16, nint=4, pts=256, offset=100.0,
                            scale=8.0)
    fil = eight_bit_fil(str(tmp_path / "a.fil"), data)
    assert cli.build_parser().get_default("device") == "cuda"
    _card_default(tmp_path, [fil, "-o", str(tmp_path / "a")])
    assert not os.path.exists(str(tmp_path / "a_rfifind.mask"))
