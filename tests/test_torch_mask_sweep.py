"""rfifind masks on the port's sweep stage (``cli.sweep --mask``,
``parallel/staged.py``'s ``MaskedSource``) against the JAX ``gather``
engine given the same ``.mask``, on the CPU, on an 8-bit file with a
pulsar and interference written into it from a seed.

Contracts (as in ``tests/test_torch_accelpipe.py``, now under a mask):
- ``.dat`` bytes identical: the fill values are medians of integers
  (halves at most), whose sums are exact in any order;
- ``.cands`` rows equal in DM, sample, width and downsampling, SNR
  within 1e-3;
- every trial's ``.cand`` under the matched-candidate contract (dr, dz,
  dsig) = (0.5, 1.0, 0.5) above ``sigma_min + 0.5``.
"""

import glob

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypulsar_tpu.cli import sweep as jax_cli
from pypulsar_tpu.io import prestocand as jax_prestocand
from pypulsar_tpu.io import rfimask as jax_rfimask
from pypulsar_tpu.parallel import staged as jax_staged
from pypulsar_tpu_torch.cli import rfifind as rfifind_cli
from pypulsar_tpu_torch.cli import sweep as cli
from pypulsar_tpu_torch.io import prestocand
from pypulsar_tpu_torch.io.filterbank import FilterbankFile, write_filterbank
from pypulsar_tpu_torch.io.rfimask import RfifindMask, write_mask
from pypulsar_tpu_torch.io.synth import write_synthetic_fil
from pypulsar_tpu_torch.parallel import staged
from tests.torch_hermetic import hermetic_tune_cache  # noqa: F401

DT, NSAMP, PERIOD, DM = 5e-4, 1 << 14, 256, 40.0
SIGMA = 3.0
SWEEP = ["--lodm", "0", "--dmstep", "10", "--numdms", "8", "-s", "8",
         "--group-size", "4", "--threshold", "6", "--chunk", "3000"]
ACCEL = ["--accel-search", "--accel-zmax", "20", "--accel-numharm", "4",
         "--accel-sigma", str(SIGMA), "--accel-batch", "4"]
TONE_ROWS = (20, 21, 22)  # file rows (the band descends)


def inject_rfi(fil, tone_rows=TONE_ROWS, interval=(4000, 6000), seed=0):
    """Interference in an 8-bit file's data bytes: a 0/255 square wave of
    period 16 samples on ``tone_rows``, +25 counts over ``interval`` on
    every channel and a few bright single-sample spikes."""
    with FilterbankFile(fil) as r:
        off, C, T = r.header_size, r.nchans, r.nspec
    data = np.memmap(fil, dtype=np.uint8, mode="r+", offset=off, shape=(T, C))
    data[interval[0]:interval[1]] += np.uint8(25)
    tone = np.where((np.arange(T) // 8) % 2 == 0, 0, 255).astype(np.uint8)
    for row in tone_rows:
        data[:, row] = tone
    rng = np.random.RandomState(seed)
    data[rng.randint(0, T, 5), rng.randint(0, C, 5)] = 255
    data.flush()
    del data


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("masksweep")
    fil = str(d / "obs.fil")
    write_synthetic_fil(fil, nchan=64, tsamp=DT, nsamp=NSAMP, fch1=1500.0,
                        bw=256.0, dm=DM, period_samples=PERIOD, width=4,
                        seed=3)
    inject_rfi(fil)
    base = str(d / "obs")
    assert rfifind_cli.main([fil, "-o", base, "-t", "1.0",
                             "--device", "cpu"]) == 0
    mask = base + "_rfifind.mask"
    port, ref, plain = str(d / "port"), str(d / "ref"), str(d / "plain")
    assert cli.main([fil, "-o", port, *SWEEP, *ACCEL, "--write-dats",
                     "--mask", mask, "--device", "cpu"]) == 0
    assert jax_cli.main([fil, "-o", ref, *SWEEP, *ACCEL, "--write-dats",
                         "--mask", mask, "--engine", "gather"]) == 0
    assert cli.main([fil, "-o", plain, *SWEEP, "--write-dats",
                     "--device", "cpu"]) == 0
    return dict(dir=d, fil=fil, mask=mask, port=port, ref=ref, plain=plain)


def _rel(path, prefix):
    assert path.startswith(prefix)
    return path[len(prefix):]


def _cands_rows(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return [(float(p[0]), float(p[1]), float(p[2]), int(p[3]), int(p[4]),
             int(p[5])) for p in (ln.split() for ln in lines[1:])]


def test_the_mask_zaps_the_interference(runs):
    mask = RfifindMask(runs["mask"])
    assert {63 - r for r in TONE_ROWS} <= mask.mask_zap_chans_set
    assert 2 in mask.mask_zap_ints.tolist()  # samples 4000..5999
    assert mask._zap_table.mean() < 0.2


def test_masked_dats_equal_jax_and_differ_unmasked(runs):
    port, ref, plain = runs["port"], runs["ref"], runs["plain"]
    dats = sorted(glob.glob(ref + "_DM*.dat"))
    assert len(dats) == 8
    for fr in dats:
        with open(fr, "rb") as a, open(port + _rel(fr, ref), "rb") as b:
            masked = b.read()
            assert a.read() == masked, fr
        with open(plain + _rel(fr, ref), "rb") as c:
            assert c.read() != masked


def test_masked_cands_match_jax(runs):
    got = _cands_rows(runs["port"] + ".cands")
    want = _cands_rows(runs["ref"] + ".cands")
    assert len(want) > 0 and len(got) == len(want)
    for g, r in zip(got, want):
        assert (g[0], g[3], g[4], g[5]) == (r[0], r[3], r[4], r[5])
        assert abs(g[1] - r[1]) <= 1e-3 + 1e-9


def test_masked_accel_cands_match_jax(runs):
    port, ref = runs["port"], runs["ref"]
    ref_cands = sorted(glob.glob(ref + "_DM*_ACCEL_20.cand"))
    assert len(ref_cands) == 8
    for fr in ref_cands:
        fp = port + _rel(fr, ref)
        a = jax_prestocand.read_rzwcands(fr)
        b = prestocand.read_rzwcands(fp)
        for x, pool, side in ((a, b, "reference"), (b, a, "port")):
            for c in x:
                if not any(abs(c.r - o.r) < 0.5 and abs(c.z - o.z) < 1.0
                           and abs(c.sig - o.sig) < 0.5 for o in pool):
                    assert c.sig <= SIGMA + 0.5, (fp, side, c)
    T, f0 = NSAMP * DT, 1.0 / (PERIOD * DT)
    psr = prestocand.read_rzwcands(port + "_DM40.00_ACCEL_20.cand")
    assert any(abs((c.r / T) / f0 - round((c.r / T) / f0)) < 0.02
               and (c.r / T) / f0 > 0.5 and c.sig > 10 for c in psr[:10])


def _spiky_fil(path, C=32, T=6144, dt=1e-3, seed=3):
    """``tests/test_rfifind.py``'s sweep case in 8 bits: a 10-sigma
    dispersed pulse at DM 40 and bursty RFI in row 6 that drowns it."""
    from pypulsar_tpu_torch.core import psrmath

    rng = np.random.RandomState(seed)
    freqs = 1500.0 - 4.0 * np.arange(C)
    data = 60.0 + 2.0 * rng.randn(C, T)
    bins = psrmath.bin_delays(DM, freqs, dt)
    for c in range(C):
        if 900 + bins[c] < T:
            data[c, 900 + bins[c]] += 20.0
    data[6, ::37] += 120.0
    write_filterbank(path, dict(nchans=C, tsamp=dt, fch1=1500.0, foff=-4.0,
                                nbits=8),
                     np.clip(np.round(data.T), 0, 255).astype(np.uint8))
    return path


def test_sweep_with_mask_suppresses_rfi(tmp_path):
    """The port's counterpart of ``tests/test_rfifind.py::
    test_sweep_with_mask_suppresses_rfi``: rfifind's mask of the spiky
    channel lets the sweep find the pulse it drowned."""
    from pypulsar_tpu_torch.ops.rfifind import rfifind

    fil = _spiky_fil(str(tmp_path / "spiky.fil"))
    with FilterbankFile(fil) as r:
        _, flags, _ = rfifind(r, time=512e-3, outbase=str(tmp_path / "s"),
                              device="cpu")
        assert flags[:, 32 - 1 - 6].all()
        mask = RfifindMask(str(tmp_path / "s_rfifind.mask"))
        dms = np.arange(0.0, 80.0, 2.0)
        masked = staged.sweep_flat(r, dms, nsub=8, group_size=8,
                                   rfimask=mask, device="cpu").best(1)[0]
        raw = staged.sweep_flat(r, dms, nsub=8, group_size=8,
                                device="cpu").best(1)[0]
    assert abs(masked["dm"] - DM) <= 4.0
    assert masked["snr"] > 7.0
    assert raw["snr"] < masked["snr"] or abs(raw["dm"] - DM) > 4.0


def test_mask_tag_distinguishes_masks(tmp_path):
    assert staged.mask_tag(None) == ""
    fn1, fn2 = str(tmp_path / "a.mask"), str(tmp_path / "b.mask")
    write_mask(fn1, nchan=8, nint=4, ptsperint=100, zap_chans=[1])
    write_mask(fn2, nchan=8, nint=4, ptsperint=100, zap_chans=[2])
    t1, t2 = staged.mask_tag(RfifindMask(fn1)), staged.mask_tag(
        RfifindMask(fn2))
    assert t1.startswith("/mask=") and t1 != t2
    assert t1 == jax_staged._mask_tag(jax_rfimask.RfifindMask(fn1))


@pytest.mark.parametrize("pos,L", [(0, 350), (130, 200), (250, 40),
                                   (390, 300), (1000, 64)])
def test_masked_block_matches_jax_and_the_sample_mask(tmp_path, pos, L):
    """The fill of one block at file position ``pos``: JAX's
    ``_masked_block`` bit for bit, and the mask of each sample
    ``get_sample_mask`` gives (the last interval reused past the end)."""
    fn = str(tmp_path / "m.mask")
    write_mask(fn, nchan=6, nint=4, ptsperint=100, zap_chans=[0],
               zap_ints=[2], zap_chans_per_int=[[1], [4, 5], [], [3]])
    mask = RfifindMask(fn)
    rng = np.random.RandomState(pos)
    data = rng.randint(0, 50, size=(6, L)).astype(np.float32)
    table = np.ascontiguousarray(mask._zap_table[:, ::-1])  # hi-first
    base, rem = min(pos // 100, 3), pos % 100
    got = staged.masked_block(torch.from_numpy(data),
                              torch.from_numpy(table), base, rem, 100)
    want = jax_staged._masked_block(jnp.asarray(data), jnp.asarray(table),
                                    base, rem, 100)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    zapped = mask.get_sample_mask(pos, L)[::-1]
    np.testing.assert_array_equal(got.numpy()[~zapped], data[~zapped])


class _Blocks:
    """A source of fixed [C, L] blocks every ``step`` samples."""

    frequencies = np.array([3.0, 2.0, 1.0])
    tsamp, nsamples = 1e-3, 1000

    def __init__(self, step):
        self.step = step
        self.blocks = []

    def chan_major_blocks(self, payload, overlap, device):
        for pos in range(0, self.nsamples, self.step):
            b = torch.arange(3 * (self.step + 5), dtype=torch.float32
                             ).reshape(3, -1)
            self.blocks.append(b)
            yield pos, b


def test_blocks_without_zaps_pass_through(tmp_path):
    fn = str(tmp_path / "m.mask")
    write_mask(fn, nchan=3, nint=10, ptsperint=100,
               zap_chans_per_int=[[], [], [], [1], [], [], [], [], [], []])
    src = _Blocks(150)
    out = list(staged.MaskedSource(src, RfifindMask(fn), "cpu")
               .chan_major_blocks(150, 5, "cpu"))
    filled = [b is not raw for (_, b), raw in zip(out, src.blocks)]
    # blocks [150, 305) and [300, 455) touch interval 3 (samples 300..399,
    # the first through its overlap); no other block does
    assert filled == [False, True, True, False, False, False, False]
