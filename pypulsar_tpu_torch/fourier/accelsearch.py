"""Fourier-domain acceleration search: the (r, z) = (frequency, drift) plane.

Port of ``pypulsar_tpu/fourier/accelsearch.py``. The host half (the
significance code, the configuration, the template banks, the segment
geometry and the float64 refinement) is a copy; the device half is plain
PyTorch on complex64 tensors: ``torch.fft`` (cuFFT on the card),
elementwise products, ``index_select`` and ``torch.topk``.

The search correlates a normalized spectrum (unit mean noise power, see
:mod:`~pypulsar_tpu_torch.fourier.kernels`) with a bank of constant-
:math:`\\dot f` templates (:mod:`~pypulsar_tpu_torch.fourier.zresponse`) for
every drift ``z`` in ``[-zmax, zmax]`` and sums harmonics:

- the bank of one subharmonic ratio is one ``[rows, L]`` complex64 array
  (rows = 2 * Z * Wn: interleaved integer/half-bin phase rows), FFT'd once
  on the host and cached;
- the spectrum streams through in segments of the top harmonic's grid;
  per segment, ratio bank and spectrum, one ``fft -> multiply -> ifft ->
  |.|^2`` over ``[rows, L]``, then a stretch gather that maps the
  subharmonic's bins onto the top harmonic's half-bin columns (the
  spectra of a batch share the device-resident banks, and each
  spectrum's transforms are calls of their own, so its results do not
  depend on the batch);
- each harmonic stage H in (1, 2, 4, 8) builds its own plane; detection
  (4-neighbour local maximum over the threshold, top-k per segment, and
  the 3x3 neighbourhood of each hit) runs on the device, so only the
  top-k records of each segment reach the host, once per stage chunk;
- the host fits parabolas in r and z and converts powers to
  trials-corrected equivalent-Gaussian significance in float64.

Calibration: with unit-mean noise power and unit-energy templates, every
plane power is mean-1 exponential under noise, and an H-harmonic sum is
Gamma(H, 1), so significance follows from ``gammaincc(H, P)``.

Where the reference reads a tuning knob the port takes a keyword with the
knob's default: ``hbm_budget_bytes`` (5e9) and ``bank_cache_bytes`` (4e9).

Telemetry: each stage chunk's dispatch is an ``accel_stage_batch`` span
and counts in ``accel.stage_dispatches`` (its fault point,
``accel.stage_dispatch``, sits inside the OOM halving); a finished batch
counts its spectra in ``accel.spectra_searched`` and itself in
``accel.batches``. :func:`accel_search` is a batch of one, so the
reference's serial ``accel_stage`` span is an ``accel_stage_batch`` span
here.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import warnings
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.special import gammaincc, gammainccinv, gammaln, log_ndtr, ndtri

from pypulsar_tpu_torch.core.device import count_d2h, resolve_device
from pypulsar_tpu_torch.fourier.zresponse import template_bank_zw
from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.ops.fourier_dedisperse import fourier_chunk_len
from pypulsar_tpu_torch.resilience import faultinject
from pypulsar_tpu_torch.resilience.retry import halving_dispatch

__all__ = [
    "AccelSearchConfig",
    "AccelCandidate",
    "accel_search",
    "accel_search_batch",
    "equivalent_gaussian_sigma",
    "power_threshold",
]

HARM_STAGES = (1, 2, 4, 8)
#: device bytes the batched search plans its stage chunks for
ACCEL_HBM_BYTES = 5e9
#: host bytes of cached template banks
BANK_CACHE_BYTES = 4e9

#: the accel search's process-wide counters, bumped by both of its
#: drivers (``cli.accelsearch`` and the sweep's handoff,
#: ``parallel.accelpipe``): ``accel.serial_fallbacks`` (failed batches
#: searched one spectrum at a time), ``accel.bytes_read`` (the CLI's
#: input bytes read), ``accel.prep_cap`` (the most series one device
#: prep of the CLI took); ``.clear()`` resets them
COUNTERS: collections.Counter = collections.Counter()


# ---------------------------------------------------------------------------
# significance (host, float64)
# ---------------------------------------------------------------------------


def _log_gamma_sf(power: float, numsum: int) -> float:
    """log of P(X > power) for X ~ Gamma(numsum, 1) (sum of ``numsum``
    unit-mean exponential powers), stable for large powers where
    ``gammaincc`` underflows."""
    p = gammaincc(numsum, power)
    if p > 1e-280:
        return float(np.log(p))
    # asymptotic tail: p ~ power^(numsum-1) e^-power / Gamma(numsum)
    return float((numsum - 1) * np.log(power) - power - gammaln(numsum))


def equivalent_gaussian_sigma(logp: float) -> float:
    """Gaussian sigma whose upper-tail probability is ``exp(logp)``.

    Uses ``ndtri`` directly where the probability is representable; in the
    far tail solves ``log_ndtr(-x) = logp`` by Newton iteration."""
    if logp > -700.0:
        p = math.exp(logp)
        if p >= 1.0:
            return 0.0
        return float(-ndtri(p))
    # seed from log Q(x) ~ -x^2/2 - log(x sqrt(2 pi))
    x = math.sqrt(-2.0 * logp)
    for _ in range(6):
        f = log_ndtr(-x) - logp
        # d/dx log Q(x) = -phi(x)/Q(x)
        df = -math.exp(-0.5 * x * x - 0.5 * math.log(2 * math.pi) - log_ndtr(-x))
        step = f / df
        x -= step
        if abs(step) < 1e-10:
            break
    return float(x)


def candidate_sigma(power: float, numsum: int, numindep: float) -> float:
    """Equivalent Gaussian significance of a summed power ``power`` over
    ``numsum`` harmonics given ``numindep`` independent trials."""
    logp1 = _log_gamma_sf(power, numsum)
    # p_total = 1 - (1-p1)^numindep, computed in log space
    if logp1 > math.log(1e-8):
        p1 = math.exp(logp1)
        ptot = -math.expm1(numindep * math.log1p(-p1))
        logp = math.log(max(ptot, 1e-320))
    else:
        logp = logp1 + math.log(numindep)
    return equivalent_gaussian_sigma(min(logp, 0.0))


def power_threshold(sigma: float, numsum: int, numindep: float) -> float:
    """Summed-power threshold whose significance is ``sigma`` after the
    ``numindep`` trials correction (inverse of candidate_sigma)."""
    # invert the trials correction p_total = 1 - (1 - p1)^numindep:
    # p1 = -expm1(log1p(-p_total)/numindep), ~ p_total/numindep when tiny
    logp = log_ndtr(-sigma)
    if logp > math.log(1e-8):
        p1 = -math.expm1(math.log1p(-math.exp(logp)) / numindep)
    else:
        p1 = math.exp(logp - math.log(numindep))
    p1 = min(max(p1, 1e-320), 1.0)
    return float(gammainccinv(numsum, p1))


# ---------------------------------------------------------------------------
# configuration / results
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AccelSearchConfig:
    zmax: float = 200.0
    dz: float = 2.0
    numharm: int = 8  # highest harmonic stage (1, 2, 4 or 8)
    sigma_min: float = 2.0
    flo: float = 1.0  # Hz, lowest searched fundamental frequency
    fhi: Optional[float] = None  # Hz, default Nyquist
    seg_width: int = 1 << 14  # fundamental bins per device segment
    topk: int = 64  # max raw hits per (segment, stage)
    min_halfwidth: int = 24
    # jerk search (PRESTO -wmax equivalent): wmax > 0 extends the template
    # bank to a (z, w) product grid — cost scales by len(ws)
    wmax: float = 0.0
    dw: float = 20.0
    # coarse-to-fine z search: > dz runs every stage first on a coarse z
    # grid at this spacing with the power threshold scaled by
    # coarse_power_frac, then re-searches ONLY the segments with coarse
    # hits at the fine dz (worst-case matched-power retention at
    # coarse_dz = 2*dz is ~0.84, so the 0.7 default leaves margin).
    # 0 = single-pass.
    coarse_dz: float = 0.0
    coarse_power_frac: float = 0.7

    def __post_init__(self):
        if not 0.0 < self.coarse_power_frac <= 1.0:
            raise ValueError(f"coarse_power_frac must be in (0, 1]; got "
                             f"{self.coarse_power_frac}")
        if self.coarse_dz != 0.0 and self.coarse_dz <= self.dz:
            warnings.warn(
                f"coarse_dz={self.coarse_dz} <= dz={self.dz} has no "
                f"effect: the coarse-to-fine prepass only runs when "
                f"coarse_dz > dz", stacklevel=2)
        elif self.coarse_dz > 2.0 * self.dz:
            warnings.warn(
                f"coarse_dz={self.coarse_dz} > 2*dz: worst-case matched-"
                f"power retention at the coarse grid falls below the "
                f"calibrated ~0.80 (it is ~0.60 at a 3-bin z mismatch), "
                f"so coarse_power_frac={self.coarse_power_frac} may drop "
                f"near-threshold candidates the fine-only search would "
                f"keep", stacklevel=2)

    @property
    def zs(self) -> np.ndarray:
        """Drift grid at *exactly* ``dz`` spacing starting from -zmax (the
        top end is trimmed when dz does not divide 2*zmax)."""
        n = int(np.floor(2 * self.zmax / self.dz)) + 1
        return -self.zmax + self.dz * np.arange(n)

    @property
    def ws(self) -> np.ndarray:
        """Jerk grid (bins of second-order drift over T^3); [0] when the
        w dimension is off."""
        if self.wmax <= 0.0:
            return np.zeros(1)
        n = int(np.floor(2 * self.wmax / self.dw)) + 1
        return -self.wmax + self.dw * np.arange(n)

    @property
    def stages(self) -> Tuple[int, ...]:
        return tuple(h for h in HARM_STAGES if h <= self.numharm)


@dataclasses.dataclass
class AccelCandidate:
    """One accepted (r, z) candidate. ``r``/``z`` are fundamental Fourier
    bin and drift (bins) at the *mid-observation* epoch; ``power`` is the
    H-harmonic summed matched power; ``sigma`` its trials-corrected
    equivalent-Gaussian significance."""

    r: float
    z: float
    power: float
    sigma: float
    numharm: int
    rerr: float = 0.0
    zerr: float = 0.0
    w: float = 0.0
    werr: float = 0.0

    def freq(self, T: float) -> float:
        return self.r / T

    def fdot(self, T: float) -> float:
        return self.z / (T * T)

    def fddot(self, T: float) -> float:
        return self.w / (T * T * T)

    def as_fourierprops(self) -> Dict[str, float]:
        """Field mapping for io.prestocand.write_rzwcands."""
        return dict(
            r=self.r, rerr=self.rerr, z=self.z, zerr=self.zerr,
            w=self.w, werr=self.werr,
            pow=self.power, powerr=math.sqrt(self.numharm),
            sig=self.sigma, rawpow=self.power, phs=0.0, phserr=0.0,
            cen=0.0, cenerr=0.0, pur=0.0, purerr=0.0,
            locpow=float(self.numharm),
        )


# ---------------------------------------------------------------------------
# device half
# ---------------------------------------------------------------------------


def _build_spec_pad_batch(f: torch.Tensor, front: int, pad: int):
    """Padded search spectra ``[B, front + N + pad]`` of ``f[B, N]``:
    conjugate reflection in front (bin -k of a real input's FFT is
    conj(bin k)) so templates overhanging the lowest bins correlate
    against physically correct values; zeros past Nyquist."""
    head = torch.flip(f[:, 1:front + 1], dims=(1,)).conj_physical()
    return torch.cat([head, f, f.new_zeros((f.shape[0], pad))], dim=1)


def _detect_impl(accum, thresh, k: int):
    """Local maxima of each plane ``accum[B, Z, R2]`` above ``thresh`` (a
    float32 0-d tensor): ``(vals, zi, ri, neigh)`` of the ``k`` largest,
    ``[B, k]`` each and ``neigh[B, k, 3, 3]`` the -inf-padded 3x3
    neighbourhood. The comparison is ``>=`` against the z neighbours and
    the -r neighbour and strict ``>`` against the +r neighbour, so of two
    equal neighbours along r only the later one is a maximum."""
    B, Z, R2 = accum.shape
    neg = float("-inf")
    pad = F.pad(accum, (1, 1, 1, 1), value=neg)
    c = pad[:, 1:-1, 1:-1]
    ismax = (
        (c >= pad[:, :-2, 1:-1]) & (c >= pad[:, 2:, 1:-1])
        & (c >= pad[:, 1:-1, :-2]) & (c > pad[:, 1:-1, 2:])
        & (c > thresh)
    )
    flat = torch.where(ismax, accum, torch.full_like(accum, neg))
    # ties: the reference's top_k keeps the lower index of two equal
    # values, CUDA's topk promises no order. It matters only when a
    # segment holds more than k finite maxima and two of them tie at the
    # k-th value; -inf fillers are dropped on the host either way
    vals, idx = torch.topk(flat.reshape(B, Z * R2), min(k, Z * R2), dim=1)
    zi = idx // R2
    ri = idx % R2
    off = torch.arange(3, device=accum.device)
    zo = zi[:, :, None, None] + off[None, None, :, None]
    ro = ri[:, :, None, None] + off[None, None, None, :]
    b = torch.arange(B, device=accum.device)[:, None, None, None]
    neigh = pad[b, zo, ro]
    return vals, zi, ri, neigh


def _run_stage_batch(spec_pad, bank_meta, tfs, idxs, segw: int, Z: int,
                     Wn: int, topk: int, top_lo: int, top_hi: int,
                     thresh_val: float, seg_ids):
    """One harmonic stage over the segments ``seg_ids`` for the spectra
    ``spec_pad[B, Np]``: host ``(vals, zi, ri, neigh)``, each
    ``[len(seg_ids), B, Wn, k, ...]``.

    Per segment, ratio bank ``(off0, step, hw, L)`` and spectrum: the
    ``[L]`` slice at ``off0 + si * step``, its FFT times the ``[rows, L]``
    bank, the inverse FFT, ``|.|^2``, and the stretch gather into the
    spectrum's ``[Z * Wn, 2 * segw]`` plane; the ``[rows, L]``
    temporaries are freed before the next spectrum. Each spectrum's
    transforms are calls of their own: the FFT libraries choose their
    algorithm and threading by a call's batch, so a batched transform
    would make a spectrum's bits depend on how many spectra share its
    batch. Detection runs on the ``[B, ...]`` planes, and the
    per-segment records stay on the device and move to the host once,
    at the end."""
    B = spec_pad.shape[0]
    dev = spec_pad.device
    thresh = torch.tensor(np.float32(thresh_val), device=dev)
    outs = []
    for si in seg_ids:
        si = int(si)
        r0 = top_lo + si * segw
        width = min(segw, top_hi - r0)
        plane = torch.zeros((B, Z * Wn, 2 * segw), dtype=torch.float32,
                            device=dev)
        for (off0, step, hw, L), tf, idx in zip(bank_meta, tfs, idxs):
            start = off0 + si * step
            for b in range(B):
                cf = torch.fft.fft(spec_pad[b, start:start + L])
                corr = torch.fft.ifft(cf * tf, dim=1)
                del cf
                p = corr.abs().square_()
                del corr
                # rows interleave integer/half-bin phases: [rows//2, 2L]
                # puts row pair (2i, 2i+1) side by side, which idx
                # addresses
                plane[b] += p.reshape(p.shape[0] // 2, 2 * L).index_select(
                    1, idx)
                del p
        if width < segw:
            plane[:, :, 2 * width:] = float("-inf")
        det = [_detect_impl(plane[:, wi::Wn], thresh, topk)
               for wi in range(Wn)]
        outs.append([torch.stack([d[i] for d in det], dim=1)
                     for i in range(4)])  # each [B, Wn, k, ...]
        del plane
    recs = [torch.stack([o[i] for o in outs]) for i in range(4)]
    count_d2h(*recs)
    return tuple(r.cpu().numpy() for r in recs)


# ---------------------------------------------------------------------------
# the batched search
# ---------------------------------------------------------------------------


_BANK_CACHE: Dict[tuple, tuple] = {}
_BANK_CACHE_BYTES = [0]
# the cache is shared by every search in the process, and a batch lane
# searches from several threads: its pops, inserts and byte count change
# together under this lock
_BANK_CACHE_LOCK = threading.Lock()


def _build_ratio_bank(rho_num: int, rho_den: int, zs: tuple, ws: tuple,
                      segw: int, min_halfwidth: int):
    """(tf[rows, L] complex64, hw, L, stretch idx[2*segw] int32) for one
    subharmonic ratio: harmonic b/H of a signal with (z, w) drifts at the
    top harmonic has drifts scaled by the same ratio."""
    rf = rho_num / rho_den
    zs = np.asarray(zs)
    ws = np.asarray(ws)
    tb, hw = template_bank_zw(zs * rf, ws * rf, numbetween=2,
                              min_halfwidth=min_halfwidth)
    wrho = (segw * rho_num) // rho_den
    m = tb.shape[1]
    L = fourier_chunk_len(wrho + 2 * hw + m)
    padded = np.zeros((tb.shape[0], L), dtype=np.complex128)
    padded[:, :m] = tb
    rev = np.zeros_like(padded)
    rev[:, 0] = padded[:, 0]
    rev[:, 1:] = padded[:, :0:-1]
    tf = np.fft.fft(rev, axis=1).astype(np.complex64)
    # static stretch: plane column `col` (top position r0 + col/2) maps to
    # subharm half-bin index round(rho*col) relative to rho*r0; corr[j]
    # evaluates spectrum position s0 + j (the template's -hw offset cancels
    # the slice's -hw start), so the column index is rel//2 with no hw term
    rel = np.floor(rf * np.arange(2 * segw) + 0.5).astype(np.int64)
    idx = ((rel % 2) * L + (rel // 2)).astype(np.int32)
    return tf, hw, L, idx


def _cached_ratio_bank(rho_num, rho_den, zs, ws, segw, min_halfwidth,
                       limit: float = BANK_CACHE_BYTES):
    """Byte-bounded LRU memo of :func:`_build_ratio_bank`: repeated
    searches with one configuration reuse banks, while a parameter sweep
    cannot pin unbounded host RAM. Eviction is least-recently-used, not
    clear-all: a coarse-to-fine search holds two grids' banks per
    configuration."""
    key = (rho_num, rho_den, zs, ws, segw, min_halfwidth)
    with _BANK_CACHE_LOCK:
        hit = _BANK_CACHE.pop(key, None)
        if hit is not None:
            _BANK_CACHE[key] = hit  # move-to-end: eviction is LRU, not FIFO
            return hit
    # built outside the lock (two threads may build one bank; the second
    # insert replaces the first, and the byte count follows)
    bank = _build_ratio_bank(rho_num, rho_den, zs, ws, segw, min_halfwidth)
    size = bank[0].nbytes + bank[3].nbytes
    if size > limit:
        return bank  # uncacheable; evicting everything for it helps nobody
    with _BANK_CACHE_LOCK:
        old = _BANK_CACHE.pop(key, None)
        if old is not None:
            _BANK_CACHE_BYTES[0] -= old[0].nbytes + old[3].nbytes
        while _BANK_CACHE and _BANK_CACHE_BYTES[0] + size > limit:
            old = _BANK_CACHE.pop(next(iter(_BANK_CACHE)))
            _BANK_CACHE_BYTES[0] -= old[0].nbytes + old[3].nbytes
        _BANK_CACHE[key] = bank
        _BANK_CACHE_BYTES[0] += size
    return bank


def _stage_range(H: int, rlo: int, rhi: int, N: int, segw: int):
    """(top_lo, top_hi, n_seg) of harmonic stage ``H``'s segment grid
    (shared by the full and the coarse passes, whose segment indices must
    map one-to-one)."""
    top_lo = H * rlo
    top_hi = min(H * rhi, N - 1)
    n_seg = -(-(top_hi - top_lo) // segw) if top_hi > top_lo else 0
    return top_lo, top_hi, n_seg


def _coarse_segment_sel(N, T, cfg: AccelSearchConfig, stages, rlo, rhi,
                        segw, front, Np, thresh, hit_fn,
                        bank_cache_bytes: float = BANK_CACHE_BYTES):
    """Coarse-pass segment preselection: rerun :func:`_search_setup` on the
    coarse z grid (identical padding geometry, so segment indices map
    one-to-one), then ask ``hit_fn(H, banks_coarse, n_z_rows, thresh_val,
    seg_ids)`` for a per-segment hit mask at the reduced threshold.
    Returns {H: hit segment ids}."""
    ccfg = dataclasses.replace(cfg, dz=cfg.coarse_dz, coarse_dz=0.0)
    (zs_c, _wc, _sc, _gc, _rl, _rh, banks_c, front_c, Np_c,
     _nc, _tc) = _search_setup(N, T, ccfg, bank_cache_bytes)
    if (front_c, Np_c) != (front, Np):
        raise AssertionError("coarse/fine padding geometry diverged")
    sel = {}
    for H in stages:
        _lo, _hi, n_seg = _stage_range(H, rlo, rhi, N, segw)
        if not n_seg:
            continue
        hits = hit_fn(H, banks_c, len(zs_c),
                      cfg.coarse_power_frac * thresh[H], np.arange(n_seg))
        sel[H] = np.nonzero(hits)[0]
    return sel


def _parabola_peak(ym, y0, yp):
    """Sub-cell offset and peak value of the parabola through three
    equally spaced samples (offset clipped to the cell)."""
    denom = ym - 2.0 * y0 + yp
    if denom >= 0.0 or not np.isfinite(denom):
        return 0.0, y0
    d = 0.5 * (ym - yp) / denom
    d = float(np.clip(d, -0.5, 0.5))
    return d, float(y0 - 0.25 * (ym - yp) * d)


def _search_setup(N: int, T: float, cfg: AccelSearchConfig,
                  bank_cache_bytes: float = BANK_CACHE_BYTES):
    """Host-side setup of a search: the (z, w) grids, harmonic stages,
    subharmonic ratio banks, spectrum padding geometry, and per-stage
    trials corrections, all independent of the spectrum, which is why a
    batch of spectra shares one set of banks."""
    zs = cfg.zs
    ws = cfg.ws
    stages = cfg.stages
    segw = cfg.seg_width
    if segw % max(stages):
        raise ValueError(f"seg_width {segw} must be divisible by "
                         f"numharm {max(stages)}")
    rlo = max(int(np.ceil(cfg.flo * T)), 1)
    rhi = int(np.floor((cfg.fhi * T) if cfg.fhi else (N - 1)))
    rhi = min(rhi, N - 1)
    if rhi <= rlo:
        raise ValueError(f"empty search range: rlo={rlo} rhi={rhi}")
    ratios = sorted({Fraction(b, H) for H in stages for b in range(1, H + 1)})
    banks = {
        rho: _cached_ratio_bank(rho.numerator, rho.denominator,
                                tuple(zs), tuple(ws), segw,
                                cfg.min_halfwidth, bank_cache_bytes)
        for rho in ratios
    }
    maxhw = max(hw for _, hw, _, _ in banks.values())
    front = maxhw + 1
    maxL = max(L for _, _, L, _ in banks.values())
    Np = N + maxL + front + 8
    Z, Wn = len(zs), len(ws)
    numindep, thresh = {}, {}
    for H in stages:
        ntop = max(min(H * rhi, N - 1) - H * rlo, 1)
        numindep[H] = max(ntop * Z * Wn / H, 1.0)
        thresh[H] = power_threshold(cfg.sigma_min, H, numindep[H])
    return zs, ws, stages, segw, rlo, rhi, banks, front, Np, numindep, thresh


def _stage_banks(banks, H: int, top_lo: int, segw: int, front: int, device):
    """(bank_meta, tfs, idxs) for one harmonic stage: device copies of
    this stage's <= H ratio banks, freed when the stage is done."""
    bank_meta, tfs, idxs = [], [], []
    for b in range(1, H + 1):
        tf, hw, L, idx = banks[Fraction(b, H)]
        bank_meta.append((front + (b * top_lo) // H - hw,
                          (b * segw) // H, hw, L))
        tfs.append(torch.from_numpy(tf).to(device))
        idxs.append(torch.from_numpy(idx).to(device))
    return bank_meta, tfs, idxs


def _refine_hits(raw_hits, zs, ws, cfg: AccelSearchConfig,
                 numindep, thresh) -> List[AccelCandidate]:
    """Host-side (float64) refine + significance + sift of raw device
    hits: parabola sub-cell peaks in r and z, trials-corrected Gaussian
    sigma, then greedy duplicate removal by fundamental proximity."""
    cands: List[AccelCandidate] = []
    for H, wi, r0, vals, zi, ri, neigh, width in raw_hits:
        # vectorized pre-filter: most top-k slots are -inf (below the
        # detection threshold); float64 so the threshold compare matches a
        # per-element float(p) <= thresh exactly
        vals = np.asarray(vals, dtype=np.float64)
        keep = np.isfinite(vals) & (vals > thresh[H]) \
            & (np.asarray(ri) < 2 * width)
        for j in np.nonzero(keep)[0]:
            p = float(vals[j])
            nb = neigh[j].astype(np.float64)
            dr, _ = _parabola_peak(nb[1, 0], nb[1, 1], nb[1, 2])
            dzo, _ = _parabola_peak(nb[0, 1], nb[1, 1], nb[2, 1])
            r_top = r0 + 0.5 * (float(ri[j]) + dr)
            z_top = zs[int(zi[j])] + dzo * cfg.dz
            w_top = float(ws[wi])
            sig = candidate_sigma(p, H, numindep[H])
            if sig < cfg.sigma_min:
                continue
            # matched-filter location uncertainties (linear-chirp Fisher
            # information approximations, cf. Ransom et al. 2002 app. A),
            # scaled to the fundamental
            rerr = 3.0 / (np.pi * math.sqrt(6.0 * p)) / H
            zerr = 3.0 * math.sqrt(105.0 / p) / np.pi / H
            werr = (cfg.dw / math.sqrt(max(p, 1.0))) / H if len(ws) > 1 else 0.0
            cands.append(AccelCandidate(
                r=r_top / H, z=z_top / H, power=p, sigma=sig,
                numharm=H, rerr=rerr, zerr=zerr,
                w=w_top / H, werr=werr))

    # sift: sort by sigma, greedily keep candidates whose fundamental is
    # not within 1 bin (and 2 z grid cells) of an already-accepted one
    cands.sort(key=lambda c: -c.sigma)
    kept: List[AccelCandidate] = []
    for c in cands:
        dup = False
        for kc in kept:
            if abs(c.r - kc.r) < 1.0 and abs(c.z - kc.z) <= 2 * cfg.dz:
                dup = True
                break
        if not dup:
            kept.append(c)
    return kept


def _stage_chunk_bytes(Z: int, Wn: int, segw: int) -> int:
    """Estimated device bytes PER BATCHED SPECTRUM of one harmonic stage:
    the spectrum's [Z*Wn, 2*segw] float32 plane and what detection holds
    beside it (the -inf padded copy, the masked copy, the comparison
    masks): four planes, with a 1.25x margin. The bank correlations do
    not grow with the chunk: :func:`_run_stage_batch` runs them one
    spectrum at a time (:func:`_stage_fixed_bytes`)."""
    return Z * Wn * 2 * segw * 4 * 5


def _stage_fixed_bytes(tfs) -> int:
    """Device bytes of one harmonic stage that do not grow with the chunk:
    its ratio banks (``tfs``, [rows, L] complex64 each) and one spectrum's
    temporaries of the largest bank correlation (the product and its
    inverse FFT, complex64, and the |.|^2 power, float32: 20 B/cell)."""
    cells = [int(t.shape[0]) * int(t.shape[1]) for t in tfs]
    return 8 * sum(cells) + 20 * max(cells)


def accel_search_batch(
    ffts,
    T: float,
    config: AccelSearchConfig = AccelSearchConfig(),
    hbm_budget_bytes: float = ACCEL_HBM_BYTES,
    bank_cache_bytes: float = BANK_CACHE_BYTES,
    device="cuda",
    devices: Optional[Tuple] = None,
) -> List[List[AccelCandidate]]:
    """Search a batch of normalized spectra ``ffts[B, N]`` (complex numpy
    or tensor; bin k = frequency k/T, T the observation length in
    seconds) sharing one configuration, on ``device``. Returns one sifted
    candidate list per spectrum, in order, sorted by decreasing sigma.

    Every harmonic stage correlates the spectra against the one set of
    device-resident banks. The batch is processed per stage in chunks
    whose working set fits ``hbm_budget_bytes`` (a chunk that still runs
    out of device memory halves and retries); the padded spectra stay
    on the device across stages, and a batch whose padded spectra alone
    would take half the budget is searched in slices of one. Per-spectrum
    results do not depend on the chunking.

    Harmonic geometry (the PRESTO structure): stage ``H`` searches the
    grid of the *highest* summed harmonic ``r_top = H*r_fund`` at half-bin
    resolution and adds subharmonics at ``r_top * b/H``; ``zmax`` bounds
    the drift of the top harmonic, and a stage-``H`` candidate's
    fundamental drift resolution is ``dz/H``.

    ``devices`` (a mesh's positions, which callers resolve through
    ``parallel.mesh.lease_devices`` or take from their mesh, never
    ``cuda:0..k-1`` directly) splits the batch into that many contiguous
    slices, one per device (``B`` must be a multiple), each searched on
    its own device with its own budget. A spectrum's candidates do not
    depend on the slicing."""
    cfg = config
    if devices is not None:
        from pypulsar_tpu_torch.parallel.mesh import on_device

        devices = tuple(devices)
        f = torch.as_tensor(ffts)
        B = int(f.shape[0])
        if B % len(devices):
            raise ValueError(f"batch {B} must be divisible by the "
                             f"{len(devices)} devices")
        per = B // len(devices)
        out: List[List[AccelCandidate]] = []
        for i, dev in enumerate(devices):
            with on_device(dev):
                out.extend(accel_search_batch(
                    f[i * per:(i + 1) * per], T, config,
                    hbm_budget_bytes=hbm_budget_bytes,
                    bank_cache_bytes=bank_cache_bytes, device=dev))
        return out
    device = resolve_device(device)
    f = torch.as_tensor(ffts).to(device=device, dtype=torch.complex64)
    if f.dim() != 2:
        raise ValueError(f"ffts must be [B, N]; got {tuple(f.shape)}")
    B, N = f.shape
    (zs, ws, stages, segw, rlo, rhi, banks, front, Np,
     numindep, thresh) = _search_setup(N, T, cfg, bank_cache_bytes)
    Z, Wn = len(zs), len(ws)
    hbm_budget_bytes = int(hbm_budget_bytes)

    max_resident = max(1, (hbm_budget_bytes // 2) // (Np * 8))
    if B > max_resident:
        out: List[List[AccelCandidate]] = []
        for c0 in range(0, B, max_resident):
            out.extend(accel_search_batch(
                f[c0:c0 + max_resident], T, config,
                hbm_budget_bytes=hbm_budget_bytes,
                bank_cache_bytes=bank_cache_bytes, device=device))
        return out

    spec_pad = _build_spec_pad_batch(f, front, int(max(Np - N, 8)))

    def run_stage_chunks(H, banks_src, Zrows, thresh_val, seg_ids):
        """Yield (c0, nb, vals, zi, ri, neigh) per batch chunk of one
        harmonic stage over ``seg_ids``; the stage's device banks are freed
        when the generator is exhausted."""
        top_lo, top_hi, _ = _stage_range(H, rlo, rhi, N, segw)
        bank_meta, tfs, idxs = _stage_banks(banks_src, H, top_lo, segw,
                                            front, device)
        chunk = max(1, min(B, (hbm_budget_bytes - _stage_fixed_bytes(tfs))
                           // _stage_chunk_bytes(Zrows, Wn, segw)))
        for c0 in range(0, B, chunk):
            nc = min(chunk, B - c0)

            def dispatch(lo, hi, c0=c0):
                faultinject.trip("accel.stage_dispatch")
                telemetry.counter("accel.stage_dispatches")
                with telemetry.span("accel_stage_batch", H=int(H),
                                    batch=int(hi - lo),
                                    n_seg=int(len(seg_ids))):
                    return _run_stage_batch(
                        spec_pad[c0 + lo:c0 + hi], bank_meta, tfs, idxs,
                        segw, Zrows, Wn, cfg.topk, top_lo, top_hi,
                        thresh_val, seg_ids)

            for lo, hi, outs in halving_dispatch(dispatch, nc,
                                                 what="accel.stage"):
                yield (c0 + lo, hi - lo) + outs

    def coarse_hits(H, banks_c, Zc, thresh_val, seg_ids):
        hit = np.zeros(len(seg_ids), bool)
        for _c0, _nb, vals, _zi, _ri, _ne in run_stage_chunks(
                H, banks_c, Zc, thresh_val, seg_ids):
            hit |= np.isfinite(vals).any(axis=(1, 2, 3))
        return hit

    # optional coarse pass (cfg.coarse_dz): stage segments are selected by
    # the UNION of coarse hits over the whole batch — the per-DM spectra
    # of one observation concentrate their signal in the same segments
    seg_sel = None
    if cfg.coarse_dz > cfg.dz:
        seg_sel = _coarse_segment_sel(N, T, cfg, stages, rlo, rhi, segw,
                                      front, Np, thresh, coarse_hits,
                                      bank_cache_bytes)

    raw_per_b: List[list] = [[] for _ in range(B)]
    for H in stages:
        top_lo, top_hi, n_seg = _stage_range(H, rlo, rhi, N, segw)
        if not n_seg:
            continue
        ids = np.arange(n_seg) if seg_sel is None else seg_sel[H]
        if not len(ids):
            continue
        for c0, nb, vals, zi, ri, neigh in run_stage_chunks(
                H, banks, Z, thresh[H], ids):
            for pos in range(len(ids)):
                si = int(ids[pos])
                r0 = top_lo + si * segw
                width = min(segw, top_hi - r0)
                for bl in range(nb):
                    for wi in range(Wn):
                        raw_per_b[c0 + bl].append(
                            (H, wi, r0, vals[pos, bl, wi], zi[pos, bl, wi],
                             ri[pos, bl, wi], neigh[pos, bl, wi], width))

    out = [_refine_hits(raw, zs, ws, cfg, numindep, thresh)
           for raw in raw_per_b]
    # counted on completion: a batch that raised must not count its
    # spectra as searched
    telemetry.counter("accel.spectra_searched", B)
    telemetry.counter("accel.batches")
    return out


def accel_search(fft, T: float, config: AccelSearchConfig = AccelSearchConfig(),
                 hbm_budget_bytes: float = ACCEL_HBM_BYTES,
                 bank_cache_bytes: float = BANK_CACHE_BYTES,
                 device="cuda") -> List[AccelCandidate]:
    """Search one normalized one-sided spectrum ``fft[N]``: the batch of
    one of :func:`accel_search_batch`, whose per-spectrum results do not
    depend on the batch."""
    f = torch.as_tensor(fft).reshape(1, -1)
    return accel_search_batch(f, T, config, hbm_budget_bytes,
                              bank_cache_bytes, device)[0]
