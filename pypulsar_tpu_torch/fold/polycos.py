"""TEMPO polyco parsing, evaluation, generation, and writing: a copy of
``pypulsar_tpu/fold/polycos.py`` (host float64 numpy; the port imports
nothing of the JAX package).

Behavioral parity target: reference utils/mypolycos.py (polyco :29-95,
polycos :98-174, create_polycos :213-276), itself lifted from PRESTO.
Redesigns:

- ``Polyco.rotation`` keeps the reference's Horner evaluation
  (mypolycos.py:73-84) in float64; a vectorized ``rotation_batch`` serves
  the fold engine (one call per block of samples instead of per sample).
- ``create_polycos`` spawns ``tempo -z`` exactly like the reference when
  the binary exists, but this framework also has a **native generator**
  (``create_polycos_from_spindown``): for a simple spin-down ephemeris
  (F0/F1/F2 about PEPOCH, no binary/barycentric terms) the phase
  polynomial is exact, so polyco blocks can be synthesized without TEMPO.
  That keeps folding self-contained for topocentric/barycentred data and
  for tests.
- A polyco.dat writer exists (the reference has none) for round-trip
  tests and interchange with PRESTO/TEMPO tooling.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional, Sequence, Union

import numpy as np

from pypulsar_tpu_torch.astro.telescopes import id_to_telescope, telescope_to_id, telescope_to_maxha
from pypulsar_tpu_torch.core import psrmath
from pypulsar_tpu_torch.io.infodata import InfoData
from pypulsar_tpu_torch.io.parfile import PsrPar

NUMCOEFFS_DEFAULT = 12
SPAN_DEFAULT = 60  # minutes


class PolycoError(Exception):
    pass


class Polyco:
    """One polyco block: phase polynomial about TMID.

    rotation(t) = RPHASE + DT*60*F0 + sum_i coeffs[i]*DT^i,  DT in minutes
    (reference mypolycos.py:73-84).
    """

    def __init__(self, psr, date, utc, tmid_str, dm, doppler, log10rms,
                 rphase, f0, obs, dataspan, numcoeff, obsfreq, coeffs,
                 binphase=None):
        self.psr = psr
        self.date = date
        self.UTC = utc
        # split TMID into integer+fractional *as printed* to keep precision
        self.TMIDi = float(tmid_str.split(".")[0])
        self.TMIDf = float("0." + tmid_str.split(".")[1]) if "." in tmid_str else 0.0
        self.TMID = self.TMIDi + self.TMIDf
        self.DM = dm
        self.doppler = doppler  # already in units of 1e-4 applied
        self.log10rms = log10rms
        self.RPHASE = rphase
        self.F0 = f0
        self.obs = obs
        self.dataspan = dataspan
        self.numcoeff = numcoeff
        self.obsfreq = obsfreq
        self.binphase = binphase
        self.coeffs = np.asarray(coeffs, dtype=np.float64)

    # -- parsing ----------------------------------------------------------
    @classmethod
    def read(cls, fileptr) -> Optional["Polyco"]:
        """Parse one block from an open polyco.dat; None at EOF
        (reference mypolycos.py:30-64, including the glued
        'doppler-log10rms' column case)."""
        line = fileptr.readline()
        if line == "" or not line.strip():
            return None
        sl = line.split()
        psr, date, utc, tmid_str = sl[0], sl[1], sl[2], sl[3]
        dm = float(sl[4])
        if len(sl) == 7:
            doppler = float(sl[5]) * 1e-4
            log10rms = float(sl[6])
        else:
            # doppler and log10rms glued together, split at the last '-'
            tail = sl[-1]
            log10rms_s = "-" + tail.split("-")[-1]
            doppler = float(tail[: tail.find(log10rms_s)]) * 1e-4
            log10rms = float(log10rms_s)
        sl = fileptr.readline().split()
        rphase = float(sl[0])
        f0 = float(sl[1])
        obs = sl[2]
        dataspan = int(sl[3])
        numcoeff = int(sl[4])
        obsfreq = float(sl[5])
        binphase = float(sl[6]) if len(sl) == 7 else None
        coeffs = []
        for _ in range((numcoeff + 2) // 3):
            sl = fileptr.readline().split()
            coeffs.extend(float(c.replace("D", "E")) for c in sl)
        return cls(psr, date, utc, tmid_str, dm, doppler, log10rms, rphase,
                   f0, obs, dataspan, numcoeff, obsfreq, coeffs[:numcoeff],
                   binphase)

    # -- evaluation -------------------------------------------------------
    def rotation(self, mjdi, mjdf) -> float:
        """Absolute (fractional) rotation count at mjdi+mjdf."""
        DT = ((mjdi - self.TMIDi) + (mjdf - self.TMIDf)) * 1440.0
        phase = self.coeffs[self.numcoeff - 1]
        for ii in range(self.numcoeff - 1, 0, -1):
            phase = DT * phase + self.coeffs[ii - 1]
        return phase + self.RPHASE + DT * 60.0 * self.F0

    def phase(self, mjdi, mjdf) -> float:
        return self.rotation(mjdi, mjdf) % 1

    def freq(self, mjdi, mjdf) -> float:
        """Apparent spin frequency (Hz)."""
        DT = ((mjdi - self.TMIDi) + (mjdf - self.TMIDf)) * 1440.0
        psrfreq = 0.0
        for ii in range(self.numcoeff - 1, 0, -1):
            psrfreq = DT * psrfreq + ii * self.coeffs[ii]
        return self.F0 + psrfreq / 60.0

    def rotation_batch(self, mjdi, mjdf: np.ndarray) -> np.ndarray:
        """Vectorized rotation for an array of fractional MJDs sharing one
        integer day — the fold engine's per-block path."""
        DT = ((mjdi - self.TMIDi) + (np.asarray(mjdf, np.float64) - self.TMIDf)) * 1440.0
        phase = np.full_like(DT, self.coeffs[self.numcoeff - 1])
        for ii in range(self.numcoeff - 1, 0, -1):
            phase = DT * phase + self.coeffs[ii - 1]
        return phase + self.RPHASE + DT * 60.0 * self.F0

    # -- writing ----------------------------------------------------------
    def format_block(self) -> str:
        """Serialize in TEMPO polyco.dat layout (readable by PRESTO and by
        our own parser)."""
        tmid = f"{self.TMIDi + self.TMIDf:.11f}"
        lines = [
            f"{self.psr:<10s} {self.date:>9s} {self.UTC:>11s} "
            f"{tmid:>20s} {self.DM:>21.6f} {self.doppler / 1e-4:>7.3f}"
            f"{self.log10rms:>7.3f}",
            f"{self.RPHASE:>20.6f} {self.F0:>18.12f} {self.obs:>5s} "
            f"{self.dataspan:>5d} {self.numcoeff:>5d} {self.obsfreq:>10.3f}"
            + (f" {self.binphase:>7.4f}" if self.binphase is not None else ""),
        ]
        for i in range(0, self.numcoeff, 3):
            chunk = self.coeffs[i : i + 3]
            lines.append("".join(f"{c:>25.17E}".replace("E", "D") for c in chunk))
        return "\n".join(lines) + "\n"


class Polycos:
    """Container over the blocks of a polyco.dat; selects the valid block
    by TMID (reference mypolycos.py:98-174)."""

    def __init__(self, filenm: str = "polyco.dat",
                 blocks: Optional[Sequence[Polyco]] = None):
        self.file = filenm
        self.polycos: List[Polyco] = []
        tmids = []
        if blocks is None:
            with open(filenm) as infile:
                blocks = []
                while True:
                    p = Polyco.read(infile)
                    if p is None:
                        break
                    blocks.append(p)
        if not blocks:
            raise PolycoError(f"No polycos in {filenm}!")
        psrname = blocks[0].psr
        self.dataspan = blocks[0].dataspan
        for p in blocks:
            if p.dataspan != self.dataspan:
                raise PolycoError("Data span is changing!\n")
            if p.psr != psrname:
                raise PolycoError("Multiple PSRs in same polycos file!\n")
            self.polycos.append(p)
            tmids.append(p.TMID)
        self.TMIDs = np.asarray(tmids)
        self.validrange = 0.5 * self.dataspan / 1440.0

    def __len__(self):
        return len(self.polycos)

    def select_polyco(self, mjdi, mjdf) -> int:
        goodpoly = int(np.argmin(np.fabs(self.TMIDs - (mjdi + mjdf))))
        if np.fabs(self.TMIDs[goodpoly] - (mjdi + mjdf)) > self.validrange:
            raise PolycoError(f"Cannot find a valid polyco at {mjdi + mjdf:f}!\n")
        return goodpoly

    def get_phase(self, mjdi, mjdf) -> float:
        return self.polycos[self.select_polyco(mjdi, mjdf)].phase(mjdi, mjdf)

    def get_rotation(self, mjdi, mjdf) -> float:
        return self.polycos[self.select_polyco(mjdi, mjdf)].rotation(mjdi, mjdf)

    def get_freq(self, mjdi, mjdf) -> float:
        return self.polycos[self.select_polyco(mjdi, mjdf)].freq(mjdi, mjdf)

    def get_phs_and_freq(self, mjdi, mjdf):
        p = self.polycos[self.select_polyco(mjdi, mjdf)]
        return p.phase(mjdi, mjdf), p.freq(mjdi, mjdf)

    def get_voverc(self, mjdi, mjdf) -> float:
        return self.polycos[self.select_polyco(mjdi, mjdf)].doppler

    def write(self, filenm: str) -> str:
        with open(filenm, "w") as f:
            for p in self.polycos:
                f.write(p.format_block())
        return filenm


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def create_polycos_from_spindown(
    par: Union[str, PsrPar],
    start_mjd: float,
    end_mjd: float,
    obs: str = "@",
    obsfreq: float = 0.0,
    span: int = SPAN_DEFAULT,
    numcoeffs: int = NUMCOEFFS_DEFAULT,
) -> Polycos:
    """Synthesize polyco blocks natively from a simple spin-down ephemeris.

    Valid when the apparent spin evolution is the Taylor series
    f(t) = F0 + F1*(t-PEPOCH) + F2/2*(t-PEPOCH)^2 (no binary motion, no
    observatory barycentric correction — i.e. barycentred or artificially
    generated data; this is the regime the reference's test-free pipeline
    exercised via TEMPO).  The rotation polynomial about each block TMID
    is then *exact*:

        N(t) = N(TMID) + f(TMID)*dt + F1/2*dt^2 + F2/6*dt^3,  dt = t-TMID [s]

    mapped onto the polyco convention (DT in minutes):
        RPHASE    = N(TMID) ;  F0_block = f(TMID)
        coeffs[2] = F1/2 * 3600 ;  coeffs[3] = F2/6 * 216000
    """
    if isinstance(par, str):
        par = PsrPar(par)
    f0 = float(par.F0)
    f1 = float(getattr(par, "F1", 0.0) or 0.0)
    f2 = float(getattr(par, "F2", 0.0) or 0.0)
    pepoch = float(getattr(par, "PEPOCH", start_mjd))
    dm = float(getattr(par, "DM", 0.0) or 0.0)
    psrname = par.name.lstrip("BJ")

    def f_at(mjd):
        dt = (mjd - pepoch) * psrmath.SECPERDAY
        return f0 + f1 * dt + 0.5 * f2 * dt * dt

    def n_at(mjd):
        dt = (mjd - pepoch) * psrmath.SECPERDAY
        return f0 * dt + 0.5 * f1 * dt * dt + f2 * dt**3 / 6.0

    blocks = []
    span_days = span / 1440.0
    # center the first block ON start_mjd so the requested range is covered
    # with half-a-span margin at both edges (floating-point-safe; TEMPO
    # similarly over-covers the requested window)
    tmid = float(start_mjd)
    while tmid - 0.5 * span_days <= end_mjd:
        # snap TMID to its serialized split (TMIDi + full-precision
        # fraction) before computing RPHASE so evaluation, which parses
        # tmid_str the same way, is consistent
        tmid_str = f"{tmid:.11f}"
        ipart, _, fpart = tmid_str.partition(".")
        tmid_eval = np.longdouble(int(ipart)) + np.longdouble(
            float("0." + fpart))
        coeffs = np.zeros(numcoeffs)
        # DT is minutes: dt_sec = 60*DT.  The dt^2 coefficient uses the
        # frequency DERIVATIVE AT TMID, f'(TMID) = F1 + F2*(TMID-PEPOCH):
        fdot_tmid = f1 + f2 * (tmid_eval - pepoch) * psrmath.SECPERDAY
        if numcoeffs > 2:
            coeffs[2] = 0.5 * fdot_tmid * 3600.0
        if numcoeffs > 3:
            coeffs[3] = f2 / 6.0 * 216000.0
        mjdi = int(tmid_eval)
        frac_h = (tmid_eval - mjdi) * 24.0
        hh = int(frac_h)
        mm = int((frac_h - hh) * 60)
        ss = (frac_h - hh) * 3600 - mm * 60
        blocks.append(
            Polyco(
                psr=psrname,
                date="DD-MMM-YY",
                utc=f"{hh:02d}{mm:02d}{ss:05.2f}".replace(".", ""),
                tmid_str=tmid_str,
                dm=dm,
                doppler=0.0,
                log10rms=-10.0,
                rphase=float(n_at(tmid_eval)),
                f0=float(f_at(tmid_eval)),
                obs=obs,
                dataspan=span,
                numcoeff=numcoeffs,
                obsfreq=obsfreq,
                coeffs=coeffs,
            )
        )
        tmid += span_days
    return Polycos(filenm="<generated>", blocks=blocks)


def _bt_roemer_delay(mjds: np.ndarray, pb_days: float, a1: float,
                     ecc: float, om_deg: float, t0: float) -> np.ndarray:
    """Blandford-Teukolsky Roemer delay (s) of the pulsar's orbit at the
    given barycentric MJDs: x[sin w (cos E - e) + sqrt(1-e^2) cos w sin E]
    with E from Kepler's equation by Newton iteration."""
    mjds = np.asarray(mjds, dtype=np.longdouble)
    ma = 2.0 * np.pi * np.asarray((mjds - t0) / pb_days, dtype=np.float64)
    ma = np.mod(ma, 2.0 * np.pi)
    E = ma + ecc * np.sin(ma)  # good starting guess for e < 0.8
    for _ in range(25):
        dE = (E - ecc * np.sin(E) - ma) / (1.0 - ecc * np.cos(E))
        E = E - dE
        if np.max(np.abs(dE)) < 1e-14:
            break
    om = np.deg2rad(om_deg)
    return a1 * (np.sin(om) * (np.cos(E) - ecc)
                 + np.sqrt(1.0 - ecc ** 2) * np.cos(om) * np.sin(E))


def create_polycos_from_binary(
    par: Union[str, PsrPar],
    start_mjd: float,
    end_mjd: float,
    obs: str = "@",
    obsfreq: float = 0.0,
    span: int = SPAN_DEFAULT,
    numcoeffs: int = NUMCOEFFS_DEFAULT,
    max_resid_phase: float = 1e-6,
) -> Polycos:
    """Native polyco generation for binary pulsars (BT/ELL1-style Keplerian
    orbits) on barycentred data — the capability the reference delegated to
    the TEMPO binary.

    Per block, the exact rotation count N(t) = f(tau) integrated over the
    orbit-retarded proper time tau = t - Roemer(t) is sampled on Chebyshev
    nodes and least-squares fitted with the polyco polynomial in
    DT = (t - TMID) minutes.  The block span is shrunk (and the fit
    re-done) until the max fit residual is below ``max_resid_phase``
    rotations, so short-period orbits are handled correctly.
    """
    if isinstance(par, str):
        par = PsrPar(par)
    f0 = float(par.F0)
    f1 = float(getattr(par, "F1", 0.0) or 0.0)
    f2 = float(getattr(par, "F2", 0.0) or 0.0)
    pepoch = float(getattr(par, "PEPOCH", start_mjd))
    dm = float(getattr(par, "DM", 0.0) or 0.0)
    pb = float(par.PB)           # days
    a1 = float(par.A1)           # lt-s
    if hasattr(par, "EPS1") or hasattr(par, "EPS2"):
        # ELL1 parameterization: eps1 = e sin w, eps2 = e cos w, epoch is
        # the ascending node; T0 = TASC + (w/2pi) Pb (exact to O(e^2),
        # consistent with the ELL1 small-e regime)
        eps1 = float(getattr(par, "EPS1", 0.0) or 0.0)
        eps2 = float(getattr(par, "EPS2", 0.0) or 0.0)
        ecc = float(np.hypot(eps1, eps2))
        om_rad = float(np.arctan2(eps1, eps2))
        om = np.rad2deg(om_rad)
        t0 = float(par.TASC) + (om_rad % (2 * np.pi)) / (2 * np.pi) * pb
    elif hasattr(par, "T0"):
        ecc = float(getattr(par, "ECC", getattr(par, "E", 0.0)) or 0.0)
        om = float(getattr(par, "OM", 0.0) or 0.0)
        t0 = float(par.T0)
    else:
        raise PolycoError(
            "Binary ephemeris has neither T0/ECC/OM (BT/DD-style) nor "
            "TASC/EPS1/EPS2 (ELL1-style) parameters; cannot generate "
            "native polycos for this model.")
    psrname = par.name.lstrip("BJ")

    def n_at(mjds):
        """Exact rotation count at barycentric MJDs (longdouble)."""
        mjds = np.atleast_1d(np.asarray(mjds, dtype=np.longdouble))
        delay = _bt_roemer_delay(mjds, pb, a1, ecc, om, t0)
        tau = (mjds - pepoch) * psrmath.SECPERDAY - delay
        return f0 * tau + 0.5 * f1 * tau ** 2 + f2 * tau ** 3 / 6.0

    def fit_block(tmid, cur_span):
        """(coeffs, rphase, max_resid) of the polyco polynomial fit on
        Chebyshev nodes over [tmid - span/2, tmid + span/2]."""
        half_min = cur_span / 2.0
        k = np.arange(4 * numcoeffs)
        dts = half_min * np.cos(np.pi * (k + 0.5) / k.size)
        mjds = tmid + np.asarray(dts, dtype=np.longdouble) / 1440.0
        n_tmid = n_at(tmid)[0]
        y = np.asarray(n_at(mjds) - n_tmid, dtype=np.float64)
        # fit in the scaled variable s = DT/half (condition number ~1),
        # then rescale coefficients to the polyco's DT-minutes monomials
        s = dts / half_min
        A = np.vander(s, numcoeffs, increasing=True)
        coeffs_s, *_ = np.linalg.lstsq(A, y, rcond=None)
        resid = float(np.max(np.abs(A @ coeffs_s - y)))
        coeffs = coeffs_s / half_min ** np.arange(numcoeffs)
        return coeffs, float(n_tmid), resid

    # TEMPO polycos require one uniform dataspan; pick the largest span —
    # starting well inside one orbit — whose fit converges at every
    # orbital phase (probe 8 phases across the orbit)
    span = int(min(span, max(4, pb * 1440.0 / 16.0)))
    probes = float(start_mjd) + pb * np.arange(8) / 8.0
    while span > 4:
        if all(fit_block(t, span)[2] <= max_resid_phase for t in probes):
            break
        span = max(4, span // 2)

    while True:
        blocks = []
        span_ok = True
        tmid = float(start_mjd)
        while tmid - 0.5 * (span / 1440.0) <= end_mjd:
            # Fit around TMID exactly as evaluation will see it: Polyco
            # splits tmid_str into TMIDi + TMIDf (the fraction parsed at
            # full float64 precision, which differs from
            # frac(float(tmid_str)) by ~1e-12 days ~ 1e-4 rotations at
            # 200 Hz), so reconstruct that split in longdouble here.
            tmid_str = f"{tmid:.11f}"
            ipart, _, fpart = tmid_str.partition(".")
            tmid_eval = np.longdouble(int(ipart)) + np.longdouble(
                float("0." + fpart))
            coeffs, n_tmid, resid = fit_block(tmid_eval, span)
            if resid > max_resid_phase and span > 4:
                # a production block (e.g. a fast periastron sweep the
                # start-epoch probes missed) needs a finer span; polycos
                # must share one dataspan, so restart smaller
                span_ok = False
                break
            f0_block = coeffs[1] / 60.0
            pcoeffs = coeffs.copy()
            pcoeffs[1] = 0.0  # linear term lives in F0_block
            mjdi = int(tmid_eval)
            frac_h = (tmid_eval - mjdi) * 24.0
            hh = int(frac_h)
            mm = int((frac_h - hh) * 60)
            ss = (frac_h - hh) * 3600 - mm * 60
            blocks.append(
                Polyco(
                    psr=psrname,
                    date="DD-MMM-YY",
                    utc=f"{hh:02d}{mm:02d}{ss:05.2f}".replace(".", ""),
                    tmid_str=tmid_str,
                    dm=dm,
                    doppler=0.0,
                    log10rms=-10.0,
                    rphase=float(n_tmid),
                    f0=f0_block,
                    obs=obs,
                    dataspan=span,
                    numcoeff=numcoeffs,
                    obsfreq=obsfreq,
                    coeffs=pcoeffs,
                )
            )
            tmid += span / 1440.0
        if span_ok:
            return Polycos(filenm="<generated-binary>", blocks=blocks)
        span = max(4, span // 2)


def create_polycos(
    par: Union[str, PsrPar],
    telescope_id: str,
    center_freq: float,
    start_mjd: int,
    end_mjd: int,
    max_hour_angle=None,
    span: int = SPAN_DEFAULT,
    numcoeffs: int = NUMCOEFFS_DEFAULT,
    keep_file: bool = False,
) -> Polycos:
    """Create polycos from a parfile via ``tempo -z`` (reference
    mypolycos.py:213-276).  Falls back to the native spin-down generator
    (or the native Keplerian generator for binary ephemerides) when the
    TEMPO binary is unavailable; topocentric data without TEMPO raises."""
    if isinstance(par, str):
        par = PsrPar(par)

    if shutil.which("tempo") is None:
        if hasattr(par, "BINARY"):
            if telescope_id not in ("@", "0"):
                raise PolycoError(
                    "TEMPO binary not found; native binary polycos are "
                    "only valid for barycentred data (telescope_id '@' "
                    f"or '0', got {telescope_id!r})."
                )
            return create_polycos_from_binary(
                par, float(start_mjd), float(end_mjd), obs=telescope_id,
                obsfreq=center_freq, span=span, numcoeffs=numcoeffs,
            )
        if telescope_id not in ("@", "0"):
            # topocentric data needs Earth-motion corrections only TEMPO
            # provides; a pure spin-down polyco would smear the fold by
            # up to v/c ~ 1e-4 in apparent frequency
            raise PolycoError(
                "TEMPO binary not found; the native spin-down generator is "
                "only valid for barycentred/geocentric data (telescope_id "
                f"'@' or '0', got {telescope_id!r}).  Call "
                "create_polycos_from_spindown directly to override."
            )
        return create_polycos_from_spindown(
            par, float(start_mjd), float(end_mjd), obs=telescope_id,
            obsfreq=center_freq, span=span, numcoeffs=numcoeffs,
        )

    if max_hour_angle is None:
        telescope_name = id_to_telescope[telescope_id]
        max_hour_angle = telescope_to_maxha[telescope_name]

    with open("tz.in", "w") as tzfile:
        tzfile.write(
            f"{telescope_id} {max_hour_angle:d} {span:d} {numcoeffs:d} "
            f"{center_freq:0.5f}\n\n\n"
        )
        psrname = par.name.lstrip("BJ")
        tzfile.write(
            f"{psrname} {span:d} {numcoeffs:d} {max_hour_angle:d} "
            f"{center_freq:0.5f}\n"
        )
    proc = subprocess.Popen(
        ["tempo", "-z", "-f", par.FILE],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )
    out, err = proc.communicate(f"{start_mjd:d} {end_mjd:d}\n")
    try:
        new_polycos = Polycos(filenm="polyco.dat")
    except (OSError, PolycoError) as e:
        raise PolycoError(
            f"Could not read/create polycos!\nTEMPO stdout:\n{out}\n"
            f"TEMPO stderr:\n{err}\nParfile: {par.FILE}"
        ) from e
    finally:
        if os.path.exists("tz.in"):
            os.remove("tz.in")
        if not keep_file and os.path.exists("polyco.dat"):
            os.remove("polyco.dat")
    return new_polycos


def create_polycos_from_inf(par, infdata) -> Polycos:
    """Convenience wrapper using a .inf file's metadata (reference
    mypolycos.py:177-210; fixes the py2 ``type(x)==bytes`` check noted in
    SURVEY.md §2.6)."""
    if isinstance(infdata, str):
        infdata = InfoData(infdata)
    obslength = (infdata.dt * infdata.N) / psrmath.SECPERDAY
    # Barycentred data needs no Earth-motion correction whatever the
    # telescope was — check the flag BEFORE the site lookup so barycentred
    # products from unmapped/synthetic telescopes work, and topocentric
    # data from an unknown site fails loudly instead of folding smeared.
    if getattr(infdata, "bary", 0):
        telescope_id = "@"
    else:
        try:
            telescope_id = telescope_to_id[infdata.telescope]
        except KeyError:
            raise PolycoError(
                f"unknown telescope {infdata.telescope!r}: topocentric "
                "polycos need a TEMPO site id (astro/telescopes.py); "
                "barycentred data should set the .inf 'Barycentered?' flag"
            ) from None
    # '0' = Geocenter, '@' = barycenter (optical/X-ray/gamma-ray data)
    if telescope_id not in ("0", "@"):
        center_freq = infdata.lofreq + (infdata.numchan / 2 - 0.5) * infdata.chan_width
    else:
        center_freq = 0.0
    start_mjd = int(infdata.epoch)
    end_mjd = int(infdata.epoch + obslength) + 1
    return create_polycos(par, telescope_id, center_freq, start_mjd, end_mjd)
