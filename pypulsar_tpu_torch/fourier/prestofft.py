"""PRESTO ``.fft`` files and the spectral analysis of one spectrum.

Port of ``pypulsar_tpu/fourier/prestofft.py`` (the reference's
formats/prestofft.py). The file and its ``.inf`` are read on the host;
the spectrum, its powers and phases are tensors on ``device`` (default
``cuda``, which raises without a card), and the array work runs there
through :mod:`pypulsar_tpu_torch.fourier.kernels`. The power-law
red-noise fit stays on the host: ``scipy.optimize`` with the reference's
objective, bounds and defaults (the fixed-DC mode included). The plot
methods import matplotlib only when they are called.
"""

from __future__ import annotations

import os.path

import numpy as np
import scipy.interpolate
import scipy.optimize
import torch

from pypulsar_tpu_torch.core.device import resolve_device
from pypulsar_tpu_torch.core.psrmath import dm_smear
from pypulsar_tpu_torch.fourier import kernels
from pypulsar_tpu_torch.io.infodata import InfoData

COLOURS = ["r", "b", "g", "m", "c", "y"]


class PrestoFFT:
    """A PRESTO ``.fft`` file (the complex64 rfft of a ``.dat`` series)
    and its ``.inf`` metadata. ``lazy`` reads the metadata only (use
    :meth:`read_fft` and :meth:`seek_to_bin` for block reads); otherwise
    the coefficients below ``maxfreq`` Hz are read and moved to
    ``device`` as ``fft`` (complex64), ``powers`` (float32) and
    ``phases``; ``freqs`` (float64 Hz) stays on the host."""

    def __init__(self, fftfn, inffn=None, maxfreq=None, lazy=False,
                 device="cuda"):
        if not fftfn.endswith(".fft"):
            raise ValueError("FFT filename must end with '.fft'! (%s)" % fftfn)
        if not os.path.isfile(fftfn):
            raise ValueError("FFT file does not exist!\n\t(%s)" % fftfn)
        if inffn is None:
            inffn = "%s.inf" % fftfn[:-4]
        if not os.path.isfile(inffn):
            raise ValueError("Info file does not exist!\n\t(%s)" % inffn)
        self.device = resolve_device(device)
        self.fftfn = fftfn
        self.inffn = inffn
        self.inf = InfoData(inffn)
        self.fftfile = open(self.fftfn, "rb")

        # coefficients actually on disk (PRESTO realffts hold N/2;
        # write_fft holds N/2+1)
        self.numcoeffs = os.path.getsize(fftfn) // 8
        self.freqs = np.fft.rfftfreq(self.inf.N, self.inf.dt)[: self.numcoeffs]

        self.normalisation = "raw"
        self.errs = None
        self._schedule = None
        if lazy:
            self.fft = None
            self.phases = None
            self.powers = None
            return
        if maxfreq is not None:
            ntoread = int(np.sum(self.freqs < maxfreq))
            self.freqs = self.freqs[:ntoread]
        else:
            ntoread = -1
        fft = self.read_fft(count=ntoread)
        self.freqs = self.freqs[: len(fft)]
        self.fft = torch.from_numpy(fft[: len(self.freqs)]).to(self.device)
        self.phases = torch.angle(self.fft)
        self.powers = torch.abs(self.fft) ** 2

    def close(self):
        self.fftfile.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def read_fft(self, count=-1) -> np.ndarray:
        """The next ``count`` complex64 coefficients of the file (host)."""
        return np.fromfile(self.fftfile, dtype=np.dtype("c8"), count=count)

    def seek_to_bin(self, binnum: int):
        """Position the file at frequency bin ``binnum`` for block reads
        (8 bytes a complex64 coefficient)."""
        self.fftfile.seek(8 * int(binnum))

    # ---- spectral ops (device) -------------------------------------------

    def interpolate(self, r, m=32) -> torch.Tensor:
        """The coefficients interpolated at fractional bins ``r``."""
        return kernels.fourier_interpolate(self.fft, r, m, device=self.device)

    def harmonic_sum(self, nharm=8) -> torch.Tensor:
        """Decimated harmonically summed powers."""
        return kernels.harmonic_sum(self.powers, nharm, device=self.device)

    def incoherent_harmonic_sum(self, nharm=8):
        """(summed powers, freqs / nharm) of the interpolated incoherent
        harmonic sum."""
        summed = kernels.incoherent_harmonic_sum(self.fft, self.powers, nharm,
                                                 device=self.device)
        return summed, self.freqs / float(nharm)

    def coherent_harmonic_sum(self, nharm=8):
        """(summed powers, freqs / nharm) of the interpolated coherent
        (complex) harmonic sum."""
        summed = kernels.coherent_harmonic_sum(self.fft, nharm,
                                               device=self.device)
        return summed, self.freqs / float(nharm)

    def _get_schedule(self, initialbuflen, maxbuflen):
        key = (len(self.fft), initialbuflen, maxbuflen)
        if self._schedule is None or self._schedule[0] != key:
            self._schedule = (key, kernels.deredden_schedule(
                len(self.fft), initialbuflen, maxbuflen))
        return self._schedule[1]

    def deredden(self, initialbuflen=6, maxbuflen=200) -> torch.Tensor:
        """The red-noise-normalized spectrum (PRESTO's accel_utils
        algorithm)."""
        sched = self._get_schedule(initialbuflen, maxbuflen)
        return kernels.deredden(self.fft, self.powers, schedule=sched)

    def estimate_power_errors(self, initialbuflen=6, maxbuflen=200,
                              force=False):
        """Fill ``self.errs`` with per-bin power uncertainties."""
        if not force and (self.errs is not None):
            return
        sched = self._get_schedule(initialbuflen, maxbuflen)
        self.errs = kernels.estimate_power_errors(self.powers, schedule=sched,
                                                  device=self.device)

    # ---- red-noise model fitting (host) ----------------------------------

    def _host_powers(self) -> np.ndarray:
        return self.powers.cpu().numpy()

    def estimate_white_power_level(self, minfreq=1000):
        """Median power above ``minfreq`` Hz."""
        return np.median(self._host_powers()[self.freqs > minfreq])

    def fit_powers(self, freqlim=None, use_errors=True, fix_dc=True,
                   amp=1e14, index=-1.5, dc=None):
        """Fit ``amp * f^index + dc`` to the low-frequency powers: the
        reference's objective and defaults, ``scipy.optimize.minimize`` in
        place of iminuit. Returns a dict with 'amp', 'index', 'dc'."""
        if freqlim is None:
            freqlim = np.inf
            if self.inf.DM > 0:
                tdm = dm_smear(self.inf.DM, self.inf.BW,
                               self.inf.lofreq + 0.5 * self.inf.BW)
                freqlim = 1.0 / tdm
            freqlim = min(10.0, freqlim)
        iuse = self.freqs < freqlim
        iuse[0] = False  # always ignore the DC bin

        if use_errors:
            self.estimate_power_errors()
        if dc is None:
            dc = self.estimate_white_power_level(1000)

        f = self.freqs[iuse]
        p = self._host_powers()[iuse]
        e = self.errs.cpu().numpy()[iuse] if use_errors else 1.0

        # optimize log10(amp): power-law amplitudes span many decades and a
        # linear-space simplex collapses onto the amp>=0 bound
        la0 = np.log10(max(np.median(p[: max(len(p) // 10, 2)]), 1e-30)) - index * np.log10(
            max(f[0], 1e-12)
        )

        def chi2(params):
            if fix_dc:
                la, idx = params
                d = dc
            else:
                la, idx, d = params
            diff = (power_law(f, 10.0**la, idx, d) - p) / e
            return np.sum(diff**2)

        x0 = [la0, index] if fix_dc else [la0, index, dc]
        bounds = [(-30.0, 30.0), (-10.0, 0.0)] + ([] if fix_dc else [(0, None)])
        res = scipy.optimize.minimize(chi2, x0, method="Nelder-Mead",
                                      bounds=bounds,
                                      options={"maxiter": 5000, "xatol": 1e-10,
                                               "fatol": 1e-10})
        if fix_dc:
            return {"amp": 10.0 ** res.x[0], "index": res.x[1], "dc": dc}
        return {"amp": 10.0 ** res.x[0], "index": res.x[1], "dc": res.x[2]}

    # ---- plotting (matplotlib imported on call) --------------------------

    def plot(self, **kwargs):
        import matplotlib.pyplot as plt

        plt.plot(self.freqs, self._host_powers(), **kwargs)
        plt.title(self.fftfn)
        plt.xlabel("Frequency (Hz)")
        plt.ylabel("Power")
        plt.xscale("log")
        plt.yscale("log")

    def plot_power_fit(self, powerlaws):
        import matplotlib.pyplot as plt

        for ii, (amp, index, dc) in enumerate(powerlaws):
            c = COLOURS[ii % len(COLOURS)]
            model = power_law(self.freqs, amp, index, dc)
            plt.plot(self.freqs[1:], model[1:], ls="--", c=c,
                     label=r"A=%.2g, $\alpha$=%.3g, DC=%.2g" % (amp, index, dc))
        plt.xlabel("Frequency (Hz)")
        plt.ylabel("Power")
        plt.xscale("log")
        plt.yscale("log")
        plt.legend(loc="upper right", prop=dict(size="x-small"))

    def plot_3pane(self):
        import matplotlib.pyplot as plt

        powers = self._host_powers()
        ones = (self.freqs >= 1) & (self.freqs < 10)
        tens = (self.freqs >= 10) & (self.freqs < 100)
        hundreds = (self.freqs >= 100) & (self.freqs < 1000)
        plt.figure(figsize=(10, 8))
        plt.subplots_adjust(hspace=0.25)
        axones = plt.subplot(3, 1, 1)
        plt.plot(self.freqs[ones], powers[ones], "k-", lw=0.5)
        plt.ylabel("Power")
        plt.xscale("log")
        plt.subplot(3, 1, 2, sharey=axones)
        plt.plot(self.freqs[tens], powers[tens], "k-", lw=0.5)
        plt.ylabel("Power")
        plt.xscale("log")
        plt.subplot(3, 1, 3, sharey=axones)
        plt.plot(self.freqs[hundreds], powers[hundreds], "k-", lw=0.5)
        plt.xlabel("Frequency (Hz)")
        plt.ylabel("Power")
        plt.xscale("log")
        maxpwr = np.max(powers[(self.freqs >= 1) & (self.freqs < 1000)])
        axones.set_ylim(0, maxpwr * 1.1)
        plt.suptitle("Power Spectrum (%s)" % self.fftfn)

    def plot_zaplist(self, zapfile, fc="b", ec="none", alpha=0.25, zorder=-1,
                     **kwargs):
        import matplotlib.pyplot as plt

        zaplist = np.loadtxt(zapfile)
        for freq, width in np.atleast_2d(zaplist):
            plt.axvspan(freq - width / 2.0, freq + width / 2.0, fill=True,
                        fc=fc, ec=ec, alpha=alpha, zorder=zorder, **kwargs)
        plt.figtext(0.025, 0.03, "Zaplist file: %s" % zapfile, size="xx-small")


def power_law(freqs, amp, index, dc):
    """Red-noise model: amp*f^index + dc."""
    return amp * freqs ** index + dc


def write_fft(fftfn, fft, inf: InfoData = None):
    """Write complex64 coefficients (numpy or a tensor on any device) as a
    PRESTO-style ``.fft``, and the ``.inf`` when given."""
    if torch.is_tensor(fft):
        fft = fft.cpu().numpy()
    np.asarray(fft, dtype=np.complex64).tofile(fftfn)
    if inf is not None:
        inf.to_file("%s.inf" % fftfn[:-4])


def get_smear_response(ddm, **obs):
    """Fourier response of the wrong-DM smearing kernel (the reference's
    prestofft.py:385-401); returns a callable ``response(freq)``."""
    if ddm != 0:
        bw = obs["chan_width"] * obs["numchan"]
        fhi = obs["lofreq"] + bw
        smear = smearing_function(obs["lofreq"], fhi, ddm, obs.get("bandpass", None))
        times = np.arange(obs["N"]) * obs["dt"]
        weights = smear(times)
        weights /= np.sum(weights)
        freqs = np.fft.fftfreq(obs["N"], obs["dt"])
        freqs = freqs[freqs >= 0]
        fft = np.fft.rfft(weights)[: len(freqs)]
        response = scipy.interpolate.interp1d(freqs, np.abs(fft) ** 2)
    else:
        def response(freq):
            return 1
    return response


def smearing_function(flo, fhi, ddm, bandpass=None):
    """Time-domain smearing kernel of a DM error ``ddm`` (the reference's
    prestofft.py:404-435); flo/fhi in MHz; returns ``smear(times)``."""
    if bandpass is not None:
        bandpass = np.asarray(bandpass, dtype=float).copy()
        freqs = np.linspace(flo, fhi, len(bandpass))
        delay = 4.15e3 * ddm * (freqs**-2 - fhi**-2)
        isort = np.argsort(delay)
        bandpass[~np.isfinite(bandpass)] = 0
        interp = scipy.interpolate.interp1d(delay[isort], bandpass[isort],
                                            bounds_error=False, fill_value=0)
    else:
        def interp(time):
            return 1

    tmax = 4.15e3 * ddm * (flo**-2 - fhi**-2)

    def smear(times):
        weights = interp(times) / np.sqrt(
            times / 4.15e3 / ddm + fhi**-2
        ) / (2 * 4.15e3 * ddm)
        if tmax > 0:
            weights[(times < 0) | (tmax < times)] = 0
        else:
            weights[(times < tmax) | (0 < times)] = 0
        return weights

    return smear
