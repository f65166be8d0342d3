"""Single-pulse profiles: one rotation of a dedispersed series each.

A copy of ``pypulsar_tpu/fold/pulse.py`` (the reference's
formats/pulse.py), host numpy as there: the ``Pulse`` profile with its
on/off-pulse phase regions and conditioning ops, the pulse text format,
and ``SummedPulse`` accumulation with a per-file pulse registry. Profiles
hold hundreds to thousands of bins and the logic is branch-heavy, so no
device runs it. The reference's Py2-era defects are fixed as in the JAX
package: exceptions instead of string raises, true division for bin
indices. ``Pulse.plot`` imports matplotlib only when it is called.
"""

from __future__ import annotations

import copy
import os.path
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.signal


class OnPulseRegionError(Exception):
    """Error when on-pulse region is ill-defined."""

    def __str__(self):
        return f"On-pulse region is ill-defined. {self.args[0] if self.args else ''}"


class PulseIncompatibleError(Exception):
    """Raised when summing pulses with incompatible bin widths."""


class PulseConflictError(Exception):
    """Raised when the same pulse would be summed twice."""


class Pulse:
    """One pulse: profile slice + metadata (reference pulse.py:24-67).

    on_pulse_regions: list of (lo, hi) rotational-phase pairs in [0, 1].
    """

    def __init__(self, number, mjd, time, duration, profile, origfn, dt, dm,
                 telescope, lofreq, chan_width, bw, on_pulse_regions=None):
        self.number = number
        self.mjd = mjd
        self.time = time
        self.duration = duration
        self.profile = np.asarray(profile, dtype=np.float64).flatten()
        self.N = self.profile.size
        self.dt = dt
        self.dm = dm
        self.telescope = telescope
        self.lofreq = lofreq
        self.chan_width = chan_width
        self.bw = bw
        self.origfn = origfn
        if isinstance(on_pulse_regions, (list, np.ndarray)) and len(on_pulse_regions):
            self.set_onoff_pulse_regions(on_pulse_regions)
        else:
            self.on_pulse = None
            self.off_pulse = None

    def __str__(self):
        return (
            f"Pulse #: {self.number}\n\tMJD: {self.mjd:0.15f}\n"
            f"\tTime: {self.time:8.2f} s\n\tDuration: {self.duration:8.4f} s\n"
        )

    def set_onoff_pulse_regions(self, on_pulse_regions: Sequence[Tuple[float, float]]):
        """Validate + store on-pulse regions; derive the complementary
        off-pulse regions (None endpoints = profile edge), per reference
        pulse.py:73-108."""
        on_pulse = np.array(on_pulse_regions).astype("float64")
        on_pulse = on_pulse[on_pulse.argsort(axis=0).transpose()[0]]
        if np.any(on_pulse.flat != np.sort(on_pulse.flatten())):
            raise OnPulseRegionError("On-pulse regions overlap or are inverted")
        self.on_pulse = on_pulse
        off = list(on_pulse.flatten())
        if off[0] == 0.0:
            off = off[1:]
        else:
            off = [None] + off
        if off[-1] == 1.0:
            off = off[:-1]
        else:
            off = off + [None]
        self.off_pulse = np.array(off, dtype=object).reshape(len(off) // 2, 2)

    def get_data(self, regions=None) -> np.ndarray:
        """Concatenate profile data from phase regions (reference :110-131)."""
        if regions is None or len(regions) == 0:
            regions = [(None, None)]
        data = []
        for lo, hi in regions:
            lobin = None if lo is None else int(self.N * lo)
            hibin = None if hi is None else int(self.N * hi)
            if lobin is not None and hibin is not None and hibin <= lobin:
                raise OnPulseRegionError(f"lobin={lobin}, hibin={hibin}")
            data.append(self.profile[lobin:hibin])
        return np.concatenate(data)

    def get_on_pulse(self) -> np.ndarray:
        return self.get_data(self.on_pulse)

    def get_off_pulse(self) -> np.ndarray:
        return self.get_data(self.off_pulse)

    def get_pulse_energies(self) -> Tuple[float, float]:
        """(on-pulse, off-pulse) energies of the scaled profile (:145-157)."""
        c = self.make_copy()
        c.scale()
        return float(np.sum(c.get_on_pulse())), float(np.sum(c.get_off_pulse()))

    def make_copy(self) -> "Pulse":
        return copy.deepcopy(self)

    def scale(self):
        """Subtract off-pulse mean, divide by off-pulse std, in place (:165-175)."""
        off = self.get_off_pulse()
        self.profile = (self.profile - np.mean(off)) / np.std(off)

    def downsample(self, downfactor: int = 1):
        """Co-add ``downfactor`` adjacent bins in place; must divide N (:177-195)."""
        if downfactor > 1:
            if self.N % downfactor != 0:
                raise ValueError(
                    f"downfactor ({downfactor}) is not a factor of profile "
                    f"length ({self.N})"
                )
            self.N = self.N // downfactor
            self.profile = self.profile[: self.N * downfactor].reshape(
                self.N, downfactor
            ).sum(axis=1)
            self.dt *= downfactor

    def downsample_Nbins(self, N: int):
        """Downsample (by averaging) to exactly N bins; leftovers dropped (:197-215)."""
        if N > self.N:
            raise ValueError(
                f"Cannot downsample: new profile ({N}) longer than old ({self.N})"
            )
        downfactor = self.N // N
        numleftover = self.N % N
        prof = self.profile[: self.N - numleftover] if numleftover else self.profile
        self.profile = prof[: N * downfactor].reshape(N, downfactor).mean(axis=1)
        self.N = N
        self.dt *= downfactor

    def smooth(self, smoothfactor: int = 1):
        """RMS-preserving boxcar smooth with wrap padding, in place (:217-241)."""
        if smoothfactor > 1:
            kernel = np.ones(smoothfactor, dtype="float32") / np.sqrt(smoothfactor)
            prof = np.concatenate(
                [self.profile[-smoothfactor:], self.profile, self.profile[:smoothfactor]]
            )
            sm = scipy.signal.convolve(prof, kernel, "same")
            self.profile = sm[smoothfactor:-smoothfactor]

    def detrend(self, numchunks: int = 5):
        """Piecewise-linear detrend in place (:243-250)."""
        bp = np.round(np.linspace(0, self.N, numchunks + 1)).astype(int)
        self.profile = scipy.signal.detrend(self.profile, bp=bp)

    def interpolate(self, numsamples: int):
        """Linear re-interpolation to ``numsamples`` bins, in place (:252-261)."""
        xp = np.arange(self.N)
        x = np.linspace(0, self.N - 1, numsamples)
        self.profile = np.interp(x, xp, self.profile)
        self.dt = self.dt * self.N / float(numsamples)
        self.N = numsamples

    def interp_and_downsamp(self, numsamples: int):
        """Interpolate then downsample to ``numsamples`` bins (:263-279).

        The reference's ``int(N / numsamples) + 1`` is a py2-heritage
        ceil-div that over-downsamples when ``N % numsamples == 0``: at
        an exact multiple it interpolated to a LARGER grid than the
        profile has (resampling distortion for no reason) where the true
        ceiling is the exact factor and the interpolation is the
        identity."""
        downsamp = -(-self.N // numsamples)
        warnings.warn("interp_and_downsamp() may be unreliable")
        self.interpolate(downsamp * numsamples)
        self.downsample(downsamp)

    def is_masked(self, numchunks: int = 5) -> bool:
        """True if any of ``numchunks`` profile sections is flat (:281-294)."""
        edges = np.round(np.linspace(0, self.profile.size, numchunks + 1)).astype(int)
        for i in range(numchunks):
            if np.ptp(self.profile[edges[i] : edges[i + 1]]) == 0:
                return True
        return False

    def get_snr(self) -> float:
        """Max of the scaled on-pulse region (reference bin/dissect.py:358-369)."""
        c = self.make_copy()
        c.scale()
        return float(np.max(c.get_on_pulse() if c.on_pulse is not None else c.profile))

    def plot(self, basefn: Optional[str] = None, downfactor: int = 1,
             smoothfactor: int = 1, shownotes: bool = False,
             decorate: bool = False):
        """Plot the scaled profile to ``<basefn>.prof<number>.ps``
        (reference formats/pulse.py:296-337).  ``decorate`` adds off-pulse
        mean and +1-sigma lines; ``shownotes`` annotates the smoothing."""
        import matplotlib.pyplot as plt

        if basefn is None:
            basefn, _ = os.path.splitext(self.origfn)
        copy = self.make_copy()
        if smoothfactor > 1:
            copy.smooth(smoothfactor)
        copy.scale()
        plt.figure()
        if decorate and copy.on_pulse is not None:
            off = copy.get_off_pulse()
            avg, std = float(np.mean(off)), float(np.std(off))
            plt.axhline(avg, color="k", linestyle="--")
            plt.axhline(avg + std, color="k", linestyle=":")
        if shownotes:
            snrmax = float(np.max(copy.get_on_pulse()
                                  if copy.on_pulse is not None
                                  else copy.profile))
            plt.figtext(0.05, 0.025,
                        "Smooth factor: %d, Downsample factor: %d, "
                        "Max SNR: %f" % (smoothfactor, downfactor, snrmax),
                        size="xx-small")
        if downfactor > 1:
            copy.downsample(downfactor)
        plt.plot(copy.profile, "k-", lw=0.5)
        plt.xlabel("Profile bin")
        plt.title("Pulse #%d" % self.number)
        outfn = "%s.prof%d.ps" % (basefn, self.number)
        plt.savefig(outfn, orientation="landscape")
        plt.close()
        return outfn

    # --- text format (reference :339-374) ---
    def _header_lines(self) -> List[str]:
        lines = [
            f"# Original data file              = {self.origfn}\n",
            f"# Pulse Number                    = {self.number:d}\n",
            f"# MJD of start of pulse           = {self.mjd:0.15f}\n",
            f"# Time into observation (seconds) = {self.time:f}\n",
            f"# Duration of pulse (seconds)     = {self.duration:0.15f}\n",
            f"# Profile bins                    = {self.N:d}\n",
            f"# Width of profile bin (seconds)  = {self.dt:g}\n",
            f"# Dispersion Measure (cm^-3 pc)   = {self.dm:f}\n",
            f"# Telescope                       = {self.telescope}\n",
            f"# Low frequency mid-channel (MHz) = {self.lofreq:0.15f}\n",
            f"# Channel width (MHz)             = {self.chan_width:0.15f}\n",
            f"# Total bandwidth (MHz)           = {self.bw:0.15f}\n",
        ]
        if self.on_pulse is not None:
            for i, (lo, hi) in enumerate(self.on_pulse):
                lines.append(f"# On-pulse region {i:2d} (phase)      = {lo:f}-{hi:f}\n")
        return lines

    def write_to_file(self, basefn: Optional[str] = None):
        if basefn is None:
            basefn, _ = os.path.splitext(self.origfn)
        fn = f"{os.path.split(basefn)[1]}.prof{self.number}"
        with open(fn, "w") as f:
            f.writelines(self._header_lines())
            f.write("###################################\n")
            for i, val in enumerate(self.profile):
                f.write(f"{i:<10d} {val:f}\n")
        return fn

    def to_summed_pulse(self) -> "SummedPulse":
        return SummedPulse(
            self.number, self.mjd, self.time, self.duration, self.profile,
            self.origfn, self.dt, self.dm, self.telescope, self.lofreq,
            self.chan_width, self.bw, self.on_pulse,
        )

    def __add__(self, other):
        if hasattr(other, "pulse_registry"):
            summed = other.make_copy()
        else:
            summed = other.make_copy().to_summed_pulse()
        summed += self
        return summed


class SummedPulse(Pulse):
    """Accumulating pulse sum with a per-file registry of summed pulse
    numbers and double-count detection (reference pulse.py:402-536)."""

    def __init__(self, number, mjd, time, duration, profile, origfn, dt, dm,
                 telescope, lofreq, chan_width, bw, on_pulse_regions=None,
                 init_registry=None, init_count=1):
        super().__init__(number, mjd, time, duration, profile, origfn, dt, dm,
                         telescope, lofreq, chan_width, bw, on_pulse_regions)
        self.pulse_registry = init_registry if init_registry is not None else {origfn: [number]}
        self.count = init_count

    def __iadd__(self, other: Pulse) -> "SummedPulse":
        if self.dt != other.dt:
            raise PulseIncompatibleError(
                f"Incompatible bin widths: {self.dt} vs {other.dt}"
            )
        # validate the whole merge before mutating anything, so a conflict
        # raised mid-merge can't leave the registry out of sync with the profile
        if hasattr(other, "pulse_registry"):
            incoming = other.pulse_registry
            ocount = other.count
        else:
            incoming = {other.origfn: [other.number]}
            ocount = 1
        for fn, nums in incoming.items():
            mine = self.pulse_registry.get(fn, [])
            for num in nums:
                if num in mine:
                    raise PulseConflictError(f"Pulse {fn}:{num} already summed")
        for fn, nums in incoming.items():
            self.pulse_registry.setdefault(fn, []).extend(nums)

        self.N = int(np.min([self.N, other.N]))
        self.duration = float(np.min([self.duration, other.duration]))
        self.profile = self.profile[: self.N] + other.profile[: self.N]
        tot = float(self.count + ocount)
        self.number = (self.count * self.number + ocount * other.number) / tot
        self.time = (self.count * self.time + ocount * other.time) / tot
        self.mjd = (self.count * self.mjd + ocount * other.mjd) / tot
        self.count += ocount
        return self

    def __contains__(self, item) -> bool:
        if hasattr(item, "pulse_registry"):
            for fn, nums in item.pulse_registry.items():
                mine = self.pulse_registry.get(fn, [])
                if any(num in mine for num in nums):
                    return True
            return False
        return (
            item.origfn in self.pulse_registry
            and item.number in self.pulse_registry[item.origfn]
        )

    def write_to_file(self, basefn: Optional[str] = None):
        if basefn is None:
            basefn, _ = os.path.splitext(self.origfn)
        fn = f"{basefn}.summedprof"
        with open(fn, "w") as f:
            f.write(f"# Original data file              = {self.origfn}\n")
            f.write(f"# Pulse Number                    = {int(self.number):d}\n")
            f.write(f"# MJD of start of pulse           = {self.mjd:0.15f}\n")
            f.write(f"# Time into observation (seconds) = {self.time:f}\n")
            f.write(f"# Duration of pulse (seconds)     = {self.duration:0.15f}\n")
            f.write(f"# Profile bins                    = {self.N:d}\n")
            f.write(f"# Width of profile bin (seconds)  = {self.dt:g}\n")
            if self.on_pulse is not None:
                for i, (lo, hi) in enumerate(self.on_pulse):
                    f.write(f"# On-pulse region {i:2d} (phase)      = {lo:f}-{hi:f}\n")
            f.write(f"# Number of profiles summed       = {self.count:d}\n")
            for reg_fn in self.pulse_registry:
                for num in sorted(self.pulse_registry[reg_fn]):
                    f.write(f"# Pulse registry                  = {reg_fn}:{num}\n")
            f.write("###################################\n")
            for i, val in enumerate(self.profile):
                f.write(f"{i:<10d} {val:f}\n")
        return fn


def read_pulse_from_file(filename: str) -> Pulse:
    """Parse the pulse text format back into a Pulse (reference :539-580)."""
    profile = []
    on_pulse_regions = []
    meta = dict(origfn=None, number=0, mjd=0.0, time=0.0, duration=0.0, dt=0.0,
                dm=0.0, telescope=None, lofreq=0.0, chan_width=0.0, bw=0.0)
    with open(filename) as f:
        for line in f:
            if line.startswith("# Original data file"):
                meta["origfn"] = line.split("=")[-1].strip()
            elif line.startswith("# Pulse Number"):
                meta["number"] = int(line.split("=")[-1].strip())
            elif line.startswith("# MJD of start of pulse"):
                meta["mjd"] = float(line.split("=")[-1].strip())
            elif line.startswith("# Time into observation (seconds)"):
                meta["time"] = float(line.split("=")[-1].strip())
            elif line.startswith("# Duration of pulse (seconds)"):
                meta["duration"] = float(line.split("=")[-1].strip())
            elif line.startswith("# Width of profile bin (seconds)"):
                meta["dt"] = float(line.split("=")[-1].strip())
            elif line.startswith("# Dispersion Measure (cm^-3 pc)"):
                meta["dm"] = float(line.split("=")[-1].strip())
            elif line.startswith("# Telescope"):
                meta["telescope"] = line.split("=")[-1].strip()
            elif line.startswith("# Low frequency mid-channel (MHz)"):
                meta["lofreq"] = float(line.split("=")[-1].strip())
            elif line.startswith("# Channel width (MHz)"):
                meta["chan_width"] = float(line.split("=")[-1].strip())
            elif line.startswith("# Total bandwidth (MHz)"):
                meta["bw"] = float(line.split("=")[-1].strip())
            elif line.startswith("# On-pulse region"):
                val = line.split("=")[-1]
                lo, hi = val.split("-")[0].strip(), val.split("-")[1].strip()
                on_pulse_regions.append((float(lo), float(hi)))
            elif line.startswith("#"):
                pass
            else:
                profile.append(float(line.split()[-1].strip()))
    return Pulse(
        meta["number"], meta["mjd"], meta["time"], meta["duration"],
        np.array(profile), meta["origfn"], meta["dt"], meta["dm"],
        meta["telescope"], meta["lofreq"], meta["chan_width"], meta["bw"],
        on_pulse_regions,
    )
