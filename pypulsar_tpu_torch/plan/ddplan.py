"""Dedispersion plan generator: a host copy of
``pypulsar_tpu/plan/ddplan.py`` (DDplan2b, itself PRESTO's DDplan.py
rewritten; the port imports nothing of the JAX package).

Given the observation's sampling, band and DM range, a staged plan of
(downsample factor, DM step, number of DMs, optional subband counts) that
bounds the total smearing while minimizing work. Pure host arithmetic;
:func:`pypulsar_tpu_torch.parallel.staged.sweep_ddplan` sweeps each
step's trial list ``step.DMs``. :meth:`DDplan.plot` writes the
smearing plot's arrays to an ``.npz`` name without matplotlib, and draws
it with matplotlib otherwise.
"""

import numpy as np

from pypulsar_tpu_torch.core.psrmath import dm_smear

# Allowable DM step sizes (pc cm^-3)
ALLOW_DMSTEPS = [
    0.01, 0.02, 0.03, 0.05, 0.1, 0.2, 0.3, 0.5, 1.0,
    2.0, 3.0, 5.0, 10.0, 20.0, 30.0, 50.0, 100.0, 200.0, 300.0,
]
# Maximum downsampling factor
MAX_DOWNFACTOR = 64
# Fudge factor that "softens" the boundary defining whether two time scales
# are equal
FF = 1.2
# Allowable single-channel smearing relative to all other contributions
SMEARFACT = 2.0


def guess_DMstep(dt, BW, fctr):
    """DM step that makes smearing across ``BW`` equal the sampling time.

    dt in s, BW and fctr in MHz (reference utils/DDplan2b.py:438-447).
    """
    return dt * 0.0001205 * fctr**3.0 / BW


class Observation:
    """Observation parameters relevant to dedispersion planning."""

    def __init__(self, dt, fctr, BW, numchan, numsamp=0):
        self.dt = dt
        self.fctr = fctr
        self.BW = BW
        self.numchan = numchan
        self.chanwidth = BW / numchan
        self.numsamp = numsamp
        self.allow_factors = self.get_allow_downfactors()

    def gen_ddplan(self, loDM, hiDM, numsub=0, resolution=0.0, verbose=False):
        """Generate a DDplan for this observation over [loDM, hiDM]."""
        return DDplan(loDM, hiDM, self, numsub, resolution, verbose)

    def get_allow_downfactors(self):
        """Downsample factors <= MAX_DOWNFACTOR: divisors of numsamp if
        given, else powers of 2."""
        if self.numsamp:
            factors = np.arange(1, MAX_DOWNFACTOR + 1)
            return list(factors[(self.numsamp % factors) == 0])
        return list(2 ** np.arange(0, int(np.log2(MAX_DOWNFACTOR)) + 1, dtype="int"))


class DDstep:
    """One block of a dedispersion plan with constant downsampling and DM
    step size."""

    def __init__(self, ddplan, downsamp, loDM, dDM, numDMs=0, numsub=0,
                 smearfact=2.0):
        self.ddplan = ddplan
        self.downsamp = downsamp
        self.loDM = loDM
        self.dDM = dDM
        self.numsub = numsub
        obs = ddplan.obs
        self.BW_smearing = dm_smear(dDM * 0.5, obs.BW, obs.fctr)
        self.numprepsub = 0
        if numsub:
            # Largest subband step whose smearing stays below the other
            # contributions (0.8 fudge keeps it strictly smallest)
            DMs_per_prepsub = 2
            while True:
                next_dsubDM = (DMs_per_prepsub + 2) * dDM
                next_ss = dm_smear(next_dsubDM * 0.5, obs.BW / numsub, obs.fctr)
                if next_ss > 0.8 * min(self.BW_smearing, obs.dt * self.downsamp):
                    self.dsubDM = DMs_per_prepsub * dDM
                    self.DMs_per_prepsub = DMs_per_prepsub
                    self.sub_smearing = dm_smear(
                        self.dsubDM * 0.5, obs.BW / self.numsub, obs.fctr
                    )
                    break
                DMs_per_prepsub += 2
        else:
            self.dsubDM = dDM
            self.sub_smearing = 0.0

        # DM at which channel smearing crosses smearfact x other smearing
        cross_DM = self.DM_for_smearfact(smearfact)
        if cross_DM > ddplan.hiDM:
            cross_DM = ddplan.hiDM
        if numDMs == 0:
            self.numDMs = int(np.ceil((cross_DM - self.loDM) / self.dDM))
            if numsub:
                self.numprepsub = int(np.ceil(self.numDMs * self.dDM / self.dsubDM))
                self.numDMs = self.numprepsub * DMs_per_prepsub
        else:
            self.numDMs = numDMs
        self.hiDM = loDM + self.numDMs * dDM
        self.DMs = np.arange(self.numDMs, dtype="d") * self.dDM + self.loDM

        self.chan_smear = dm_smear(self.DMs, obs.chanwidth, obs.fctr)
        self.tot_smear = np.sqrt(
            obs.dt**2.0
            + (obs.dt * self.downsamp) ** 2.0
            + self.BW_smearing**2.0
            + self.sub_smearing**2.0
            + self.chan_smear**2.0
        )

    def DM_for_smearfact(self, smearfact):
        """DM where single-channel smearing = smearfact x all other causes."""
        obs = self.ddplan.obs
        other_smear = np.sqrt(
            obs.dt**2.0
            + (obs.dt * self.downsamp) ** 2.0
            + self.BW_smearing**2.0
            + self.sub_smearing**2.0
        )
        return guess_DMstep(smearfact * other_smear, obs.chanwidth, obs.fctr)

    def __str__(self):
        if self.numsub:
            return "%9.3f  %9.3f  %6.2f    %4d  %6.2f  %6d  %6d  %6d " % (
                self.loDM, self.hiDM, self.dDM, self.downsamp, self.dsubDM,
                self.numDMs, self.DMs_per_prepsub, self.numprepsub,
            )
        return "%9.3f  %9.3f  %6.2f    %4d  %6d" % (
            self.loDM, self.hiDM, self.dDM, self.downsamp, self.numDMs,
        )


class DDplan:
    """A staged dedispersion plan: a list of DDsteps covering [loDM, hiDM]."""

    def __init__(self, loDM, hiDM, obs, numsub=0, resolution=0.0, verbose=False):
        self.loDM = loDM
        self.hiDM = hiDM
        self.obs = obs
        self.numsub = numsub
        self.req_resolution = resolution * 0.001  # ms -> s
        self.current_downfact = self.obs.allow_factors[0]
        self.current_dDM = ALLOW_DMSTEPS[0]
        self.DDsteps = []

        self.calc_min_smearing(verbose=verbose)

        # Initial downsampling: largest factor keeping dt below resolution
        while (self.obs.dt * self.get_next_downfact()) < self.resolution:
            self.current_downfact = self.get_next_downfact()
        if verbose:
            print(
                "        New dt is %d x %.12g s = %.12g s"
                % (self.current_downfact, self.obs.dt,
                   self.current_downfact * self.obs.dt)
            )

        # Initial dDM: largest allowed step below the optimal guess
        dDM = guess_DMstep(self.obs.dt * self.current_downfact,
                           0.5 * self.obs.BW, self.obs.fctr)
        if verbose:
            print("Best guess for optimal initial dDM is %.3f" % dDM)
        while self.get_next_dDM() < dDM:
            self.current_dDM = self.get_next_dDM()
        self.DDsteps.append(
            DDstep(self, self.current_downfact, self.loDM, self.current_dDM,
                   numsub=self.numsub, smearfact=SMEARFACT)
        )

        # Subsequent steps: double downsampling, grow dDM while BW smearing
        # stays below FF x effective dt
        while self.DDsteps[-1].hiDM < self.hiDM:
            self.current_downfact = self.get_next_downfact()
            eff_dt = self.obs.dt * self.current_downfact
            while dm_smear(0.5 * self.get_next_dDM(), self.obs.BW,
                           self.obs.fctr) < FF * eff_dt:
                self.current_dDM = self.get_next_dDM()
            self.DDsteps.append(
                DDstep(self, self.current_downfact, self.DDsteps[-1].hiDM,
                       self.current_dDM, numsub=self.numsub,
                       smearfact=SMEARFACT)
            )

        # Predicted per-step search-time fraction: numDMs / downsamp
        wfs = [step.numDMs / float(step.downsamp) for step in self.DDsteps]
        self.work_fracts = np.asarray(wfs) / np.sum(wfs)

    def get_next_dDM(self):
        for dDM in ALLOW_DMSTEPS:
            if dDM > self.current_dDM:
                return dDM
        raise ValueError("No allowable DM steps left!")

    def get_next_downfact(self):
        index = self.obs.allow_factors.index(self.current_downfact)
        if (index + 1) < len(self.obs.allow_factors):
            return self.obs.allow_factors[index + 1]
        raise ValueError("No allowable downsample factors left!")

    def calc_min_smearing(self, verbose=False):
        """Smallest achievable smearing; sets self.resolution."""
        half_dDMmin = 0.5 * ALLOW_DMSTEPS[0]
        self.min_chan_smear = dm_smear(self.loDM + half_dDMmin,
                                       self.obs.chanwidth, self.obs.fctr)
        self.min_bw_smear = dm_smear(half_dDMmin, self.obs.BW, self.obs.fctr)
        self.min_total_smear = np.sqrt(
            2 * self.obs.dt**2.0 + self.min_chan_smear**2.0 + self.min_bw_smear**2.0
        )
        self.best_resolution = max(
            [self.req_resolution, self.min_chan_smear, self.min_bw_smear, self.obs.dt]
        )
        self.resolution = self.best_resolution
        if verbose:
            print()
            print("Minimum total smearing     : %.3g s" % self.min_total_smear)
            print("--------------------------------------------")
            print("Minimum channel smearing   : %.3g s" % self.min_chan_smear)
            print("Minimum smearing across BW : %.3g s" % self.min_bw_smear)
            print("Minimum sample time        : %.3g s" % self.obs.dt)
            print()
            print("Setting the new 'best' resolution to : %.3g s" % self.best_resolution)

        # Data may be higher time resolution than needed
        if (FF * self.min_chan_smear > self.obs.dt) or (self.resolution > self.obs.dt):
            if self.resolution > FF * self.min_chan_smear:
                if verbose:
                    print("   Note: resolution > dt (i.e. data is higher resolution than needed)")
            else:
                if verbose:
                    print("   Note: min chan smearing > dt (i.e. data is higher resolution than needed)")
                self.resolution = FF * self.min_chan_smear

    def all_dms(self):
        """Concatenated DM trial list over all steps."""
        return np.concatenate([step.DMs for step in self.DDsteps])

    def plot_arrays(self) -> dict:
        """The smearing plot's curves: each step's DMs (``step_dms``,
        ``step_index`` naming the step of each), sample time, DM-step,
        subband-step and total smearing, and over every DM the optimal
        and channel smearing."""
        allDMs = np.concatenate([step.DMs for step in self.DDsteps])
        chan_smear = dm_smear(allDMs, self.obs.chanwidth, self.obs.fctr)
        bw_smear = dm_smear(ALLOW_DMSTEPS[0], self.obs.BW, self.obs.fctr)
        return dict(
            step_dms=allDMs,
            step_index=np.concatenate([np.full(step.numDMs, ii) for ii, step
                                       in enumerate(self.DDsteps)]),
            sample_time=np.concatenate([
                np.zeros(step.numDMs) + self.obs.dt * step.downsamp
                for step in self.DDsteps]),
            dm_step_smearing=np.concatenate([
                np.zeros(step.numDMs) + step.BW_smearing
                for step in self.DDsteps]),
            sub_smearing=np.concatenate([
                np.zeros(step.numDMs) + (step.sub_smearing if self.numsub
                                         else 0.0)
                for step in self.DDsteps]),
            total_smearing=np.concatenate([step.tot_smear
                                           for step in self.DDsteps]),
            work_fracts=np.asarray(self.work_fracts, dtype=np.float64),
            optimal_smearing=np.sqrt(2 * self.obs.dt**2.0 + chan_smear**2.0
                                     + bw_smear**2.0),
            channel_smearing=chan_smear)

    def plot(self, fn=None):
        """Smearing-vs-DM summary plot. ``fn`` ending in ``.npz`` gets
        :meth:`plot_arrays` (no matplotlib) and None is returned; any
        other ``fn`` is drawn with matplotlib and saved, None shows it."""
        from pypulsar_tpu_torch.cli import save_arrays

        if save_arrays(fn, **self.plot_arrays()):
            return None
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(11, 8.5))
        stepDMs = []
        for ii, (step, wf) in enumerate(zip(self.DDsteps, self.work_fracts)):
            stepDMs.append(step.DMs)
            plt.plot(step.DMs, np.zeros(step.numDMs) + self.obs.dt * step.downsamp,
                     "#33CC33", label=(ii and "_nolegend_") or "Sample Time (ms)")
            plt.plot(step.DMs, np.zeros(step.numDMs) + step.BW_smearing, "r",
                     label=(ii and "_nolegend_") or "DM Stepsize Smearing")
            if self.numsub:
                plt.plot(step.DMs, np.zeros(step.numDMs) + step.sub_smearing,
                         "#993399",
                         label=(ii and "_nolegend_") or "Subband Stepsize Smearing")
            plt.plot(step.DMs, step.tot_smear, "k",
                     label=(ii and "_nolegend_") or "Total Smearing")
            midDM = step.DMs.min() + np.ptp(step.DMs) * 0.5
            plt.text(midDM, 1.1 * np.median(step.tot_smear),
                     "%d (%.1f%%)" % (step.numDMs, 100.0 * wf),
                     rotation="vertical", size="small", ha="center", va="bottom")
        arrays = self.plot_arrays()
        allDMs, tot_smear = arrays["step_dms"], arrays["optimal_smearing"]
        plt.plot(allDMs, tot_smear, "#FF9933", label="Optimal Smearing")
        plt.plot(allDMs, arrays["channel_smearing"], "b",
                 label="Channel Smearing")
        plt.yscale("log")
        plt.xlabel(r"Dispersion Measure (pc cm$^{-3}$)")
        plt.ylabel(r"Smearing (s)")
        plt.xlim(allDMs.min(), allDMs.max())
        plt.ylim(0.3 * tot_smear.min(), 2.5 * tot_smear.max())
        plt.legend(loc="lower right")
        if fn is not None:
            plt.savefig(fn, orientation="landscape")
        else:
            plt.show()
        return fig

    def __str__(self):
        lines = []
        if self.numsub:
            lines.append("\n  Low DM    High DM     dDM  DownSamp  dsubDM   #DMs  DMs/call  calls  WorkFract")
        else:
            lines.append("\n  Low DM    High DM     dDM  DownSamp   #DMs  WorkFract")
        for ddstep, wf in zip(self.DDsteps, self.work_fracts):
            lines.append("%s   %.4g" % (ddstep, wf))
        lines.append("\n")
        return "\n".join(lines)
