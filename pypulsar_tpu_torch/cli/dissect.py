"""Cut a ``.dat`` series into single pulses, search them, and write
TOAs.

Port of ``pypulsar_tpu/cli/dissect.py`` (the reference's bin/dissect.py),
host numpy and scipy as there: the period from a parfile (through the
port's polycos), a polyco file or a constant; each rotation
boxcar-smoothed at every width and kept when its SNR passes the
threshold; the report; per-pulse text files and plots; the joy-division
plot; and Princeton TOAs from summed pulses by FFTFIT template matching
with PRESTO get_TOAs' DM-delay bookkeeping. ``-o FILE.npz`` writes the
arrays of every plot asked for (``pulse<N>``: each kept pulse as its plot
draws it; ``joydiv<N>``, ``joydiv_numbers``, ``joydiv_summed``: the
joy-division plot; ``toa<N>_profile``, ``toa<N>_template``,
``toa_phases``: the TOA plots) to that one file instead, and imports no
matplotlib.

Run as ``python -m pypulsar_tpu_torch.cli.dissect FILE.dat -p PERIOD -r
0.2:0.4``.
"""

from __future__ import annotations

import argparse
import os.path
import sys
from typing import List, Tuple

import numpy as np

from pypulsar_tpu_torch.astro import telescopes
from pypulsar_tpu_torch.cli import (save_arrays,
                                    use_headless_backend_if_needed)
from pypulsar_tpu_torch.core import psrmath
from pypulsar_tpu_torch.fold import polycos as polycos_mod
from pypulsar_tpu_torch.fold.toa import emit_princeton_toa, presto_freq_offsets
from pypulsar_tpu_torch.io.datfile import Datfile

JOYDIV_SEP = 0.5
DEFAULT_WIDTHS = [1, 2, 4, 8, 16, 32]


def get_snr(pulse) -> float:
    """Max of the scaled on-pulse region (reference dissect.py:358-369;
    delegates to Pulse.get_snr)."""
    return pulse.get_snr()


def search_pulses(timeseries: Datfile, get_period, on_pulse_regions,
                  widths=DEFAULT_WIDTHS, threshold=5.0, no_toss=False,
                  shift_time=0.0):
    """Iterate single pulses, boxcar-smooth at each width, keep those whose
    best SNR beats the threshold.  Returns (good_pulses, snrs, widths,
    notes, numpulses, nummasked)."""
    good_pulses, snrs, best_widths, notes = [], [], [], []
    nummasked = numpulses = 0
    for current_pulse in timeseries.pulses(get_period,
                                           time_to_skip=shift_time):
        numpulses += 1
        current_pulse.set_onoff_pulse_regions(on_pulse_regions)
        if current_pulse.is_masked(numchunks=5) and not no_toss:
            nummasked += 1
            continue
        maxsnr = 0.0
        for numbins in widths:
            pulse = current_pulse.make_copy()
            pulse.smooth(numbins)
            snr = get_snr(pulse)
            if np.isnan(snr) or snr < 0:
                snr = 0.0
            if snr > threshold and snr >= maxsnr:
                if maxsnr == 0.0:
                    snrs.append(snr)
                    best_widths.append(numbins)
                    notes.append("smoothed by %3d bins" % numbins)
                    good_pulses.append(current_pulse)
                else:
                    snrs[-1] = snr
                    best_widths[-1] = numbins
                    notes[-1] = "smoothed by %3d bins" % numbins
                maxsnr = snr
    return good_pulses, snrs, best_widths, notes, numpulses, nummasked


def pulse_plot_profile(pulse, smoothfactor=1, downfactor=1) -> np.ndarray:
    """The profile ``Pulse.plot`` draws: smoothed, scaled, downsampled."""
    copy = pulse.make_copy()
    if smoothfactor > 1:
        copy.smooth(smoothfactor)
    copy.scale()
    if downfactor > 1:
        copy.downsample(downfactor)
    return copy.profile


def print_report(pulses, numpulses, nummasked, snrs=None, notes=None,
                 quiet=False):
    print("Autopsy report:")
    print("\tTotal number of pulses searched: %s" % numpulses)
    denom = max(numpulses, 1)
    print("\tNumber of pulses thrown out: %s (%5.2f%%)" %
          (nummasked, nummasked / denom * 100))
    print("\tNumber of good pulses found: %s (%5.2f%%)" %
          (len(pulses), len(pulses) / denom * 100))
    if pulses and not quiet:
        use_snrs = "SNR" if snrs is not None and len(snrs) == len(pulses) \
            else ""
        use_notes = "Notes" if notes is not None and \
            len(notes) == len(pulses) else ""
        print("%s%s%s%s%s%s" % ("#".center(7), "MJD".center(15),
                                "Time".center(11), "Duration".center(13),
                                use_snrs.center(9), use_notes))
        for i, pulse in enumerate(pulses):
            row = (("%d" % pulse.number).center(7) +
                   ("%5.4f" % pulse.mjd).center(15) +
                   ("%5.2f" % pulse.time).center(11) +
                   ("%2.4f" % pulse.duration).center(13))
            if use_snrs:
                row += ("%4.2f" % snrs[i]).center(9)
            if use_notes:
                row += notes[i]
            print(row)


def write_toa(summed_pulse, polycos, template_profile, timeseries,
              start_phase=0.0, debug=False) -> Tuple[float, float]:
    """Generate one Princeton TOA from a summed pulse (reference
    dissect.py:271-336, itself following PRESTO's get_TOAs.py).  Returns
    (pulseshift, templateshift) in rotational phase."""
    mjdi = int(summed_pulse.mjd)
    mjdf = summed_pulse.mjd - mjdi
    phs, freq = polycos.get_phs_and_freq(mjdi, mjdf)
    phs -= start_phase
    period = 1.0 / freq

    inf = timeseries.infdata
    midfreq, dmdelay = presto_freq_offsets(inf.lofreq, inf.BW,
                                           inf.chan_width, inf.DM)
    t0f = (mjdf - phs * period / psrmath.SECPERDAY +
           dmdelay / psrmath.SECPERDAY)
    obs_code = telescopes.telescope_to_id.get(inf.telescope, "@")
    return emit_princeton_toa(summed_pulse, template_profile, mjdi, t0f,
                              period, midfreq, inf.DM, obs_code)


def generate_toas(good_pulses, polycos, template, timeseries,
                  prof_start_phase, toa_threshold=0.0, min_pulses=1,
                  write_toa_files=False, debug=False, arrays=None) -> int:
    """Sum consecutive good pulses until the SNR threshold is passed, then
    emit a TOA (reference dissect.py:190-232). With ``arrays`` (a dict)
    the TOA plots' arrays go there instead of to ``TOA<N>.ps``."""
    numtoas = 0
    current_pulse = None
    numsummed = 0
    for pulse in good_pulses:
        if current_pulse is None:
            current_pulse = pulse.to_summed_pulse()
            numsummed = 1
        else:
            current_pulse += pulse
            numsummed += 1
        if numsummed < min_pulses:
            continue
        if get_snr(current_pulse) > toa_threshold:
            current_pulse.interp_and_downsamp(template.size)
            current_pulse.scale()
            pulseshift, templateshift = write_toa(
                current_pulse, polycos, template, timeseries,
                prof_start_phase, debug)
            numtoas += 1
            if write_toa_files:
                plot_toa(numtoas, current_pulse, template, pulseshift,
                         templateshift, arrays=arrays)
                current_pulse.write_to_file("TOA%d" % numtoas)
            current_pulse = None
            numsummed = 0
    print("Number of TOAs: %d" % numtoas)
    print("Number of pulses thrown out because 'min pulses' requirement "
          "or SNR threshold not met: %d" % numsummed)
    return numtoas


def toa_plot_arrays(pulse, template=None, pulseshift=0.0,
                    templateshift=0.0):
    """(phases, scaled profile, template rotated onto the profile or
    None) of one TOA plot."""
    copy = pulse.make_copy()
    copy.scale()
    phases = np.linspace(0, 1.0, copy.N)
    rotated = None
    if template is not None:
        shifted = (phases - templateshift + pulseshift) % (1.0 + 1e-7)
        rotated = template[np.argsort(shifted)]
    return phases, copy.profile, rotated


def plot_toa(numtoa, pulse, template=None, pulseshift=0.0,
             templateshift=0.0, basefn="", arrays=None):
    """Draw one TOA's profile and template to ``TOA<N>.ps``, or with
    ``arrays`` (a dict) put their arrays there instead."""
    phases, profile, rotated = toa_plot_arrays(pulse, template, pulseshift,
                                               templateshift)
    if arrays is not None:
        arrays["toa_phases"] = phases
        arrays["toa%d_profile" % numtoa] = profile
        if rotated is not None:
            arrays["toa%d_template" % numtoa] = rotated
        return
    use_headless_backend_if_needed(outfile=True)
    import matplotlib.pyplot as plt

    outfn = ("%s.TOA%d.ps" % (basefn, numtoa)) if basefn \
        else "TOA%d.ps" % numtoa
    plt.figure()
    plt.plot(phases, profile, "k-", lw=0.5)
    if rotated is not None:
        plt.plot(phases, rotated, "k:", lw=0.5)
    plt.xlabel("Phase (%d profile bins)" % len(profile))
    plt.ylabel("SNR")
    plt.title("TOA #%d" % numtoa)
    plt.savefig(outfn, orientation="landscape")
    plt.close()


def joy_division_arrays(pulses, downfactor=1):
    """(each pulse's drawn profile, their sum) of the joy-division plot:
    every profile interpolated and downsampled by ``downfactor``, the sum
    cut to the shortest."""
    profiles, summed_prof = [], None
    for pulse in pulses:
        copy = pulse.make_copy()
        if downfactor > 1:
            interp = (copy.N // downfactor + 1) * downfactor
            copy.interpolate(interp)
            copy.downsample(downfactor)
        profiles.append(copy.profile)
        if summed_prof is None:
            summed_prof = copy.profile.copy()
        else:
            n = min(summed_prof.size, copy.profile.size)
            summed_prof = summed_prof[:n] + copy.profile[:n]
    return profiles, summed_prof


def joy_division_plot(pulses, timeseries, downfactor=1, hgt_mult=1.0,
                      arrays=None):
    """All single-pulse profiles on one axes, vertically separated, plus a
    summed profile on top (matplotlib re-design of the reference's PGPLOT
    implementation at dissect.py:418-479), to ``<base>.joydiv.ps``; with
    ``arrays`` (a dict) their arrays go there instead."""
    profiles, summed_prof = joy_division_arrays(pulses, downfactor)
    if arrays is not None:
        for pulse, prof in zip(pulses, profiles):
            arrays["joydiv%d" % pulse.number] = prof
        arrays["joydiv_numbers"] = np.array([p.number for p in pulses])
        arrays["joydiv_summed"] = summed_prof
        return None
    use_headless_backend_if_needed(outfile=True)
    import matplotlib.pyplot as plt

    outfn = "%s.joydiv.ps" % os.path.split(timeseries.basefn)[1]
    fig = plt.figure(figsize=(10.25, hgt_mult * 8.5))
    ax = fig.add_axes((0.1, 0.1, 0.8, 0.7))
    for pulse, prof in zip(pulses, profiles):
        ax.plot(np.arange(prof.size), prof + (pulse.number - 1) * JOYDIV_SEP,
                "k-", lw=0.5)
    ax.set_xlabel("Profile bin")
    ax.set_ylabel("Single pulse profiles")
    sumax = fig.add_axes((0.1, 0.8, 0.8, 0.1), sharex=ax)
    sumax.plot(np.arange(summed_prof.size),
               summed_prof - summed_prof.mean(), "k-", lw=0.5)
    sumax.set_ylabel("Summed profile")
    sumax.set_title("Pulses from %s" % timeseries.datfn)
    plt.setp(sumax.get_xticklabels(), visible=False)
    fig.savefig(outfn)
    plt.close(fig)
    return outfn


def _parse_on_pulse(value: str) -> List[Tuple[float, float]]:
    out = []
    for pair in value.split(","):
        lo, _, hi = pair.partition(":")
        out.append((float(lo), float(hi)))
    return out


def build_parser():
    parser = argparse.ArgumentParser(
        prog="dissect.py",
        description="Dissect a PRESTO .dat time series into individual "
                    "pulses and record those surpassing the significance "
                    "threshold (TPU backend).")
    parser.add_argument("datfile", help="input .dat file")
    parser.add_argument("-t", "--threshold", type=float, default=5.0,
                        help="Single-pulse SNR threshold (default: 5)")
    parser.add_argument("-n", "--no-output-files", dest="create_output_files",
                        action="store_false", default=True,
                        help="Do not create output files per pulse")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--no-text-files", dest="create_text_files",
                        action="store_false", default=True)
    parser.add_argument("-q", "--quiet", action="store_true")
    parser.add_argument("--no-toss", action="store_true",
                        help="Do not toss out partially masked profiles")
    parser.add_argument("-r", "--on-pulse-regions", type=_parse_on_pulse,
                        default=None,
                        help="on-pulse regions as lo:hi[,lo:hi...] in "
                             "rotational phase")
    parser.add_argument("-w", "--widths",
                        type=lambda s: [int(w) for w in s.split(",")],
                        default=DEFAULT_WIDTHS,
                        help="comma-separated boxcar widths (default: %s)"
                             % DEFAULT_WIDTHS)
    parser.add_argument("-s", "--shift-phase", type=float, default=0.0,
                        help="Phase at which each pulse period begins")
    toa = parser.add_argument_group("TOA Generation")
    toa.add_argument("--toas", dest="write_toas", action="store_true")
    toa.add_argument("--template", default=None,
                     help="Template profile (text; 2nd column used)")
    toa.add_argument("--toa-threshold", type=float, default=0.0)
    toa.add_argument("--min-pulses", type=int, default=1)
    toa.add_argument("--write-toa-files", action="store_true")
    period = parser.add_argument_group("Period Determination")
    period.add_argument("--use-parfile", dest="parfile", default=None)
    period.add_argument("--use-polycos", dest="polycofile", default=None)
    period.add_argument("-p", "--use-period", dest="period", type=float,
                        default=None)
    plot = parser.add_argument_group("Plotting Options")
    plot.add_argument("-d", "--downsample", dest="downfactor", type=int,
                      default=1)
    plot.add_argument("--stretch-height", dest="heightstretch", type=float,
                      default=1.0)
    parser.add_argument("--no-pulse-plots", dest="create_plot_files",
                        action="store_false", default=True)
    parser.add_argument("--no-joydiv-plot", dest="create_joydiv_plot",
                        action="store_false", default=True)
    parser.add_argument("-o", "--outfile", default=None,
                        help="FILE.npz: write every plot's arrays there "
                             "instead of drawing (no matplotlib)")
    return parser


def main(argv=None):
    options = build_parser().parse_args(argv)
    nperiod = sum(x is not None for x in
                  (options.parfile, options.polycofile, options.period))
    if nperiod != 1:
        print("Exactly one (1) period determination option must be "
              "provided! Exiting...", file=sys.stderr)
        return 1
    if options.write_toas:
        if options.template is None:
            print("--toas requires --template.", file=sys.stderr)
            return 1
        if options.period is not None:
            print("--toas requires an ephemeris (--use-parfile or "
                  "--use-polycos); a constant period cannot anchor "
                  "absolute arrival times.", file=sys.stderr)
            return 1
    if options.outfile and not options.outfile.endswith(".npz"):
        print("-o takes a FILE.npz", file=sys.stderr)
        return 1
    # the plots' arrays, written to -o FILE.npz instead of drawn
    arrays = {} if options.outfile else None

    timeseries = Datfile(options.datfile)
    shift_phase = options.shift_phase - int(options.shift_phase)
    if shift_phase < 0.0:
        shift_phase += 1.0
    shift_time = 0.0
    prof_start_phase = 0.0
    polycos = None
    print("Searching %s for single pulses." % timeseries.datfn)

    if options.parfile is not None or options.polycofile is not None:
        if options.parfile is not None:
            print("Using parfile: %s" % options.parfile)
            polycos = polycos_mod.create_polycos_from_inf(
                options.parfile, timeseries.infdata)
        else:
            print("Using polycos file: %s" % options.polycofile)
            polycos = polycos_mod.Polycos(options.polycofile)
        mjd = timeseries.infdata.epoch
        mjdi, mjdf = int(mjd), mjd - int(mjd)
        phase, freq = polycos.get_phs_and_freq(mjdi, mjdf)
        if not options.on_pulse_regions:
            fidphase = 1.0 - phase
            if fidphase >= 0.9 or fidphase <= 0.1:
                shift_phase = (phase + 0.25) % 1.0
                fidphase = (fidphase - 0.25) % 1.0
            options.on_pulse_regions = [(fidphase - 0.1, fidphase + 0.1)]
        if shift_phase != 0.0:
            prof_start_phase = shift_phase
            dphase = (shift_phase - phase) % 1.0
            shift_time = dphase / freq
        else:
            prof_start_phase = phase

        def get_period(mjd):
            return 1.0 / polycos.get_phs_and_freq(int(mjd),
                                                  mjd - int(mjd))[1]
    else:
        print("Using constant period: %f" % options.period)
        if shift_phase != 0.0:
            shift_time = shift_phase * options.period

        def get_period(mjd):
            return options.period

    if not options.on_pulse_regions:
        # the reference crashed here (set_onoff_pulse_regions(None));
        # require the flag explicitly for the constant-period path
        print("On-pulse regions (-r) are required when using a constant "
              "period.", file=sys.stderr)
        return 1
    print("On-pulse regions will be set to: %s" %
          ",".join("%s:%s" % t for t in options.on_pulse_regions))
    print("Boxcar widths to be used: %s" %
          ", ".join("%s" % w for w in options.widths))
    print("Single-pulse SNR threshold: %s" % options.threshold)

    good_pulses, snrs, widths, notes, numpulses, nummasked = search_pulses(
        timeseries, get_period, options.on_pulse_regions, options.widths,
        options.threshold, options.no_toss, shift_time)

    print_report(good_pulses, numpulses, nummasked, snrs=snrs, notes=notes,
                 quiet=options.quiet)
    if options.create_output_files and good_pulses:
        if options.create_text_files:
            print("Writing pulse text files...")
            for pulse in good_pulses:
                pulse.write_to_file()
        if options.create_plot_files:
            print("Creating pulse plots...")
            for pulse, wid in zip(good_pulses, widths):
                if arrays is not None:
                    arrays["pulse%d" % pulse.number] = pulse_plot_profile(
                        pulse, smoothfactor=wid)
                    continue
                use_headless_backend_if_needed(outfile=True)
                pulse.plot(os.path.split(timeseries.basefn)[1], 1,
                           smoothfactor=wid, shownotes=True, decorate=True)
        if options.create_joydiv_plot:
            print("Making JoyDiv plot...")
            joy_division_plot(good_pulses, timeseries, options.downfactor,
                              options.heightstretch, arrays=arrays)

    if polycos is not None and options.write_toas and good_pulses:
        print("Generating TOAs. Please wait...")
        print("TOA threshold:", options.toa_threshold)
        print("Min number of pulses for a TOA:", options.min_pulses)
        print("Profile template used:", options.template)
        template = np.loadtxt(options.template, usecols=(1,))
        generate_toas(good_pulses, polycos, template, timeseries,
                      prof_start_phase, options.toa_threshold,
                      options.min_pulses, options.write_toa_files,
                      options.debug, arrays=arrays)
    if arrays:
        save_arrays(options.outfile, **arrays)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
