"""P-Pdot diagram plotter with derived-parameter lines and markers.

Behavioral spec: reference ``bin/pyppdot.py`` — the pulsars.txt column
format with '*' nulls, '<' pdot upper limits, and INCLUDE directives
(:656-744); derived B-field/age/Edot line families (L&K eqs. 3.6, 3.12,
3.15; :128-202); marker classes for binaries/RRATs/magnetars/SNRs
(:25-33, :66-78); and the scatter plot with log axes (:205-...).  The
interactive picker UI is reduced to a ``--info`` name lookup plus the
marker toggles as flags; ``-o`` renders headless.

A small bundled sample catalog lives at ``lib/pulsars/pulsars.txt``
(textbook parameters); point ``-f`` at a full ATNF-derived catalog in the
same format for production use.

Port of ``pypulsar_tpu/cli/pyppdot.py`` (host numpy). The bundled
catalogs are the port's own copy, ``pypulsar_tpu_torch/lib/pulsars/``.
``-o FILE.npz`` writes the plot's arrays (each plottable pulsar's P,
Pdot, name and marker classes, the highlighted pulsars, the line
families) instead of drawing it, and imports no matplotlib; any other
``-o`` is drawn and saved.

Run as ``python -m pypulsar_tpu_torch.cli pyppdot --def-lines -o ppdot.npz``.
"""

from __future__ import annotations

import argparse
import os.path
from typing import List, Optional

import numpy as np

from pypulsar_tpu_torch.cli import (save_arrays, show_or_save,
                                    use_headless_backend_if_needed)
from pypulsar_tpu_torch.core import psrmath

MARKER_OPTIONS = {"facecolor": "none", "zorder": 1, "alpha": 0.8, "lw": 4,
                  "s": 200}
BINARY_MARKER = {"marker": "o", "edgecolor": "g", "label": "binary"}
RRAT_MARKER = {"marker": "s", "edgecolor": "c", "label": "rrat"}
MAGNETAR_MARKER = {"marker": "^", "facecolor": "#E066FF",
                   "edgecolor": "#E066FF", "label": "magnetar"}
SNR_MARKER = {"marker": (4, 1, 0), "edgecolor": "y", "label": "snr"}

DEFAULT_CATALOG = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                               "lib", "pulsars", "pulsars.txt")


class Pulsar:
    """One catalog row (reference pyppdot.py:39-116)."""

    def __init__(self, name, p, pdot, raj, decj, dm, binarytype, assoc,
                 psrtype, pdot_uplim=False):
        self.name = name
        self.p = p
        self.pdot = pdot
        self.pdot_uplim = pdot_uplim
        self.raj = raj
        self.decj = decj
        self.dm = dm
        self.binarytype = binarytype
        self.assoc = assoc
        self.psrtype = psrtype
        typ = (psrtype or "").lower() if psrtype not in (None, "No info") \
            else ""
        asc = (assoc or "").lower() if assoc not in (None, "No info") else ""
        self.rrat = "rrat" in typ
        self.magnetar = "axp" in typ or "sgr" in typ
        # SGR/AXP split looks at the association because the catalogs tag
        # both flavors with type 'AXP' and name SGRs in the association
        # column (reference pyppdot.py:70-75 and lib/pulsars/magnetars.txt)
        self.sgr = self.magnetar and "sgr" in asc
        self.axp = self.magnetar and "sgr" not in asc
        self.snr = "snr" in asc
        self.binary = binarytype not in (None, "No info")

    def get_computed_params(self):
        return params_from_ppdot(self.p, self.pdot)

    def get_info(self, extended=False):
        bfield, age, edot = self.get_computed_params()
        strings = ["PSR %s" % self.name,
                   "\tRA (J2000): %s, Dec (J2000): %s"
                   % (self.raj, self.decj)]
        strings.append("\tPeriod (s): %s"
                       % ("%f" % self.p if self.p is not None
                          else "Not Measured"))
        strings[-1] += ", P-dot (s/s): %s" % (
            "%0.3g" % self.pdot if self.pdot is not None
            else "Not Measured")
        if bfield is not None:
            unit, val = units_age(age)
            strings.extend(["\tB-field (G): %0.3g" % bfield,
                            "\tAge (%s): %0.3g" % (unit, val),
                            "\tE-dot (erg/s): %0.3g" % edot])
        if extended:
            strings.extend(["\tBinary type: %s" % self.binarytype,
                            "\tAssociations: %s" % self.assoc,
                            "\tPulsar type: %s" % self.psrtype])
        return "\n".join(strings)

    __str__ = get_info


def units_age(age):
    prefix = ["", "k", "M", "G"]
    m = min(int(np.log10(age) / 3), len(prefix) - 1)
    return ("%syr" % prefix[m], age / 10 ** (m * 3))


# Derived-parameter line families (L&K eqs. 3.6, 3.12, 3.15).
def pdot_from_edot(p, edot):
    return 2.5316455696202532e-47 * edot * np.asarray(p) ** 3


def p_from_edot(pdot, edot):
    return (pdot / (2.5316455696202532e-47 * edot)) ** (1 / 3.0)


def pdot_from_bfield(p, bfield):
    return 1e-39 * bfield ** 2 / np.asarray(p)


def p_from_bfield(pdot, bfield):
    return 1e-39 * bfield ** 2 / pdot


def pdot_from_age(p, age):
    return np.asarray(p) / age / (2.0 * psrmath.SECPERJULYR)


def p_from_age(pdot, age):
    return pdot * age * (2.0 * psrmath.SECPERJULYR)


def params_from_ppdot(p, pdot):
    """(B-field G, age yr, Edot erg/s) or (None,)*3 when either input is
    missing."""
    if p is None or pdot is None or pdot <= 0:
        return (None, None, None)
    f, fdot = psrmath.p_to_f(p, pdot)
    return (psrmath.pulsar_B(p, pdot),
            psrmath.pulsar_age(f, fdot) / psrmath.SECPERJULYR,
            psrmath.pulsar_edot(f, fdot))


def parse_pulsar_file(psrfn: str = DEFAULT_CATALOG,
                      indent: str = "") -> List[Pulsar]:
    """Parse the pulsars.txt format (reference pyppdot.py:656-744):
    columns name P Pdot RAJ DECJ DM binary assoc type with '*' nulls,
    '<' pdot upper limits, '#' comments, and INCLUDE directives."""
    print(indent + "Parsing file (%s)" % psrfn)
    pulsars: List[Pulsar] = []
    nonplottable = 0
    if not os.path.exists(psrfn):
        print(indent + "    File not found: %s" % psrfn)
        return pulsars
    with open(psrfn) as psrfile:
        for line in psrfile:
            line = line.partition("#")[0].strip()
            if not line:
                continue
            sl = line.split()
            if sl[0].upper() == "INCLUDE":
                dirname = os.path.split(psrfn)[0]
                for fn in sl[1:]:
                    pulsars += parse_pulsar_file(
                        os.path.join(dirname, fn), indent=indent + "    ")
                continue
            name = sl[0]
            if sl[1] == "*" or sl[2] == "*":
                nonplottable += 1
                continue
            p = float(sl[1])
            pdot_uplim = sl[2].startswith("<")
            pdot = float(sl[2].lstrip("<"))

            def col(i, null=None, conv=str):
                if len(sl) <= i or sl[i] == "*":
                    return null
                return conv(sl[i])

            raj = col(3)
            decj = col(4)
            dm = col(5, conv=float)
            binarytype = col(6, null=None) if len(sl) > 6 else "No info"
            assoc = col(7, null=None) if len(sl) > 7 else "No info"
            psrtype = (col(8, null="Radio") if len(sl) > 8 else "No info")
            pulsars.append(Pulsar(name, p, pdot, raj, decj, dm, binarytype,
                                  assoc, psrtype, pdot_uplim=pdot_uplim))
    print(indent + "    Number of pulsars that cannot be plotted "
          "(no P or Pdot): %d" % nonplottable)
    return pulsars


def plot_arrays(pulsars, highlight=(), edots=(), ages=(), bsurfs=()):
    """The arrays :func:`plot_data` draws: each plottable pulsar's
    ``p``, ``pdot``, ``names`` and marker classes (``binary``, ``rrat``,
    ``magnetar``, ``snr``), the highlighted pulsars' ``highlight_p``,
    ``highlight_pdot`` and ``highlight_names``, and over ``pgrid`` one
    row a value of each line family (``edot_lines`` at ``edots``,
    ``age_lines`` at ``ages``, ``bsurf_lines`` at ``bsurfs``)."""
    plottable = [x for x in pulsars
                 if x.p is not None and x.pdot is not None and x.pdot > 0]
    hl = [x for x in highlight if x.p is not None and x.pdot is not None]
    pgrid = np.logspace(-3.5, 1.5, 200)

    def lines(fn, values):
        return np.array([fn(pgrid, v) for v in values]).reshape(
            len(values), pgrid.size)

    return dict(
        p=np.array([x.p for x in plottable], dtype=np.float64),
        pdot=np.array([x.pdot for x in plottable], dtype=np.float64),
        names=np.array([x.name for x in plottable], dtype=str),
        **{attr: np.array([bool(getattr(x, attr)) for x in plottable],
                          dtype=bool)
           for attr in ("binary", "rrat", "magnetar", "snr")},
        highlight_p=np.array([x.p for x in hl], dtype=np.float64),
        highlight_pdot=np.array([x.pdot for x in hl], dtype=np.float64),
        highlight_names=np.array([x.name for x in hl], dtype=str),
        pgrid=pgrid,
        edots=np.asarray(edots, dtype=np.float64),
        edot_lines=lines(pdot_from_edot, edots),
        ages=np.asarray(ages, dtype=np.float64),
        age_lines=lines(pdot_from_age, ages),
        bsurfs=np.asarray(bsurfs, dtype=np.float64),
        bsurf_lines=lines(pdot_from_bfield, bsurfs))


def plot_data(pulsars, highlight=(), binaries=False, rrats=False,
              magnetars=False, snrs=False, edots=(), ages=(), bsurfs=(),
              size=15):
    import matplotlib.pyplot as plt

    plottable = [x for x in pulsars
                 if x.p is not None and x.pdot is not None and x.pdot > 0]
    periods = np.array([x.p for x in plottable])
    pdots = np.array([x.pdot for x in plottable])

    ax = plt.axes()
    ax.scatter(periods, pdots, c="k", s=size, label="_nolegend_",
               zorder=2)
    for psr in highlight:
        if psr.p is not None and psr.pdot is not None:
            ax.scatter([psr.p], [psr.pdot], c="r", marker="*", s=150,
                       zorder=3, label=psr.name)
    for flag, attr, marker in ((binaries, "binary", BINARY_MARKER),
                               (rrats, "rrat", RRAT_MARKER),
                               (magnetars, "magnetar", MAGNETAR_MARKER),
                               (snrs, "snr", SNR_MARKER)):
        if flag:
            sel = [x for x in plottable if getattr(x, attr)]
            if sel:
                opts = dict(MARKER_OPTIONS)
                opts.update(marker)
                ax.scatter([x.p for x in sel], [x.pdot for x in sel],
                           **opts)

    pgrid = np.logspace(-3.5, 1.5, 200)
    for edot in edots:
        ax.plot(pgrid, pdot_from_edot(pgrid, edot), "k--", lw=0.5)
        ax.text(pgrid[-1], pdot_from_edot(pgrid[-1], edot),
                "%.0e erg/s" % edot, size="xx-small", ha="right")
    for age in ages:
        ax.plot(pgrid, pdot_from_age(pgrid, age), "k:", lw=0.5)
        ax.text(pgrid[-1], pdot_from_age(pgrid[-1], age),
                "%.0e yr" % age, size="xx-small", ha="right")
    for bsurf in bsurfs:
        ax.plot(pgrid, pdot_from_bfield(pgrid, bsurf), "k-.", lw=0.5)
        ax.text(pgrid[-1], pdot_from_bfield(pgrid[-1], bsurf),
                "%.0e G" % bsurf, size="xx-small", ha="right")

    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlim(1e-3, 30)
    ax.set_ylim(1e-22, 1e-8)
    ax.set_xlabel("Period (s)")
    ax.set_ylabel("Period derivative (s/s)")
    if binaries or rrats or magnetars or snrs or highlight:
        ax.legend(loc="lower right", fontsize="x-small")
    return ax


def build_parser():
    parser = argparse.ArgumentParser(
        prog="pyppdot.py",
        description="P-Pdot diagram plotter (headless-capable).")
    parser.add_argument("-f", "--file", dest="files", action="append",
                        default=[],
                        help="pulsars.txt-format catalog file; repeatable "
                             "(default: the bundled sample catalog)")
    parser.add_argument("--highlight", action="append", default=[],
                        help="Catalog file of pulsars to star-highlight")
    parser.add_argument("-e", "--edot", dest="edots", type=float,
                        action="append", default=[],
                        help="Constant E-dot line (erg/s); repeatable")
    parser.add_argument("-a", "--age", dest="ages", type=float,
                        action="append", default=[],
                        help="Constant age line (yr); repeatable")
    parser.add_argument("-b", "--bsurf", dest="bsurfs", type=float,
                        action="append", default=[],
                        help="Constant surface B-field line (G); "
                             "repeatable")
    parser.add_argument("--def-lines", action="store_true",
                        help="Plot default E-dot/B/age line families")
    parser.add_argument("--binaries", action="store_true")
    parser.add_argument("--rrats", action="store_true")
    parser.add_argument("--magnetars", action="store_true")
    parser.add_argument("--snrs", action="store_true")
    parser.add_argument("--info", default=None,
                        help="Print the catalog entry for this pulsar "
                             "name and exit")
    parser.add_argument("-i", "--interactive", action="store_true",
                        help="click a point to print that pulsar's "
                             "parameters (the reference's picker UI)")
    parser.add_argument("-o", "--outfile", default=None,
                        help="Write plot to file instead of showing")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.def_lines:
        args.edots += [1e30, 1e33, 1e36]
        args.bsurfs += [1e10, 1e12, 1e14]
        args.ages += [1e3, 1e6, 1e9]

    pulsars: List[Pulsar] = []
    for fn in (args.files or [DEFAULT_CATALOG]):
        pulsars += parse_pulsar_file(fn)
    highlight: List[Pulsar] = []
    for fn in args.highlight:
        highlight += parse_pulsar_file(fn)

    # de-duplicate by name; highlighted pulsars win
    psr_dict = {psr.name: psr for psr in pulsars}
    for hl in highlight:
        psr_dict.pop(hl.name, None)
    pulsars = list(psr_dict.values())

    if args.info is not None:
        matches = [p for p in pulsars + highlight if p.name == args.info]
        if not matches:
            print("No pulsar named %s in the catalog(s)." % args.info)
            return 1
        print(matches[0].get_info(extended=True))
        return 0

    if not pulsars and not highlight:
        print("No plottable pulsars.")
        return 1
    if save_arrays(args.outfile, **plot_arrays(
            pulsars, highlight, edots=args.edots, ages=args.ages,
            bsurfs=args.bsurfs)):
        return 0
    use_headless_backend_if_needed(args.outfile)
    import matplotlib.pyplot as plt

    fig = plt.figure()
    try:
        fig.canvas.manager.set_window_title("P-Pdot")
    except AttributeError:
        pass
    plot_data(pulsars, highlight, binaries=args.binaries, rrats=args.rrats,
              magnetars=args.magnetars, snrs=args.snrs, edots=args.edots,
              ages=args.ages, bsurfs=args.bsurfs)
    if args.interactive:
        # axes are log-log: event coords arrive in data units
        make_picker(pulsars + highlight).connect(
            fig, transform=lambda x, y: (np.log10(x), np.log10(y)))
    show_or_save(args.outfile)
    return 0


def make_picker(pulsars):
    """Nearest-pulsar click picker over the P-Pdot plane (the reference's
    interactive UI, bin/pyppdot.py:459-620). Distances in log space — the
    plot's axes; pulsars without a plottable pdot are excluded."""
    from pypulsar_tpu_torch.utils.interactive import NearestPointPicker

    plottable = [p for p in pulsars
                 if p.p and p.pdot and p.p > 0 and p.pdot > 0]
    return NearestPointPicker(
        [np.log10(p.p) for p in plottable],
        [np.log10(p.pdot) for p in plottable],
        [p.name for p in plottable],
        callback=lambda i, name: print(plottable[i].get_info(extended=True)))


if __name__ == "__main__":
    raise SystemExit(main())
