"""Sift per-DM acceleration-search candidates into a ``.accelcands`` list:
the survey's sift stage.

Port of ``pypulsar_tpu/cli/sift.py``. Input is a set of per-DM-trial
``*_ACCEL_*.cand`` files (written by the sweep stage's accel handoff) with
their ``.inf`` sidecars. Candidates are clustered across DM trials by
fundamental frequency (within a tolerance scaled from their ``rerr``);
each cluster seen at ``--min-hits`` trials or more keeps its best-sigma
member as the headline candidate, with the per-DM hit list attached, and
the list is written in PRESTO's text grammar
(:func:`pypulsar_tpu_torch.io.accelcands.write_candlist`).

``--fold`` folds the sifted list off the ``.dat`` series beside the
``.cand`` inputs (:func:`pypulsar_tpu_torch.parallel.foldpipe.fold_pipeline`)
on ``--device`` (default ``cuda``).

Run as ``python -m pypulsar_tpu_torch.cli.sift *_ACCEL_*.cand -o X.accelcands``.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from typing import Dict, List

import numpy as np

from pypulsar_tpu_torch.io.accelcands import Candidate, write_candlist
from pypulsar_tpu_torch.io.infodata import InfoData
from pypulsar_tpu_torch.io.prestocand import FOURIERPROPS_DTYPE, read_rzwcands

_DM_RE = re.compile(r"DM(\d+(?:\.\d+)?)")

#: flags of the reference's sift stage that the port does not take yet,
#: with the ROADMAP.md item that brings each
NOT_PORTED = {
    "journal": ("--journal", "Queue 1 S1 (checkpoint/resume)"),
    "known_sources": ("--known-sources",
                      "Queue 1 S13 (the candidate store's known-source "
                      "matcher)"),
}


def infer_dm(path: str, inf) -> float:
    """DM of a per-trial file: the .inf DM field when present, else the
    DM<value> token in the filename (the sweep CLI's naming)."""
    dm = getattr(inf, "DM", None)
    if dm is not None:
        return float(dm)
    m = _DM_RE.search(os.path.basename(path))
    if m:
        return float(m.group(1))
    raise ValueError(f"cannot determine the DM of {path}")


def collect(candfns: List[str]):
    """[(candfn, dm, T, cands)] for every readable candidate file. A
    ``.cand`` that fails its integrity check (size not a whole number of
    records, or a count that disagrees with its ``.txtcand`` twin) is
    skipped with a warning, never read short."""
    from pypulsar_tpu_torch.resilience.journal import candfile_complete

    out = []
    for fn in sorted(candfns):
        base = fn.split("_ACCEL_")[0]
        inffn = base + ".inf"
        if not os.path.exists(inffn):
            print(f"# skipping {fn}: no {inffn}", file=sys.stderr)
            continue
        txtfn = fn[:-5] + ".txtcand" if fn.endswith(".cand") else None
        if txtfn is not None and not os.path.exists(txtfn):
            txtfn = None
        if os.path.exists(fn):
            rec_bytes = FOURIERPROPS_DTYPE.itemsize
            ok = (candfile_complete(fn, txtfn) if txtfn is not None
                  else os.path.getsize(fn) % rec_bytes == 0)
            if not ok:
                print(f"# skipping {fn}: fails integrity validation "
                      f"(truncated .cand? re-run its search)",
                      file=sys.stderr)
                continue
        try:
            inf = InfoData(inffn)
            T = float(inf.dt) * int(inf.N)
            cands = read_rzwcands(fn)
            dm = infer_dm(fn, inf)
        except (OSError, ValueError, KeyError) as e:
            print(f"# skipping {fn}: {type(e).__name__}: {e}",
                  file=sys.stderr)
            continue
        out.append((fn, dm, T, cands))
    return out


def _numharm_of(rzw) -> int:
    """Harmonic count of a candidate record. The fourierprops struct has
    no numharm slot; the accel writer stores it in ``locpow``. A genuine
    PRESTO ``.cand`` holds a real local power there, so only small
    near-integer values decode as harmonic counts; anything else is 1."""
    lp = float(getattr(rzw, "locpow", 1.0))
    if 1.0 - 1e-3 <= lp <= 32.0 and abs(lp - round(lp)) < 1e-3:
        return int(round(lp))
    return 1


def sift(candfiles, min_sigma: float = 4.0, min_hits: int = 2,
         freq_tol_bins: float = 1.5) -> List[Candidate]:
    """Cluster candidates across DM trials by fundamental frequency."""
    clusters: List[Dict] = []  # {freq, members: [(dm, rzw, fn, idx, T)]}
    for fn, dm, T, cands in candfiles:
        for idx, c in enumerate(cands):
            if c.sig < min_sigma:
                continue
            freq = c.r / T
            tol = max(freq_tol_bins, 3.0 * c.rerr) / T
            for cl in clusters:
                if abs(cl["freq"] - freq) < tol:
                    cl["members"].append((dm, c, fn, idx, T))
                    break
            else:
                clusters.append(
                    dict(freq=freq, members=[(dm, c, fn, idx, T)]))

    out: List[Candidate] = []
    for cl in clusters:
        if len(cl["members"]) < min_hits:
            continue
        best = max(cl["members"], key=lambda m: m[1].sig)
        dm, rzw, fn, idx, T = best
        nh = _numharm_of(rzw)
        cand = Candidate(
            accelfile=os.path.basename(fn), candnum=idx + 1, dm=dm,
            snr=np.sqrt(max(2.0 * rzw.pow - 2.0 * nh, 0.0)),
            sigma=rzw.sig, numharm=nh, ipow=rzw.pow, cpow=rzw.pow,
            period=1.0 / (rzw.r / T), r=rzw.r, z=rzw.z,
        )
        for mdm, mc, _, _, _ in sorted(cl["members"], key=lambda m: m[0]):
            # each hit's SNR from its own harmonic count
            mnh = _numharm_of(mc)
            cand.add_dmhit(mdm, np.sqrt(max(2.0 * mc.pow - 2.0 * mnh, 0.0)),
                           sigma=mc.sig)
        out.append(cand)
    out.sort(key=lambda c: -c.sigma)
    return out


def build_parser():
    p = argparse.ArgumentParser(
        prog="sift",
        description="Cluster per-DM accelsearch .cand files into a sifted "
                    ".accelcands list")
    p.add_argument("candfiles", nargs="+", help="*_ACCEL_*.cand files")
    p.add_argument("-o", "--outfile", default=None,
                   help="output .accelcands path (default: stdout)")
    p.add_argument("-s", "--min-sigma", type=float, default=4.0,
                   help="per-trial significance floor (default 4)")
    p.add_argument("--min-hits", type=int, default=2,
                   help="min DM trials a cluster must appear in (default 2)")
    p.add_argument("--min-dm", type=float, default=None,
                   help="drop clusters whose best DM is below this")
    p.add_argument("--fold", action="store_true",
                   help="fold the sifted list into .pfd archives in one "
                        "batched pass off the per-DM .dat files beside the "
                        "input .cand files")
    p.add_argument("--fold-nbins", type=int, default=64,
                   help="with --fold: phase bins per profile (default 64)")
    p.add_argument("--fold-npart", type=int, default=32,
                   help="with --fold: time partitions (default 32)")
    p.add_argument("--fold-outbase", default=None,
                   help="with --fold: archive basename (default: the "
                        "-o outfile sans extension)")
    p.add_argument("--device", default="cuda",
                   help="with --fold: torch device (default cuda; cpu runs "
                        "the fold kernel's plain PyTorch version)")
    not_ported = "not ported yet: ROADMAP.md "
    p.add_argument("--journal", default=None,
                   help=not_ported + NOT_PORTED["journal"][1])
    p.add_argument("--known-sources", default=None,
                   help=not_ported + NOT_PORTED["known_sources"][1])
    return p


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    for dest, (flag, item) in NOT_PORTED.items():
        if getattr(args, dest):
            ap.error(f"{flag} is not ported yet (ROADMAP.md {item})")
    if args.fold and not args.outfile:
        ap.error("--fold requires -o/--outfile: the fold reads the written "
                 ".accelcands, so reruns fold identical candidates")
    files = collect(args.candfiles)
    cands = sift(files, min_sigma=args.min_sigma, min_hits=args.min_hits)
    if args.min_dm is not None:
        cands = [c for c in cands if c.dm >= args.min_dm]
    write_candlist(cands, args.outfile)
    if args.outfile:
        print(f"# {len(cands)} sifted candidates -> {args.outfile}",
              file=sys.stderr)
    if args.fold and cands:
        return _fold_sifted(args, files)
    return 0


def _fold_sifted(args, files) -> int:
    """--fold: batch-fold the written ``.accelcands`` off the per-DM
    ``.dat`` series beside the input ``.cand`` files."""
    from pypulsar_tpu_torch.io.accelcands import parse_candlist
    from pypulsar_tpu_torch.parallel.foldpipe import (
        cands_from_accelcands,
        fold_pipeline,
        print_fold_results,
    )

    cands = parse_candlist(args.outfile)
    if not cands:
        return 0
    # key by the DM{:.2f} string, not the float: the candidate DM is
    # parsed back from %.2f text, and about one grid DM in five does not
    # round-trip to the exact .inf float
    dat_by_dm = {f"{dm:.2f}": fn.split("_ACCEL_")[0] + ".dat"
                 for fn, dm, _T, _c in files}
    missing = sorted({f"DM{c.dm:.2f}" for c in cands
                      if not os.path.exists(
                          dat_by_dm.get(f"{c.dm:.2f}", ""))})
    if missing:
        print(f"# --fold: no .dat series for {', '.join(missing)} next "
              f"to the .cand inputs; re-run the sweep with --write-dats, "
              f"or use 'foldbatch <raw.fil> --cands' to stream from the "
              f"raw file", file=sys.stderr)
        return 1
    outbase = args.fold_outbase or os.path.splitext(args.outfile)[0]
    summary = fold_pipeline(
        cands_from_accelcands(cands), outbase, source="dats",
        dat_for_dm=lambda dm: dat_by_dm[f"{dm:.2f}"],
        nbins=args.fold_nbins, npart=args.fold_npart,
        skip_existing=True, device=args.device, verbose=True)
    print_fold_results(summary)
    print(f"# folded {summary['n_folded']} sifted candidates "
          f"({summary['n_failed']} failed)", file=sys.stderr)
    return 0 if summary["n_failed"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
