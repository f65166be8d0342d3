"""Fold a whole candidate list into ``.pfd`` archives in one batched pass:
the survey's fold stage.

Port of ``pypulsar_tpu/cli/foldbatch.py``. Candidates are grouped by DM;
each group folds off one shared dedispersed series with the CUDA fold
kernel, and the (p, pdot) refinement runs on the device with no refold
(:func:`pypulsar_tpu_torch.parallel.foldpipe.fold_pipeline`).

Series sources (exactly one):

- ``--datbase BASE``: per-DM ``{BASE}_DM{dm:.2f}.dat`` files (the sweep
  stage's ``--write-dats`` artifacts);
- a raw ``.fil`` positional: one streamed pass dedisperses every
  candidate DM through the sweep's chunk kernels;
- a single ``.dat`` positional: every candidate folds that one series
  (its ``.inf`` DM replaces the candidates' own).

``--cands`` takes the sifted ``.accelcands`` grammar or a plain
``period_s dm [pdot]`` table. A summary JSON (refined p/pdot per
candidate) is written atomically beside the archives. ``--device``
defaults to ``cuda`` and refuses to run without a card; ``--device cpu``
runs the fold kernel's plain PyTorch version.

Run as ``python -m pypulsar_tpu_torch.cli.foldbatch --cands X.accelcands
-o X --datbase X``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

#: flags of the reference's fold stage that the port does not take yet,
#: with the ROADMAP.md item that brings each
NOT_PORTED = {
    "journal": ("--journal", "Queue 1 S1 (checkpoint/resume)"),
    "maskfile": ("--mask", "Queue 1 S2 (rfifind masks)"),
    "telemetry": ("--telemetry", "Queue 1 S5 (telemetry)"),
    "fault_inject": ("--fault-inject", "Queue 1 S5 (telemetry)"),
}


def build_parser():
    p = argparse.ArgumentParser(
        prog="foldbatch",
        description="Fold an entire candidate list into PRESTO-format "
                    ".pfd archives in one batched pass on the GPU")
    p.add_argument("infile", nargs="?", default=None,
                   help=".fil to stream, or a single .dat series (omit "
                        "with --datbase)")
    p.add_argument("--cands", required=True, metavar="FILE",
                   help="candidate list: a sifted .accelcands file or a "
                        "'period_s dm [pdot]' table")
    p.add_argument("--datbase", default=None, metavar="BASE",
                   help="fold from {BASE}_DM{dm:.2f}.dat files instead of "
                        "streaming a raw file")
    p.add_argument("-o", "--outbase", default=None,
                   help="output archive basename (default: the candidate "
                        "file sans extension)")
    p.add_argument("-n", "--proflen", type=int, default=64,
                   help="phase bins per profile (default 64)")
    p.add_argument("--npart", type=int, default=32,
                   help="time partitions (default 32)")
    p.add_argument("--batch", type=int, default=32,
                   help="candidate-axis batch cap per device fold "
                        "(default 32; a device OOM halves below it)")
    p.add_argument("--prefetch", type=int, default=1,
                   help="groups prepped ahead of the device folds "
                        "(default 1; 0 = inline, single-threaded)")
    p.add_argument("--no-refine", dest="refine", action="store_false",
                   help="skip the on-device (p, pdot) refinement")
    p.add_argument("--ntrial-p", type=int, default=33,
                   help="period trials in the refinement grid (default 33)")
    p.add_argument("--ntrial-pd", type=int, default=17,
                   help="pdot trials in the refinement grid (default 17; "
                        "1 = period-only)")
    p.add_argument("--max-drift", type=float, default=2.0,
                   help="refinement half-range, whole-observation drift "
                        "cycles (default 2)")
    p.add_argument("--skip-existing", action="store_true",
                   help="skip candidates whose archive already parses "
                        "complete")
    p.add_argument("--summary", default=None, metavar="PATH.json",
                   help="summary JSON path (default "
                        "{outbase}_foldbatch.json)")
    p.add_argument("--downsamp", type=int, default=1,
                   help="stream source: downsample factor (default 1)")
    p.add_argument("-s", "--nsub", type=int, default=64,
                   help="stream source: subbands (default 64)")
    p.add_argument("--group-size", type=int, default=0,
                   help="stream source: stage-1 DM group size (0 = auto)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the fold "
                        "kernel's plain PyTorch version)")
    not_ported = "not ported yet: ROADMAP.md "
    p.add_argument("--journal", default=None,
                   help=not_ported + NOT_PORTED["journal"][1])
    p.add_argument("--mask", dest="maskfile", default=None,
                   help=not_ported + NOT_PORTED["maskfile"][1])
    p.add_argument("--telemetry", default=None,
                   help=not_ported + NOT_PORTED["telemetry"][1])
    p.add_argument("--fault-inject", default=None,
                   help=not_ported + NOT_PORTED["fault_inject"][1])
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    for dest, (flag, item) in NOT_PORTED.items():
        if getattr(args, dest):
            parser.error(f"{flag} is not ported yet (ROADMAP.md {item})")
    if (args.infile is None) == (args.datbase is None):
        parser.error("give exactly one series source: a raw/.dat infile "
                     "OR --datbase")

    from pypulsar_tpu_torch.parallel.foldpipe import (
        FoldCandidate,
        fold_pipeline,
        load_candidates,
        print_fold_results,
    )
    from pypulsar_tpu_torch.resilience.journal import atomic_write_text

    cands = load_candidates(args.cands)
    if not cands:
        print("# no candidates to fold", file=sys.stderr)
        return 0
    outbase = args.outbase or os.path.splitext(args.cands)[0]
    kwargs = dict(
        nbins=args.proflen, npart=args.npart, batch=args.batch,
        refine=args.refine, ntrial_p=args.ntrial_p,
        ntrial_pd=args.ntrial_pd, max_drift=args.max_drift,
        prefetch_depth=args.prefetch, skip_existing=args.skip_existing,
        device=args.device, verbose=True)
    if args.datbase is not None:
        base = args.datbase
        summary = fold_pipeline(
            cands, outbase, source="dats",
            dat_for_dm=lambda dm: f"{base}_DM{dm:.2f}.dat", **kwargs)
    elif args.infile.endswith(".dat"):
        # one series for the whole list, at the DM of its .inf sidecar
        from pypulsar_tpu_torch.io.infodata import InfoData

        inf = InfoData(os.path.splitext(args.infile)[0] + ".inf")
        inf_dm = float(getattr(inf, "DM", 0.0) or 0.0)
        cands = [FoldCandidate(c.period, inf_dm, c.pdot, c.name)
                 for c in cands]
        summary = fold_pipeline(
            cands, outbase, source="dats",
            dat_for_dm=lambda dm: args.infile, **kwargs)
    else:
        from pypulsar_tpu_torch.io.filterbank import FilterbankFile

        with FilterbankFile(args.infile) as reader:
            summary = fold_pipeline(
                cands, outbase, source="stream", reader=reader,
                downsamp=args.downsamp, nsub=args.nsub,
                group_size=args.group_size, **kwargs)

    print_fold_results(summary)
    print(f"# folded {summary['n_folded']} candidates "
          f"({summary['n_skipped']} skipped, {summary['n_failed']} "
          f"failed)", file=sys.stderr)
    summary_path = args.summary or f"{outbase}_foldbatch.json"
    atomic_write_text(summary_path, json.dumps(summary, indent=1))
    print(f"# summary -> {summary_path}", file=sys.stderr)
    return 0 if summary["n_failed"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
