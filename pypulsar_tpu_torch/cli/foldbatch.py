"""Fold a whole candidate list into ``.pfd`` archives in one batched pass:
the survey's fold stage.

Port of ``pypulsar_tpu/cli/foldbatch.py``. Candidates are grouped by DM;
each group folds off one shared dedispersed series with the CUDA fold
kernel, and the (p, pdot) refinement runs on the device with no refold
(:func:`pypulsar_tpu_torch.parallel.foldpipe.fold_pipeline`).

Series sources (exactly one):

- ``--datbase BASE``: per-DM ``{BASE}_DM{dm:.2f}.dat`` files (the sweep
  stage's ``--write-dats`` artifacts);
- a raw ``.fil`` or PSRFITS positional (opened by
  :func:`~pypulsar_tpu_torch.cli.open_reader`): one streamed pass
  dedisperses every candidate DM through the sweep's chunk kernels
  (``--mask`` applies the sweep's rfifind mask to it);
- a single ``.dat`` positional: every candidate folds that one series
  (its ``.inf`` DM replaces the candidates' own).

``--cands`` takes the sifted ``.accelcands`` grammar or a plain
``period_s dm [pdot]`` table. A summary JSON (refined p/pdot per
candidate) is written atomically beside the archives. ``--journal
PATH.jsonl`` keeps a work-unit journal of the archives: a rerun folds only
the candidates whose archive does not validate (size and sha256), and its
summary takes the others' refined (p, pdot) from the journal. ``--device``
defaults to ``cuda`` and refuses to run without a card; ``--device cpu``
runs the fold kernel's plain PyTorch version. ``--telemetry PATH.jsonl``
records the run's trace and ``--fault-inject SPEC`` arms the fault
injector (e.g. ``oom:fold.batch_dispatch`` or
``kill:fold.after_pfd_write:2``).

Run as ``python -m pypulsar_tpu_torch.cli.foldbatch --cands X.accelcands
-o X --datbase X``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.resilience import faultinject


def build_parser():
    p = argparse.ArgumentParser(
        prog="foldbatch",
        description="Fold an entire candidate list into PRESTO-format "
                    ".pfd archives in one batched pass on the GPU")
    p.add_argument("infile", nargs="?", default=None,
                   help=".fil or .fits to stream, or a single .dat series "
                        "(omit with --datbase)")
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
    p.add_argument("--mask", dest="maskfile", default=None,
                   help="stream source: rfifind .mask applied per raw "
                        "block, as the sweep stage applied it (.dat "
                        "series were masked when written)")
    p.add_argument("--journal", default=None, metavar="PATH.jsonl",
                   help="work-unit journal: a rerun folds only the "
                        "candidates whose archives do not validate "
                        "(size and sha256)")
    p.add_argument("--tune", default="cache", choices=("cache", "off"),
                   help="auto-tuning consult of the fold stage's budgets "
                        "(cache, the default; off reads nothing; the fold "
                        "has no search)")
    p.add_argument("--tune-cache", default=None, metavar="PATH",
                   help="tuning cache file (default "
                        "~/.cache/pypulsar_tpu_torch/tune.json)")
    telemetry.add_telemetry_flag(
        p, what="fold spans, group counters, device stats")
    faultinject.add_fault_flag(p)
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if (args.infile is None) == (args.datbase is None):
        parser.error("give exactly one series source: a raw/.dat infile "
                     "OR --datbase")
    if args.maskfile and (args.datbase is not None
                          or args.infile.endswith(".dat")):
        parser.error("--mask applies to the raw-stream source only "
                     "(.dat/--datbase series were masked when written); "
                     "a silently ignored mask would fold a different "
                     "series than asked")
    if args.fault_inject:
        faultinject.configure(args.fault_inject)
    with telemetry.session_from_flag(args.telemetry, tool="foldbatch"):
        return _run(args)


def _run(args) -> int:
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
        journal_path=args.journal, device=args.device, verbose=True,
        tune_mode=args.tune, tune_cache=args.tune_cache)
    if args.datbase is not None:
        base = args.datbase
        summary = fold_pipeline(
            cands, outbase, source="dats", source_id=base,
            dat_for_dm=lambda dm: f"{base}_DM{dm:.2f}.dat", **kwargs)
    elif args.infile.endswith(".dat"):
        # one series for the whole list, at the DM of its .inf sidecar
        from pypulsar_tpu_torch.io.infodata import InfoData

        inf = InfoData(os.path.splitext(args.infile)[0] + ".inf")
        inf_dm = float(getattr(inf, "DM", 0.0) or 0.0)
        cands = [FoldCandidate(c.period, inf_dm, c.pdot, c.name)
                 for c in cands]
        summary = fold_pipeline(
            cands, outbase, source="dats", source_id=args.infile,
            dat_for_dm=lambda dm: args.infile, **kwargs)
    else:
        from pypulsar_tpu_torch.cli import open_reader
        from pypulsar_tpu_torch.io.rfimask import RfifindMask

        rfimask = RfifindMask(args.maskfile) if args.maskfile else None
        with open_reader(args.infile) as reader:
            summary = fold_pipeline(
                cands, outbase, source="stream", reader=reader,
                downsamp=args.downsamp, nsub=args.nsub,
                group_size=args.group_size, rfimask=rfimask, **kwargs)

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
