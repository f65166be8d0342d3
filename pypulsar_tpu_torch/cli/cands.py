"""``cands`` — query the survey's candidate store (a copy of
``pypulsar_tpu/cli/cands.py``, host only).

The read surface of the candidate data plane: point it at a survey
outdir and ask questions the per-obs artifact files cannot answer::

    python -m pypulsar_tpu_torch.cli cands OUTDIR --near 0.1024 40 --top 10
    python -m pypulsar_tpu_torch.cli cands OUTDIR --sift --known-sources cat.txt
    python -m pypulsar_tpu_torch.cli cands OUTDIR --tenant lofar --json

Default mode lists live records ranked by SNR; ``--sift`` runs the
cross-observation candsift (harmonic clustering across epochs +
known-source veto) and lists ranked clusters instead.  ``--compact``
forces a store compaction (queries are identical before and after —
this only trades log bytes for snapshot bytes).
"""

from __future__ import annotations

import argparse
import json

from pypulsar_tpu_torch.candstore import (CandStore, cross_sift, load_catalog,
                                    store_dir)


def build_parser():
    p = argparse.ArgumentParser(
        prog="cands",
        description="query the survey candidate store under OUTDIR")
    p.add_argument("outdir", help="survey output directory "
                                  "(holds _fleet/candstore/)")
    p.add_argument("--near", nargs=2, type=float, default=None,
                   metavar=("P_S", "DM"),
                   help="only candidates near this (period s, DM)")
    p.add_argument("--tol-p", type=float, default=None,
                   help="fractional period tolerance for --near "
                        "(default 1e-3)")
    p.add_argument("--tol-dm", type=float, default=None,
                   help="absolute DM tolerance for --near "
                        "(default 0.5)")
    p.add_argument("--tenant", default=None,
                   help="only candidates published under this tenant")
    p.add_argument("--epoch-range", nargs=2, type=float, default=None,
                   metavar=("MJD_LO", "MJD_HI"),
                   help="only candidates with epoch in [LO, HI]")
    p.add_argument("--top", type=int, default=None, metavar="N",
                   help="at most N results")
    p.add_argument("--json", action="store_true",
                   help="machine-readable JSON to stdout")
    p.add_argument("--sift", action="store_true",
                   help="cross-observation candsift: cluster matching "
                        "records across epochs and rank the clusters")
    p.add_argument("--known-sources", default=None, metavar="FILE",
                   help="catalog for the --sift known-source veto "
                        "(same format as sift --known-sources)")
    p.add_argument("--include-known", action="store_true",
                   help="keep clusters matching known sources in the "
                        "--sift output (default: drop, count them)")
    p.add_argument("--compact", action="store_true",
                   help="compact the store before querying")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return _run(args)


def _run(args):
    store = CandStore(args.outdir)
    if args.compact:
        store.compact()
    near = tuple(args.near) if args.near is not None else None
    erange = (tuple(args.epoch_range)
              if args.epoch_range is not None else None)
    if args.sift:
        records = store.query(near=near, tol_p=args.tol_p,
                              tol_dm=args.tol_dm, tenant=args.tenant,
                              epoch_range=erange)
        known = (load_catalog(args.known_sources)
                 if args.known_sources else None)
        clusters = cross_sift(records, tol_p=args.tol_p,
                              tol_dm=args.tol_dm, known=known)
        n_known = sum(1 for c in clusters if c.get("known_source"))
        if not args.include_known:
            clusters = [c for c in clusters
                        if not c.get("known_source")]
        if args.top is not None:
            clusters = [dict(c) for c in clusters[:args.top]]
        if args.json:
            print(json.dumps(clusters, indent=2, default=_jsonable))
        else:
            _print_clusters(clusters, n_known)
        return 0
    records = store.query(near=near, tol_p=args.tol_p,
                          tol_dm=args.tol_dm, tenant=args.tenant,
                          epoch_range=erange, top=args.top)
    if args.json:
        print(json.dumps(records, indent=2))
    else:
        _print_records(records, store_dir(args.outdir))
    return 0


def _jsonable(v):
    if isinstance(v, set):
        return sorted(v)
    return str(v)


def _fmt(v, spec):
    return format(v, spec) if isinstance(v, (int, float)) else "-"


def _print_records(records, sdir):
    if not records:
        print(f"no candidates (store: {sdir})")
        return
    print(f"# {len(records)} candidate(s)")
    print("# P_s          DM        SNR     z      epoch_MJD   "
          "tenant    obs")
    for r in records:
        print(f"{_fmt(r.get('p_s'), '<12.9f')} "
              f"{_fmt(r.get('dm'), '<9.3f')} "
              f"{_fmt(r.get('snr'), '<7.2f')} "
              f"{_fmt(r.get('z'), '<6.1f')} "
              f"{_fmt(r.get('epoch_mjd'), '<11.4f')} "
              f"{str(r.get('tenant') or '-'):<9s} "
              f"{r.get('obs', '-')}")


def _print_clusters(clusters, n_known):
    if n_known:
        print(f"# {n_known} cluster(s) vetoed as known sources")
    if not clusters:
        print("no clusters")
        return
    print(f"# {len(clusters)} cluster(s), multi-epoch first")
    print("# P_s          DM        best_SNR  hits  epochs  harmonics")
    for c in clusters:
        harm = ",".join(sorted(c.get("harmonics", []))) or "-"
        print(f"{c['p_s']:<12.9f} {c['dm']:<9.3f} "
              f"{_fmt(c.get('best_snr'), '<9.2f')} "
              f"{c['n_hits']:<5d} {c['n_epochs']:<7d} {harm}")


if __name__ == "__main__":
    raise SystemExit(main())
