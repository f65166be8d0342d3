"""``python -m pypulsar_tpu_torch.cli tune``: inspect, build and clear the
auto-tuning cache.

Port of ``pypulsar_tpu/cli/tune.py``. One mode is required:

- ``--show``: every cache entry (key, tuned config, provenance);
- ``--search``: the bounded coordinate-descent search of each
  ``--stage`` (default ``sweep,accel``, the stages with a measure
  builder) at an explicit geometry (``--nchan``, ``--nsamp``, ``--nbits``,
  ``--zmax``, or ``--file OBS`` for the first three) on ``--device``
  (default ``cuda``), each winner stored under the key the stage's own
  consult will look up (``cli.sweep --tune cache`` on that file and
  device);
- ``--clear``: drop every entry, or those of ``--stage``.

``--cache PATH`` names the file (default
``~/.cache/pypulsar_tpu_torch/tune.json``); ``--trials`` bounds each
stage's search (default 20); ``--json`` prints machine-readable output.
"""

from __future__ import annotations

import argparse
import json

from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.resilience import faultinject


def build_parser():
    p = argparse.ArgumentParser(
        prog="tune",
        description="Auto-tuning cache: show, search or clear it.")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--show", action="store_true",
                      help="render the cache entries and exit")
    mode.add_argument("--search", action="store_true",
                      help="run the bounded search of --stage at the given "
                           "geometry and store the winners")
    mode.add_argument("--clear", action="store_true",
                      help="drop cache entries (all, or one --stage's)")
    p.add_argument("--stage", default=None,
                   help="comma list of stages (--search default: "
                        "sweep,accel; --clear default: every stage)")
    p.add_argument("--cache", default=None, metavar="PATH",
                   help="cache file (default "
                        "~/.cache/pypulsar_tpu_torch/tune.json)")
    p.add_argument("--device", default="cuda",
                   help="torch device the search measures on and the keys "
                        "name (default cuda; cpu runs the plain versions)")
    g = p.add_argument_group("search geometry")
    g.add_argument("--file", default=None, metavar="OBS",
                   help="derive --nchan/--nsamp/--nbits from this "
                        "filterbank or PSRFITS header")
    g.add_argument("--nchan", type=int, default=64)
    g.add_argument("--nsamp", type=int, default=1 << 16,
                   help="series length in samples (bucketed to the next "
                        "power of two in the key)")
    g.add_argument("--nbits", type=int, default=32,
                   help="input sample width the sweep key carries")
    g.add_argument("--zmax", type=int, default=200,
                   help="accel-stage zmax the entry keys on")
    g.add_argument("--numharm", type=int, default=2, choices=(1, 2, 4, 8))
    g.add_argument("--dm-count", type=int, default=32,
                   help="DM trials the sweep measure dedisperses")
    g.add_argument("--nspec", type=int, default=16,
                   help="spectra the accel measure preps and searches")
    g.add_argument("--engine", default=None,
                   help="sweep engine the entry keys on (default: the "
                        "resolved 'auto' engine)")
    g.add_argument("--trials", type=int, default=None,
                   help="trial budget per stage (default 20)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    telemetry.add_telemetry_flag(
        p, what="tune.trials counters, tune.winner events")
    faultinject.add_fault_flag(p)
    return p


def _geometry(args, ap):
    """(nchan, nsamp, dtype) of the keys: the fields ``cli.sweep``'s
    consult derives from its reader, so a warmed entry is the one the run
    hits."""
    if not args.file:
        return args.nchan, args.nsamp, f"nbits{args.nbits}"
    from pypulsar_tpu_torch.cli import open_reader
    from pypulsar_tpu_torch.parallel.staged import ReaderSource

    try:
        with open_reader(args.file) as reader:
            src = ReaderSource(reader)
            return (len(src.frequencies), int(src.nsamples) or args.nsamp,
                    f"nbits{int(getattr(reader, 'nbits', 32) or 32)}")
    except Exception as e:  # noqa: BLE001 - argparse-style exit
        ap.error(f"--file {args.file}: {type(e).__name__}: {e}")


def _show(cache, as_json: bool) -> int:
    entries = cache.entries()
    if as_json:
        print(json.dumps({"path": cache.path, "entries": entries},
                         indent=1, sort_keys=True))
        return 0
    print(f"# tuning cache: {cache.path} ({len(entries)} entries)")
    for key in sorted(entries):
        ent = entries[key]
        meta = ent.get("meta", {})
        cfg = " ".join(f"{k}={v}"
                       for k, v in sorted(ent.get("config", {}).items()))
        extra = ""
        if meta.get("baseline_s") and meta.get("best_s"):
            extra = (f"  {meta['baseline_s']:.4f}s -> "
                     f"{meta['best_s']:.4f}s ({meta.get('speedup', 0.0):.2f}x, "
                     f"{meta.get('n_trials', 0)} trials)")
        print(f"#   {key}\n#     {cfg or '(defaults won)'}{extra}")
    return 0


def main(argv=None) -> int:
    from pypulsar_tpu_torch.core.device import resolve_device
    from pypulsar_tpu_torch.parallel.sweep import resolve_engine
    from pypulsar_tpu_torch.tune import TuneCache, autotune, make_key
    from pypulsar_tpu_torch.tune.search import DEFAULT_TRIALS
    from pypulsar_tpu_torch.tune.stages import MEASURED_STAGES

    ap = build_parser()
    args = ap.parse_args(argv)
    if args.fault_inject:
        faultinject.configure(args.fault_inject)
    cache = TuneCache(args.cache)
    if args.show:
        return _show(cache, args.json)
    stages = [s.strip() for s in (args.stage or "sweep,accel").split(",")
              if s.strip()]
    if args.clear:
        for stage in (stages if args.stage else [None]):
            n = cache.clear(stage)
            print(f"# cleared {n} entr{'y' if n == 1 else 'ies'}"
                  f"{f' (stage {stage})' if stage else ''} from "
                  f"{cache.path}")
        return 0
    bad = [s for s in stages if s not in MEASURED_STAGES]
    if bad:
        ap.error(f"no measure builder for stage(s) {', '.join(bad)} "
                 f"(searchable stages: {', '.join(MEASURED_STAGES)})")
    nchan, nsamp, dtype = _geometry(args, ap)
    engine = resolve_engine(args.engine or "auto")
    device = resolve_device(args.device)
    results, searches = {}, {}
    with telemetry.session_from_flag(args.telemetry, tool="tune"):
        for stage in stages:
            sweep = stage == "sweep"
            geometry = dict(nchan=nchan if sweep else None, nsamp=nsamp,
                            dtype=dtype if sweep else None,
                            zmax=None if sweep else args.zmax,
                            engine=engine if sweep else None)
            results[stage] = autotune(
                stage, **geometry, device=device, cache_path=cache.path,
                budget=args.trials or DEFAULT_TRIALS, force_search=True,
                verbose=not args.json, ndm=args.dm_count, nspec=args.nspec,
                numharm=args.numharm)
            key = make_key(stage, **geometry, device=device)
            meta = cache.entries().get(key, {}).get("meta", {})
            searches[stage] = {"key": key, **{
                k: meta.get(k) for k in ("n_trials", "baseline_s", "best_s",
                                         "speedup")}}
            if not args.json:
                cfg = " ".join(f"{k}={v}"
                               for k, v in sorted(results[stage].items()))
                print(f"# tune[{stage}]: winner {cfg or '(defaults)'}")
    if args.json:
        print(json.dumps({"cache": cache.path, "tuned": results,
                          "search": searches}, indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
