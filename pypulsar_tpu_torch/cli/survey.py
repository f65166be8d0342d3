"""Run the full search chain over a fleet of observations (``survey``; a
port of ``pypulsar_tpu/cli/survey.py`` for one host).

The one-command form of the per-tool chain (rfifind -> sweep
--accel-search -> sift -> foldbatch -> pfd_snr), orchestrated per
observation by the fleet scheduler (``survey/scheduler.py``):
device-bound stages take an exclusive device lease while host-bound
stages (sift, SNR summaries) overlap on a bounded worker pool; every
completed stage lands in a fingerprinted per-observation manifest, so a
killed fleet resumes with ``--resume`` (validated stages skipped, torn
ones redone) and a persistently failing observation is quarantined while
the rest of the fleet completes.

Usage::

    python -m pypulsar_tpu_torch.cli survey beam*.fil -o out/ --numdms 256 \\
        --accel-zmax 200 --max-host-workers 4 --telemetry-dir out/tlm
    python -m pypulsar_tpu_torch.cli survey --status -o out/   # progress
    python -m pypulsar_tpu_torch.cli survey beam*.fil -o out/ --resume

Artifacts land at ``out/<stem>.*`` with exactly the bytes the serial
chain (``survey.dag.run_observation``) writes; the manifest is
``out/<stem>.survey.jsonl``. ``--device`` (default ``cuda``, which
raises without a card; ``cpu`` runs the plain versions) is where the
device-bound stages run. With ``--telemetry-dir`` each observation
writes one trace plus one fleet trace (``fleet.jsonl``), summarizable
together with ``tlmsum 'out/tlm/*.jsonl'`` and stitchable with
``tlmtrace``.

Refused, each with exit 2 naming its ROADMAP.md item: ``--gang K`` for
K > 1 (item 14; ``--gang auto`` is 1 here), ``--hosts``, ``--host-id``
and ``--host-lease`` (S21, the multi-host plane), ``--daemon`` and its
group, ``--status-port`` and ``--follow`` (S22), ``--fault-chaos``
(item 16).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

#: refused flags: argparse dest -> (flag, the ROADMAP.md item bringing it)
NOT_PORTED = {
    "hosts": ("--hosts", "S21 (the multi-host fleet plane)"),
    "host_id": ("--host-id", "S21 (the multi-host fleet plane)"),
    "host_lease": ("--host-lease", "S21 (the multi-host fleet plane)"),
    "daemon": ("--daemon", "S22 (the streaming daemon)"),
    "watch": ("--watch", "S22 (the streaming daemon)"),
    "daemon_port": ("--daemon-port", "S22 (the streaming daemon)"),
    "tenant": ("--tenant", "S22 (the streaming daemon)"),
    "queue_bound": ("--queue-bound", "S22 (the streaming daemon)"),
    "quiesce": ("--quiesce", "S22 (the streaming daemon)"),
    "daemon_poll": ("--daemon-poll", "S22 (the streaming daemon)"),
    "daemon_idle_exit": ("--daemon-idle-exit", "S22 (the streaming daemon)"),
    "status_port": ("--status-port", "S22 (the live status endpoint)"),
    "follow": ("--follow", "S22 (the live status endpoint)"),
    "fault_chaos": ("--fault-chaos", "Queue 1 item 16 (chaos mode)"),
}
GANG_ITEM = "Queue 1 item 14 (multi-GPU)"


def build_parser():
    from pypulsar_tpu_torch.obs import telemetry
    from pypulsar_tpu_torch.resilience import faultinject

    not_ported = "not ported yet: ROADMAP.md "
    p = argparse.ArgumentParser(
        prog="survey",
        description="Orchestrate the rfifind -> sweep --accel-search -> "
                    "sift -> foldbatch -> pfd_snr chain over a fleet of "
                    "observations (PyTorch/CUDA port).")
    p.add_argument("infile", nargs="*",
                   help=".fil/.fits observations (omit with --status)")
    p.add_argument("-o", "--outdir", required=True,
                   help="directory for all artifacts + manifests; each "
                        "observation's chain is rooted at "
                        "<outdir>/<input stem>")
    p.add_argument("--status", action="store_true",
                   help="print the fleet progress table read from the "
                        "manifests in --outdir and exit")
    p.add_argument("--follow", action="store_true",
                   help=not_ported + NOT_PORTED["follow"][1])
    p.add_argument("--status-port", type=int, default=None, metavar="N",
                   help=not_ported + NOT_PORTED["status_port"][1])
    p.add_argument("--resume", action="store_true",
                   help="replan from the per-observation manifests: "
                        "stages whose recorded artifacts validate "
                        "(size+sha256) are skipped, torn ones redone")
    p.add_argument("--device", default="cuda",
                   help="where the device-bound stages run (default "
                        "cuda, which raises without a card; cpu runs "
                        "the plain versions)")
    p.add_argument("--max-host-workers", type=int, default=2,
                   help="bounded pool for host-bound stages (sift, SNR "
                        "summaries) overlapping device time (default 2)")
    p.add_argument("--devices", type=int, default=1,
                   help="device leases for device-bound stages (default "
                        "1: one device-bound stage at a time); lease i "
                        "runs on card i %% the card count, so more "
                        "leases than cards share a card")
    p.add_argument("--gang", default="auto", metavar="K|auto",
                   help="cards per stage execution: 1 (and 'auto', the "
                        "default) here; K > 1 is " + not_ported
                        + GANG_ITEM)
    p.add_argument("--retries", type=int, default=1,
                   help="bounded per-stage retries (jittered exponential "
                        "backoff) before the observation is quarantined "
                        "(default 1)")
    g = p.add_argument_group("multi-host fleet (" + not_ported + "S21)")
    g.add_argument("--hosts", type=int, default=0, metavar="M",
                   help=not_ported + NOT_PORTED["hosts"][1])
    g.add_argument("--host-id", default=None, metavar="NAME",
                   help=not_ported + NOT_PORTED["host_id"][1])
    g.add_argument("--host-lease", type=float, default=None, metavar="S",
                   help=not_ported + NOT_PORTED["host_lease"][1])
    g = p.add_argument_group("streaming daemon (" + not_ported + "S22)")
    g.add_argument("--daemon", action="store_true",
                   help=not_ported + NOT_PORTED["daemon"][1])
    g.add_argument("--watch", action="append", default=[],
                   metavar="DIR[:TENANT]",
                   help=not_ported + NOT_PORTED["watch"][1])
    g.add_argument("--daemon-port", type=int, default=None, metavar="N",
                   help=not_ported + NOT_PORTED["daemon_port"][1])
    g.add_argument("--tenant", action="append", default=[],
                   metavar="NAME[:PRIO[:RATE[:BURST]]]",
                   help=not_ported + NOT_PORTED["tenant"][1])
    g.add_argument("--queue-bound", type=int, default=None, metavar="N",
                   help=not_ported + NOT_PORTED["queue_bound"][1])
    g.add_argument("--quiesce", type=float, default=None, metavar="S",
                   help=not_ported + NOT_PORTED["quiesce"][1])
    g.add_argument("--daemon-poll", type=float, default=None,
                   metavar="S",
                   help=not_ported + NOT_PORTED["daemon_poll"][1])
    g.add_argument("--daemon-idle-exit", type=float, default=None,
                   metavar="S",
                   help=not_ported + NOT_PORTED["daemon_idle_exit"][1])
    g = p.add_argument_group(
        "fleet health (deadlines, heartbeats, device strikes, admission)")
    g.add_argument("--stall-timeout", type=float, default=None,
                   metavar="S",
                   help="heartbeat-silence bound: a stage recording no "
                        "telemetry activity for S seconds is interrupted "
                        "by the watchdog and retried/quarantined like "
                        "any other failure (default off)")
    g.add_argument("--stage-deadline", type=float, default=None,
                   metavar="S",
                   help="uniform wall-clock deadline applied to EVERY "
                        "stage, overriding the per-stage "
                        "deadline_s/deadline_per_mb declarations "
                        "(default: per-stage declarations only)")
    g.add_argument("--strike-limit", type=int, default=None, metavar="K",
                   help="quarantine a card's device leases out of the "
                        "pool after K out-of-memory/device-fault strikes "
                        "(default 3)")
    g.add_argument("--min-free-mb", type=float, default=None, metavar="MB",
                   help="admission gate: pause launching new stages while "
                        "free disk under --outdir is below MB (in-flight "
                        "stages continue; default 32, 0 disables)")
    g.add_argument("--max-pending", type=float, default=None, metavar="N",
                   help="admission gate: pause launching new stages while "
                        "any ship-ahead *.pending_depth gauge exceeds N "
                        "(default: off)")
    g.add_argument("--max-bad-frac", type=float, default=None,
                   metavar="FRAC",
                   help="ingest data-quality threshold: an observation "
                        "whose input reports more than FRAC of its "
                        "samples missing is quarantined with reason "
                        "'data' instead of running degraded (default "
                        "0.5)")
    p.add_argument("--telemetry-dir", default=None, metavar="DIR",
                   help="write one JSONL trace per observation plus one "
                        "fleet trace (fleet.jsonl) here; summarize "
                        "together with `tlmsum 'DIR/*.jsonl'`")
    # stage knobs (grouped; names mirror the per-tool flags)
    g = p.add_argument_group("mask stage (rfifind)")
    g.add_argument("--no-mask", dest="mask", action="store_false",
                   help="skip the RFI-mask stage (sweep runs unmasked)")
    g.add_argument("--mask-time", type=float, default=1.0,
                   help="rfifind seconds per statistics interval "
                        "(default 1.0)")
    g = p.add_argument_group("sweep stage (flat DM grid + accel handoff)")
    g.add_argument("--lodm", type=float, default=0.0)
    g.add_argument("--dmstep", type=float, default=1.0)
    g.add_argument("--numdms", type=int, default=32)
    g.add_argument("-s", "--nsub", type=int, default=64)
    g.add_argument("--group-size", type=int, default=0)
    g.add_argument("--downsamp", type=int, default=1)
    g.add_argument("--chunk", type=int, default=None)
    g.add_argument("--threshold", type=float, default=6.0)
    g.add_argument("--accel-zmax", type=float, default=200.0)
    g.add_argument("--accel-dz", type=float, default=2.0)
    g.add_argument("--accel-numharm", type=int, default=8,
                   choices=(1, 2, 4, 8))
    g.add_argument("--accel-sigma", type=float, default=2.0)
    g.add_argument("--accel-batch", type=int, default=None,
                   help="spectra per accel dispatch (default: the sweep "
                        "CLI's 32)")
    g.add_argument("--spectral", action="store_true",
                   help="spectral fusion: the sweep stage serves the "
                        "accel search from device-resident fused spectra "
                        "(sweep --spectral) instead of teeing per-DM "
                        ".dats, and the fold stage streams the raw file "
                        "(part of the manifest fingerprint)")
    g = p.add_argument_group("sift stage")
    g.add_argument("--sift-sigma", type=float, default=4.0)
    g.add_argument("--sift-min-hits", type=int, default=2)
    g.add_argument("--sift-min-dm", type=float, default=None)
    g = p.add_argument_group("fold stage")
    g.add_argument("--fold-nbins", type=int, default=64)
    g.add_argument("--fold-npart", type=int, default=32)
    g.add_argument("--fold-batch", type=int, default=32)
    telemetry.add_telemetry_flag(
        p, what="fleet trace: per-stage spans + scheduler counters; "
                "--telemetry-dir is the multi-trace form")
    faultinject.add_fault_flag(p)
    p.add_argument("--fault-chaos", default=None, metavar="SEED:P",
                   help=not_ported + NOT_PORTED["fault_chaos"][1])
    return p


def _postmortem_dir(outdir: str) -> str:
    from pypulsar_tpu_torch.survey.fleet import plane_dir

    return os.path.join(plane_dir(outdir), "postmortem")


def capsules_by_obs(outdir: str):
    """obs name -> sorted postmortem capsule paths (fleet-level dumps
    under ``"fleet"``), each capsule's own ``obs`` field deciding (file
    names sanitize the obs stem)."""
    from pypulsar_tpu_torch.obs import flightrec

    out = {}
    for path in flightrec.capsule_paths(_postmortem_dir(outdir)):
        obs = "fleet"
        try:
            with open(path) as f:
                doc = json.load(f)
            if isinstance(doc, dict) and doc.get("obs"):
                obs = str(doc["obs"])
        except (OSError, ValueError):
            pass  # torn/foreign file: keep it visible under "fleet"
        out.setdefault(obs, []).append(path)
    return out


def _status_text(outdir: str):
    """The rendered progress table from the manifest, fleet-health and
    plane files and the postmortem capsules, or None when no manifest
    exists."""
    from pypulsar_tpu_torch.survey.fleet import read_plane_status
    from pypulsar_tpu_torch.survey.state import (
        MANIFEST_SUFFIX,
        format_status,
        read_fleet_health,
        status_rows,
    )

    paths = sorted(glob.glob(os.path.join(outdir, "*" + MANIFEST_SUFFIX)))
    if not paths:
        return None
    return format_status(status_rows(paths),
                         health=read_fleet_health(outdir),
                         plane=read_plane_status(outdir),
                         capsules=capsules_by_obs(outdir))


def _status(outdir: str) -> int:
    text = _status_text(outdir)
    if text is None:
        print(f"# no survey manifests under {outdir!r}", file=sys.stderr)
        return 1
    print(text)
    return 0


def _observations(infiles, outdir):
    from pypulsar_tpu_torch.survey.state import Observation

    obs = []
    seen = set()
    for fn in infiles:
        stem = os.path.splitext(os.path.basename(fn))[0]
        if stem in seen:
            raise ValueError(
                f"duplicate observation stem {stem!r}: fleet inputs must "
                f"have distinct basenames (their artifact chains share "
                f"{outdir!r})")
        seen.add(stem)
        obs.append(Observation(stem, fn, os.path.join(outdir, stem)))
    return obs


def _refusal(p, args):
    """The first refused flag given (off its default), as its usage
    error, or None."""
    for dest, (flag, item) in NOT_PORTED.items():
        if getattr(args, dest) != p.get_default(dest):
            return f"{flag} is not ported yet (ROADMAP.md {item})"
    return None


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    refusal = _refusal(p, args)
    if refusal is not None:
        p.error(refusal)
    if args.status:
        return _status(args.outdir)
    if not args.infile:
        p.error("give at least one observation (or --status)")
    gang = _parse_gang(args)
    if gang is None:
        return 2
    from pypulsar_tpu_torch.obs import telemetry
    from pypulsar_tpu_torch.resilience import faultinject

    if args.fault_inject:
        faultinject.configure(args.fault_inject)
    os.makedirs(args.outdir, exist_ok=True)
    fleet_trace = args.telemetry
    if args.telemetry_dir:
        os.makedirs(args.telemetry_dir, exist_ok=True)
        if fleet_trace is None:
            fleet_trace = os.path.join(args.telemetry_dir, "fleet.jsonl")
    with telemetry.session_from_flag(fleet_trace, tool="survey"):
        return _run(args, gang)


def _survey_config(args):
    from pypulsar_tpu_torch.survey.dag import SurveyConfig

    return SurveyConfig(
        mask=args.mask, mask_time=args.mask_time,
        lodm=args.lodm, dmstep=args.dmstep, numdms=args.numdms,
        nsub=args.nsub, group_size=args.group_size,
        downsamp=args.downsamp, chunk=args.chunk,
        threshold=args.threshold,
        accel_zmax=args.accel_zmax, accel_dz=args.accel_dz,
        accel_numharm=args.accel_numharm, accel_sigma=args.accel_sigma,
        accel_batch=args.accel_batch, accel_spectral=args.spectral,
        sift_sigma=args.sift_sigma, sift_min_hits=args.sift_min_hits,
        sift_min_dm=args.sift_min_dm,
        fold_nbins=args.fold_nbins, fold_npart=args.fold_npart,
        fold_batch=args.fold_batch)


def _parse_gang(args):
    """The --gang flag's value (``auto`` is 1: one card per stage), or
    None after a printed usage error: K > 1 is item 14's."""
    gang = args.gang
    if gang == "auto":
        return 1
    try:
        gang = int(gang)
    except ValueError:
        print(f"survey: --gang must be an integer or 'auto', got "
              f"{gang!r}", file=sys.stderr)
        return None
    if gang > 1:
        print(f"survey: --gang {gang} is not ported yet (ROADMAP.md "
              f"{GANG_ITEM}); run --gang 1 (one card per stage)",
              file=sys.stderr)
        return None
    return max(1, gang)


def _run(args, gang: int) -> int:
    from pypulsar_tpu_torch.survey.scheduler import FleetScheduler

    try:
        obs = _observations(args.infile, args.outdir)
    except ValueError as e:
        print(f"survey: {e}", file=sys.stderr)
        return 2
    sched = FleetScheduler(
        obs, _survey_config(args), max_host_workers=args.max_host_workers,
        devices=args.devices, retries=args.retries, resume=args.resume,
        telemetry_dir=args.telemetry_dir, gang=gang,
        stall_s=args.stall_timeout, stage_deadline=args.stage_deadline,
        strike_limit=args.strike_limit, min_free_mb=args.min_free_mb,
        max_pending=args.max_pending, max_bad_frac=args.max_bad_frac,
        verbose=True, device=args.device)
    result = sched.run()
    print(f"# survey: {len(obs)} observations x {len(sched.stages)} "
          f"stages in {result.wall:.2f}s — {len(result.ran)} stages run, "
          f"{len(result.skipped)} skipped (validated), "
          f"{result.retried} retried, "
          f"{len(result.quarantined)} observations quarantined")
    if result.timeouts:
        print(f"#   watchdog interrupts: {result.timeouts} "
              f"(deadline/stall; see survey.deadline_exceeded / "
              f"survey.stage_stalled events in the traces)")
    if result.evicted_devices:
        print(f"#   device leases QUARANTINED mid-fleet: "
              f"{sorted(result.evicted_devices)} (see "
              f"_fleet_health.json / survey --status)")
    for name, q in sorted(result.quarantined.items()):
        tag = ("DATA-QUARANTINED" if q.get("reason") == "data"
               else "QUARANTINED")
        print(f"#   {tag} {name} at {q['stage']}: {q['error']}")
    return 0 if result.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
