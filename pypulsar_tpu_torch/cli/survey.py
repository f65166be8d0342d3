"""Run the full search chain over a fleet of observations (``survey``; a
port of ``pypulsar_tpu/cli/survey.py``).

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

Multi-host::

    python -m pypulsar_tpu_torch.cli survey beam*.fil -o out/ --hosts 2
    # or one process per machine against a shared out/:
    python -m pypulsar_tpu_torch.cli survey beam*.fil -o out/ --host-id nodeA

``--hosts M`` launches M host processes of this command against the
shared ``--outdir``, child r with ``--host-id host{r}`` in its argv and
nothing added to its environment (several children share one card);
``--host-id`` joins a fleet as one named host. Observations are claimed
through fsync'd, fencing-token'd lease files under ``out/_fleet/``, with
no coordinator service (``survey/fleet.py``). A host that dies, or goes
heartbeat-silent past ``--host-lease`` seconds, has its in-flight
observations adopted by the survivors, resuming from their manifests as
``--resume`` does; its late writes are rejected by the fencing token.
``--status`` then adds a host-liveness block and an owner column.

Streaming daemon (``survey/daemon.py``)::

    python -m pypulsar_tpu_torch.cli survey --daemon -o out/ \
        --watch incoming/:teamA --daemon-port 7070 \
        --tenant teamA:2:0.5:4 --status-port 7071

watches directories and takes ``<tenant> <path>`` lines on the loopback
port, admits arrivals through per-tenant token buckets into a running
fleet, sheds lowest-priority unaccepted work past ``--queue-bound``, and
drains on SIGTERM. ``--status-port N`` serves ``/status.json``,
``/metrics`` and ``/candidates`` on 127.0.0.1:N for the run
(``obs/statusd.py``); ``survey --status --follow [--status-port N]``
refreshes the table every ``--follow-interval`` seconds.

Refused, each with exit 2 naming its ROADMAP.md item: ``--gang K`` for
K > 1 (item 14; ``--gang auto`` is 1 here) and ``--fault-chaos`` (item
16).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

#: refused flags: argparse dest -> (flag, the ROADMAP.md item bringing it)
NOT_PORTED = {
    "fault_chaos": ("--fault-chaos", "Queue 1 item 16 (chaos mode)"),
}
GANG_ITEM = "Queue 1 item 14 (multi-GPU)"
#: ``--status --follow``'s refresh period (the reference's
#: ``PYPULSAR_TPU_OBS_FOLLOW_S`` default), seconds
FOLLOW_S = 2.0


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
                   help="with --status: refresh the progress table every "
                        "--follow-interval seconds until interrupted; "
                        "with --status-port N it polls the live endpoint "
                        "at 127.0.0.1:N instead of re-reading the files")
    p.add_argument("--follow-interval", type=float, default=FOLLOW_S,
                   metavar="S",
                   help=f"--follow's refresh period (default {FOLLOW_S:g})")
    p.add_argument("--status-port", type=int, default=None, metavar="N",
                   help="serve the live --status snapshot as JSON at "
                        "http://127.0.0.1:N/status.json, Prometheus "
                        "metrics at /metrics and the candidate store at "
                        "/candidates for the duration of the run (0 picks "
                        "a free port; default off)")
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
    g = p.add_argument_group(
        "multi-host fleet (shared-directory coordination plane)")
    g.add_argument("--hosts", type=int, default=0, metavar="M",
                   help="launch M host processes of this command against "
                        "the shared --outdir (observations claimed via "
                        "fenced lease files under <outdir>/_fleet; a "
                        "dead host's in-flight observations are adopted "
                        "by survivors); child r runs with --host-id "
                        "host<r>. 0 (default): single-process")
    g.add_argument("--host-id", default=None, metavar="NAME",
                   help="join the fleet under --outdir as ONE host named "
                        "NAME (what --hosts children do; give it yourself "
                        "to run one process per machine against a shared "
                        "filesystem)")
    g.add_argument("--host-lease", type=float, default=None, metavar="S",
                   help="heartbeat-silence bound before a host is "
                        "declared dead and its observations adoptable "
                        "(default 10)")
    g = p.add_argument_group(
        "streaming daemon (multi-tenant admission + shedding)")
    g.add_argument("--daemon", action="store_true",
                   help="run as a long-lived ingest service: watch "
                        "directories (--watch) and accept socket "
                        "submissions (--daemon-port), admitting "
                        "arrivals through per-tenant token-bucket "
                        "quotas + the resource guard into the running "
                        "fleet; past --queue-bound the daemon SHEDS "
                        "lowest-priority unaccepted work (accepted "
                        "work is manifested and survives kill+restart); "
                        "SIGTERM drains cleanly")
    g.add_argument("--watch", action="append", default=[],
                   metavar="DIR[:TENANT]",
                   help="watch DIR for arriving .fil/.sf/.raw files "
                        "(ingested once size-stable for --quiesce "
                        "seconds) billed to TENANT (default "
                        "'default'); repeatable")
    g.add_argument("--daemon-port", type=int, default=None, metavar="N",
                   help="accept '<tenant> <path>' submissions on "
                        "127.0.0.1:N, one verdict line back per "
                        "request (0 picks a free port; default off)")
    g.add_argument("--tenant", action="append", default=[],
                   metavar="NAME[:PRIO[:RATE[:BURST]]]",
                   help="pin one tenant's admission contract: higher "
                        "PRIO sheds last; RATE admissions/s refill a "
                        "BURST-deep token bucket (RATE 0 = unmetered; "
                        "unlisted tenants: unmetered, burst 8); "
                        "repeatable")
    g.add_argument("--queue-bound", type=int, default=None, metavar="N",
                   help="bounded accept queue: past N pending "
                        "(unaccepted) arrivals the daemon sheds lowest "
                        "priority / thinnest quota first (default 64)")
    g.add_argument("--quiesce", type=float, default=None, metavar="S",
                   help="watch-lane quiesce window: a file becomes an "
                        "arrival only once its size is stable for S "
                        "seconds (default 1)")
    g.add_argument("--daemon-poll", type=float, default=None,
                   metavar="S",
                   help="service-loop tick: watch scan + admission "
                        "pump + status mirror (default 0.5)")
    g.add_argument("--daemon-idle-exit", type=float, default=None,
                   metavar="S",
                   help="drain after S seconds with no arrivals and "
                        "nothing in flight (default off = run until "
                        "SIGTERM)")
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


def _status_text(outdir: str, port=None):
    """One rendered progress table (or None when no manifest exists):
    read from a live ``--status-port`` endpoint when ``port`` is given,
    else straight from the manifest, fleet-health, plane and tenant
    files and the postmortem capsules."""
    from pypulsar_tpu_torch.survey.state import format_status

    if port:
        import json
        import urllib.request

        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/status.json", timeout=5) as r:
            snap = json.load(r)
        if not snap.get("rows"):
            return None
        return format_status(snap["rows"], health=snap.get("health"),
                             plane=snap.get("plane"),
                             capsules=snap.get("capsules"),
                             tenants=snap.get("tenants"))
    from pypulsar_tpu_torch.obs.statusd import capsules_by_obs
    from pypulsar_tpu_torch.survey.daemon import read_tenant_status
    from pypulsar_tpu_torch.survey.fleet import read_plane_status
    from pypulsar_tpu_torch.survey.state import (
        MANIFEST_SUFFIX,
        read_fleet_health,
        status_rows,
    )

    paths = sorted(glob.glob(os.path.join(outdir, "*" + MANIFEST_SUFFIX)))
    if not paths:
        return None
    return format_status(status_rows(paths),
                         health=read_fleet_health(outdir),
                         plane=read_plane_status(outdir),
                         capsules=capsules_by_obs(outdir),
                         tenants=read_tenant_status(outdir))


def _status(outdir: str, follow: bool = False, port=None,
            interval: float = FOLLOW_S) -> int:
    text = _status_text(outdir, port=port)
    if text is None:
        print(f"# no survey manifests under {outdir!r}", file=sys.stderr)
        return 1
    print(text)
    if not follow:
        return 0
    import time

    try:
        while True:
            time.sleep(max(0.2, float(interval)))
            text = _status_text(outdir, port=port)
            # ANSI clear + home: a refreshing view, not a scrolling log
            sys.stdout.write("\033[2J\033[H")
            print(text if text is not None
                  else f"# no survey manifests under {outdir!r}")
            sys.stdout.flush()
    except KeyboardInterrupt:
        return 0


#: how a ``--hosts`` child starts: this package's survey CLI, importable
#: from the package's own root whatever the working directory
_CHILD = ("import sys; sys.path.insert(0, {root!r}); "
          "from pypulsar_tpu_torch.cli.survey import main; "
          "sys.exit(main(sys.argv[1:]))")


def _launch_hosts(args, argv) -> int:
    """The ``--hosts M`` launcher: M child processes of this same
    command (``--hosts`` stripped, ``--host-id host<r>`` appended), each
    a full fleet host claiming observations through the shared plane.
    Nothing is added to the children's environment: the plane is plain
    files and needs no collective runtime."""
    import subprocess

    child_argv = []
    skip = 0
    for a in (argv if argv is not None else sys.argv[1:]):
        if skip:
            skip -= 1
            continue
        if a == "--hosts":
            skip = 1
            continue
        if a.startswith("--hosts="):
            continue
        child_argv.append(a)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD.format(root=root), *child_argv,
         "--host-id", f"host{rank}"]) for rank in range(args.hosts)]
    rc = 0
    for rank, proc in enumerate(procs):
        code = proc.wait()
        print(f"# survey: host{rank} (pid {proc.pid}) exited {code}")
        rc = max(rc, abs(code))
    return rc


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
        return _status(args.outdir, follow=args.follow,
                       port=args.status_port,
                       interval=args.follow_interval)
    if not args.infile and not (args.daemon and (
            args.watch or args.daemon_port is not None)):
        p.error("give at least one observation (or --status, or "
                "--daemon with --watch/--daemon-port)")
    if args.hosts and args.hosts < 1:
        p.error(f"--hosts must be >= 1, got {args.hosts}")
    if args.hosts and args.host_id:
        p.error("--hosts launches its own named hosts; give one or the "
                "other")
    if args.daemon and (args.hosts or args.host_id):
        p.error("--daemon is a single-host service; run one daemon per "
                "host, each with its own --outdir")
    gang = _parse_gang(args)
    if gang is None:
        return 2
    if args.hosts:
        os.makedirs(args.outdir, exist_ok=True)
        return _launch_hosts(args, argv)
    from pypulsar_tpu_torch.obs import telemetry
    from pypulsar_tpu_torch.resilience import faultinject

    if args.fault_inject:
        faultinject.configure(args.fault_inject)
    os.makedirs(args.outdir, exist_ok=True)
    host = args.host_id
    fleet_trace = args.telemetry
    if args.telemetry_dir:
        os.makedirs(args.telemetry_dir, exist_ok=True)
        if fleet_trace is None:
            # per-host fleet traces: M hosts sharing one telemetry dir
            # must not clobber each other's scheduler trace
            name = f"fleet.{host}.jsonl" if host else "fleet.jsonl"
            fleet_trace = os.path.join(args.telemetry_dir, name)
    meta = {"tool": "survey"}
    if host:
        # the stitched timeline's lane key: tlmtrace maps each trace
        # file to a process lane by its meta host
        meta["host"] = host
    with telemetry.session_from_flag(fleet_trace, **meta):
        if args.daemon:
            return _run_daemon(args, gang)
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
    plane = None
    host_id = args.host_id
    if host_id is not None:
        from pypulsar_tpu_torch.survey.fleet import FleetPlane

        plane = FleetPlane(args.outdir, host_id=host_id,
                           lease_s=args.host_lease)
    sched = FleetScheduler(
        obs, _survey_config(args), max_host_workers=args.max_host_workers,
        devices=args.devices, retries=args.retries, resume=args.resume,
        telemetry_dir=args.telemetry_dir, gang=gang,
        stall_s=args.stall_timeout, stage_deadline=args.stage_deadline,
        strike_limit=args.strike_limit, min_free_mb=args.min_free_mb,
        max_pending=args.max_pending, max_bad_frac=args.max_bad_frac,
        plane=plane, verbose=True, device=args.device)
    server = _status_server(args)
    try:
        result = sched.run()
    finally:
        if server is not None:
            server.close()
    tag = f"[{host_id}] " if host_id else ""
    print(f"# survey: {tag}{len(obs)} observations x {len(sched.stages)} "
          f"stages in {result.wall:.2f}s — {len(result.ran)} stages run, "
          f"{len(result.skipped)} skipped (validated), "
          f"{result.retried} retried, "
          f"{len(result.quarantined)} observations quarantined")
    if plane is not None:
        print(f"#   multi-host: {len(result.remote_done)} observations "
              f"finished by other hosts, {len(result.adopted)} adopted "
              f"here ({', '.join(result.adopted) or 'none'}), "
              f"{len(result.ceded)} ceded to adopters")
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


def _status_server(args):
    """The ``--status-port`` endpoint, started; None without the flag or
    when the port cannot be bound (observability is a passenger: a taken
    port must not stop the fleet)."""
    if args.status_port is None:
        return None
    from pypulsar_tpu_torch.obs.statusd import StatusServer

    try:
        server = StatusServer(args.outdir, args.status_port).start()
    except OSError as e:
        print(f"# survey: --status-port {args.status_port} disabled "
              f"({e})", file=sys.stderr)
        return None
    print(f"# survey: live status at {server.url}/status.json "
          f"(+ Prometheus {server.url}/metrics, {server.url}/candidates)",
          flush=True)
    return server


def _parse_watch(spec: str):
    """``DIR[:TENANT]`` — a bare DIR bills the ``default`` tenant."""
    d, sep, tenant = spec.rpartition(":")
    if sep and d and tenant and os.sep not in tenant:
        return d, tenant
    return spec, "default"


def _run_daemon(args, gang: int) -> int:
    """The ``--daemon`` service: a SurveyDaemon around a service-mode
    fleet, SIGTERM/SIGINT wired to a clean drain (the handler installed
    from the main thread), positional infiles fed through the same
    admission path as every other arrival."""
    import signal

    from pypulsar_tpu_torch.survey.daemon import (
        SurveyDaemon,
        parse_tenant_spec,
    )

    try:
        tenants = [parse_tenant_spec(t) for t in args.tenant]
    except ValueError as e:
        print(f"survey: {e}", file=sys.stderr)
        return 2
    daemon = SurveyDaemon(
        args.outdir, _survey_config(args),
        tenants=tenants, watch=[_parse_watch(w) for w in args.watch],
        initial=[("default", fn) for fn in args.infile],
        port=args.daemon_port,
        queue_bound=args.queue_bound, quiesce_s=args.quiesce,
        poll_s=args.daemon_poll, idle_exit_s=args.daemon_idle_exit,
        min_free_mb=args.min_free_mb, max_pending=args.max_pending,
        verbose=True,
        max_host_workers=args.max_host_workers, devices=args.devices,
        retries=args.retries, telemetry_dir=args.telemetry_dir,
        gang=gang, stall_s=args.stall_timeout,
        stage_deadline=args.stage_deadline,
        strike_limit=args.strike_limit, max_bad_frac=args.max_bad_frac,
        device=args.device)
    for signum in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(signum, lambda *_: daemon.request_drain())
        except ValueError:
            pass  # not the main thread (tests drive main() in a thread)
    server = _status_server(args)
    if daemon.port is not None:
        print(f"# survey: daemon submissions on 127.0.0.1:{daemon.port}",
              flush=True)
    print("# survey: daemon up — SIGTERM drains (accepted work "
          "finishes; the unaccepted queue is shed with recorded "
          "reasons)", flush=True)
    try:
        result = daemon.run()
    finally:
        if server is not None:
            server.close()
    st = daemon.stats()
    print(f"# survey: daemon drained — {st['submitted']} submitted, "
          f"{st['accepted']} accepted, {st['shed']} shed, "
          f"{st['quarantined']} quarantined, {st['completed']} completed")
    if result is not None and not result.ok:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
