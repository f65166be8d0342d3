"""The per-observation stage DAG over the port's entry points: port of
``pypulsar_tpu/survey/dag.py``.

Five stages close the raw -> science chain::

    mask (device)  rfifind-compatible RFI mask from the data
      └─ sweep (device)  DM sweep + streamed accel handoff
           (``sweep --accel-search --write-dats --journal --mask``:
           single-pulse .cands, per-DM .dat/.inf tee, per-trial
           .cand/.txtcand; ``accel_spectral`` swaps ``--write-dats`` for
           ``--spectral``, the handoff fused on the device)
           └─ sift (host)  cluster per-DM candidates -> .accelcands
                └─ fold (device)  batched candidate folding -> .pfd
                     (from the .dat tee; under ``accel_spectral``, which
                     writes none, from the raw file with the sweep's
                     subbands, group size, downsampling and mask)
                     └─ snr (host)  pfd_snr --json summary

Each :class:`StageSpec` declares whether it needs the device, which
stages it depends on, the argv of the CLI entry point the serial chain
runs (``pypulsar_tpu_torch.cli.{tool}``, called in-process, so the
artifacts are the tools' own) and its outputs, enumerated after the run.
:func:`run_observation` runs the stages in topological order, as the
reference's serial chain does; device-bound stages get ``--device``. The
fleet scheduler (``survey/scheduler.py``) runs the same specs over many
observations, with the stage deadlines its watchdog reads
(``deadline_s``, ``deadline_per_mb``).

The sweep stage is gang-able (the reference's): ``devices_max`` is
:data:`SWEEP_GANG_MAX` and its ``gang_argv`` (:func:`_sweep_gang_argv`)
is the same argv plus ``--mesh k``, whose mesh the sweep builds from the
scheduler's device lease. Gang size is placement, not science: the
artifacts do not depend on ``k``, so a manifest resumes across gang
sizes.
"""

from __future__ import annotations

import glob
import importlib
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from pypulsar_tpu_torch.survey.state import Observation

__all__ = [
    "NOT_SCIENCE",
    "StageExit",
    "StageSpec",
    "SurveyConfig",
    "build_dag",
    "run_observation",
    "stage_names",
]

class StageExit(RuntimeError):
    """A stage's CLI entry point returned a nonzero exit code."""


@dataclass
class SurveyConfig:
    """Every knob the five stages take, with the individual tools'
    defaults (field for field the reference's).

    ``accel_batch=None`` leaves ``--accel-batch`` off the sweep's argv,
    so the sweep CLI's tuning consult and then its default of 32 apply.
    ``accel_spectral=True`` fuses the sweep stage's handoff on the device
    (``sweep --spectral``), and the fold stage streams the raw file since
    no ``.dat`` exists.

    Two fields the reference reads from its environment are forwarded
    to the sweep and fold stages' argv here: ``tune`` (``--tune``: cache,
    search or off; None leaves the CLIs' default, cache; the fold, which
    has no search, takes ``search`` as ``cache``) and ``tune_cache``
    (``--tune-cache PATH``). They move throughput, never an artifact, so
    the fleet's manifest fingerprint leaves them out
    (:data:`NOT_SCIENCE`)."""

    # mask (rfifind)
    mask: bool = True
    mask_time: float = 1.0
    # sweep (flat grid)
    lodm: float = 0.0
    dmstep: float = 1.0
    numdms: int = 32
    nsub: int = 64
    group_size: int = 0
    downsamp: int = 1
    chunk: Optional[int] = None
    threshold: float = 6.0
    # accel handoff
    accel_zmax: float = 200.0
    accel_dz: float = 2.0
    accel_numharm: int = 8
    accel_sigma: float = 2.0
    accel_batch: Optional[int] = None
    accel_spectral: bool = False
    # sift
    sift_sigma: float = 4.0
    sift_min_hits: int = 2
    sift_min_dm: Optional[float] = None
    # fold
    fold_nbins: int = 64
    fold_npart: int = 32
    fold_batch: int = 32
    # auto-tuning (the reference's PYPULSAR_TPU_TUNE / _TUNE_CACHE)
    tune: Optional[str] = None
    tune_cache: Optional[str] = None


#: SurveyConfig fields that never change an artifact: left out of the
#: fleet's manifest fingerprint
NOT_SCIENCE = ("tune", "tune_cache")


@dataclass(frozen=True)
class StageSpec:
    """One DAG node. ``run`` defaults to dispatching ``argv`` to the
    ``tool`` CLI's in-process ``main``; a stage with logic that is not a
    plain CLI call (snr's empty-observation guard) overrides it.

    ``deadline_s`` / ``deadline_per_mb`` are the stage's wall-clock
    budget for the fleet's watchdog: a flat bound, a bound per MB of the
    observation's input, or their sum. None/None (the default) means no
    deadline. Like placement, deadlines are policy, not science: they
    are not part of the manifest's fingerprint."""

    name: str
    tool: str
    device_bound: bool
    deps: Tuple[str, ...]
    argv: Callable[[Observation, SurveyConfig], List[str]]
    outputs: Callable[[Observation, SurveyConfig], List[str]]
    run: Optional[Callable[[Observation, SurveyConfig], int]] = field(
        default=None)
    deadline_s: Optional[float] = None
    deadline_per_mb: Optional[float] = None
    devices_max: int = 1
    gang_argv: Optional[Callable[[Observation, SurveyConfig, int],
                                 List[str]]] = None

    def deadline_for(self, obs: Observation) -> Optional[float]:
        """This stage's deadline for ``obs`` in seconds, or None when
        the spec declares none; an unstatable input adds nothing (the
        stage reports the missing file)."""
        if self.deadline_s is None and self.deadline_per_mb is None:
            return None
        total = self.deadline_s or 0.0
        if self.deadline_per_mb:
            try:
                mb = os.path.getsize(obs.infile) / 1e6
            except OSError:
                mb = 0.0
            total += self.deadline_per_mb * mb
        return total if total > 0 else None

    def execute(self, obs: Observation, cfg: SurveyConfig,
                device="cuda", gang: int = 1) -> None:
        """Run the stage for ``obs``; a device-bound stage runs on
        ``device`` (its argv gets ``--device``), a gang of ``gang`` > 1
        with its ``gang_argv``. Raises :class:`StageExit` on a nonzero
        exit code."""
        if self.run is not None:
            rc = self.run(obs, cfg)
        else:
            argv = (self.gang_argv(obs, cfg, gang)
                    if gang > 1 and self.gang_argv is not None
                    else self.argv(obs, cfg))
            if self.device_bound:
                argv = argv + ["--device", str(device)]
            rc = run_cli_tool(self.tool, argv)
        if rc:
            raise StageExit(f"stage {self.name!r} ({self.tool}) exited "
                            f"{rc} for observation {obs.name!r}")


def run_cli_tool(tool: str, argv: List[str]) -> int:
    """Call ``pypulsar_tpu_torch.cli.{tool}.main(argv)`` in-process;
    argparse's exits (SystemExit) become exit codes."""
    mod = importlib.import_module(f"pypulsar_tpu_torch.cli.{tool}")
    try:
        return int(mod.main(argv) or 0)
    except SystemExit as e:
        code = e.code
        return code if isinstance(code, int) else 1


def _sorted_glob(pattern: str) -> List[str]:
    return sorted(glob.glob(pattern))


def _mask_file(obs: Observation) -> str:
    return f"{obs.outbase}_rfifind.mask"


def _mask_argv(obs: Observation, cfg: SurveyConfig) -> List[str]:
    return [obs.infile, "-o", obs.outbase, "-t", str(cfg.mask_time)]


def _mask_outputs(obs: Observation, cfg: SurveyConfig) -> List[str]:
    outs = [_mask_file(obs)]
    stats = f"{obs.outbase}_rfifind.stats.npz"
    if os.path.exists(stats):
        outs.append(stats)
    return outs


#: widest gang one sweep stage may hold (leases, not a science knob: not
#: in SurveyConfig, so changing it never restarts a manifest)
SWEEP_GANG_MAX = 8


def _sweep_argv(obs: Observation, cfg: SurveyConfig) -> List[str]:
    # spectral fusion has no series to tee to .dat files
    series = ["--spectral"] if cfg.accel_spectral else ["--write-dats"]
    argv = [obs.infile, "-o", obs.outbase,
            "--lodm", str(cfg.lodm), "--dmstep", str(cfg.dmstep),
            "--numdms", str(cfg.numdms), "-s", str(cfg.nsub),
            "--group-size", str(cfg.group_size),
            "--threshold", str(cfg.threshold),
            *series, "--accel-search",
            "--accel-zmax", str(cfg.accel_zmax),
            "--accel-dz", str(cfg.accel_dz),
            "--accel-numharm", str(cfg.accel_numharm),
            "--accel-sigma", str(cfg.accel_sigma),
            *(["--accel-batch", str(cfg.accel_batch)]
              if cfg.accel_batch is not None else []),
            # the chain journal gives the sweep stage its own resume: a
            # redone stage skips the validated units
            "--journal", f"{obs.outbase}.chain.jsonl"]
    if cfg.downsamp != 1:
        argv += ["--downsamp", str(cfg.downsamp)]
    if cfg.chunk is not None:
        argv += ["--chunk", str(cfg.chunk)]
    if cfg.mask:
        argv += ["--mask", _mask_file(obs)]
    return argv + _tune_argv(cfg, cfg.tune)


def _tune_argv(cfg: SurveyConfig, mode: Optional[str]) -> List[str]:
    return ((["--tune", mode] if mode is not None else [])
            + (["--tune-cache", cfg.tune_cache]
               if cfg.tune_cache is not None else []))


def _sweep_gang_argv(obs: Observation, cfg: SurveyConfig,
                     k: int) -> List[str]:
    """The k-lease form of the sweep stage: the same argv plus ``--mesh
    k`` (the sweep builds its mesh from the thread's gang lease)."""
    return _sweep_argv(obs, cfg) + ["--mesh", str(k)]


def _sweep_outputs(obs: Observation, cfg: SurveyConfig) -> List[str]:
    return ([f"{obs.outbase}.cands"]
            + _sorted_glob(f"{obs.outbase}_DM*.dat")
            + _sorted_glob(f"{obs.outbase}_DM*.inf")
            + _sorted_glob(f"{obs.outbase}_DM*_ACCEL_*.cand")
            + _sorted_glob(f"{obs.outbase}_DM*_ACCEL_*.txtcand"))


def _sift_argv(obs: Observation, cfg: SurveyConfig) -> List[str]:
    argv = (_sorted_glob(f"{obs.outbase}_DM*_ACCEL_*.cand")
            + ["-s", str(cfg.sift_sigma),
               "--min-hits", str(cfg.sift_min_hits),
               "-o", f"{obs.outbase}.accelcands"])
    if cfg.sift_min_dm is not None:
        argv += ["--min-dm", str(cfg.sift_min_dm)]
    return argv


def _sift_outputs(obs: Observation, cfg: SurveyConfig) -> List[str]:
    return [f"{obs.outbase}.accelcands"]


def _fold_argv(obs: Observation, cfg: SurveyConfig) -> List[str]:
    argv = ["--cands", f"{obs.outbase}.accelcands", "-o", obs.outbase,
            "-n", str(cfg.fold_nbins), "--npart", str(cfg.fold_npart),
            "--batch", str(cfg.fold_batch),
            *_tune_argv(cfg, "cache" if cfg.tune == "search" else cfg.tune)]
    if cfg.accel_spectral:
        # no .dat tee: fold from the raw file, dedispersed with the
        # sweep's own series geometry and mask, so the folded series are
        # the ones the candidates were found in
        return ([obs.infile, *argv, "-s", str(cfg.nsub),
                 "--group-size", str(cfg.group_size)]
                + (["--downsamp", str(cfg.downsamp)]
                   if cfg.downsamp != 1 else [])
                + (["--mask", _mask_file(obs)] if cfg.mask else []))
    return argv + ["--datbase", obs.outbase]


def _fold_outputs(obs: Observation, cfg: SurveyConfig) -> List[str]:
    outs = _sorted_glob(f"{obs.outbase}_cand*.pfd")
    summary = f"{obs.outbase}_foldbatch.json"
    if os.path.exists(summary):
        outs.append(summary)
    return outs


def _snr_json(obs: Observation) -> str:
    return f"{obs.outbase}_snr.json"


def _snr_argv(obs: Observation, cfg: SurveyConfig) -> List[str]:
    return (_sorted_glob(f"{obs.outbase}_cand*.pfd")
            + ["--json", _snr_json(obs)])


def _snr_run(obs: Observation, cfg: SurveyConfig) -> int:
    """pfd_snr over the folded archives. An observation whose sift kept
    nothing (no archives) is an empty survey row, not an error: pfd_snr
    needs at least one input, so the empty summary is written here."""
    if not _sorted_glob(f"{obs.outbase}_cand*.pfd"):
        from pypulsar_tpu_torch.resilience.journal import atomic_write_text

        atomic_write_text(_snr_json(obs), "[]")
        return 0
    return run_cli_tool("pfd_snr", _snr_argv(obs, cfg))


def _snr_outputs(obs: Observation, cfg: SurveyConfig) -> List[str]:
    return [_snr_json(obs)]


def build_dag(cfg: SurveyConfig) -> List[StageSpec]:
    """The stage list in topological order (``mask`` drops out, and the
    sweep drops ``--mask``, under ``cfg.mask=False``)."""
    stages: List[StageSpec] = []
    sweep_deps: Tuple[str, ...] = ()
    if cfg.mask:
        stages.append(StageSpec("mask", "rfifind", True, (),
                                _mask_argv, _mask_outputs))
        sweep_deps = ("mask",)
    stages += [
        StageSpec("sweep", "sweep", True, sweep_deps,
                  _sweep_argv, _sweep_outputs,
                  devices_max=SWEEP_GANG_MAX,
                  gang_argv=_sweep_gang_argv),
        StageSpec("sift", "sift", False, ("sweep",),
                  _sift_argv, _sift_outputs),
        StageSpec("fold", "foldbatch", True, ("sift",),
                  _fold_argv, _fold_outputs),
        StageSpec("snr", "pfd_snr", False, ("fold",),
                  _snr_argv, _snr_outputs, run=_snr_run),
    ]
    return stages


def stage_names(stages) -> List[str]:
    return [s.name for s in stages]


def run_observation(obs: Observation, cfg: SurveyConfig,
                    device="cuda") -> Dict[str, float]:
    """Run ``obs`` through every stage of :func:`build_dag` in order, the
    device-bound ones on ``device`` (their argv is the reference's plus
    ``--device``). Returns each stage's wall seconds; a failing stage
    raises :class:`StageExit`."""
    walls: Dict[str, float] = {}
    for spec in build_dag(cfg):
        t0 = time.perf_counter()
        spec.execute(obs, cfg, device=device)
        walls[spec.name] = time.perf_counter() - t0
    return walls
