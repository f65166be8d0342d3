"""Batch lanes: several same-geometry observations' chains at once on one
card, their device dispatches fused by the batch broker.

The port's counterpart of the fleet scheduler's batch lanes,
``FleetScheduler._claim_lane_mates`` and ``_run_lane``
(``pypulsar_tpu/survey/scheduler.py:147,1647-1738``): the stages of
:func:`~pypulsar_tpu_torch.survey.dag.build_dag` run in topological order
over up to ``width`` observations. The broker stages (``sweep``, whose
accel batches submit to the broker, and ``fold``, whose DM groups do)
run every observation at once, one thread each, after every member has
registered as a party of ``(unit kind, device scope)`` (so the first
submitter's window knows how many batchmates to wait for); each member
withdraws its party as its thread finishes, so a batchmate that is done
never stalls the others. The other stages run one observation at a time.
Same-key units of the lane's observations then fuse into one device
dispatch (:mod:`~pypulsar_tpu_torch.parallel.broker`), and every artifact
keeps the bytes of the observation's serial
:func:`~pypulsar_tpu_torch.survey.dag.run_observation`. Observations of
another geometry run correctly beside them, unfused.

Left out of the reference: the fleet scheduler itself (manifests, leases,
retries, quarantine, the resource guard, multi-host), ROADMAP.md Queue 1
item 16.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Sequence

import torch

from pypulsar_tpu_torch.core.device import resolve_device
from pypulsar_tpu_torch.parallel import broker as broker_mod
from pypulsar_tpu_torch.resilience.retry import is_oom_error
from pypulsar_tpu_torch.survey.dag import (
    StageSpec,
    SurveyConfig,
    build_dag,
)
from pypulsar_tpu_torch.survey.state import Observation

__all__ = ["BROKER_UNITS", "run_lane"]

#: the stages whose device work submits to the broker, and the party kind
#: each registers as (the reference's ``_BROKER_UNITS``)
BROKER_UNITS = {"sweep": "accel", "fold": "fold"}


def _run_concurrent(spec: StageSpec, lane: List[Observation],
                    cfg: SurveyConfig, device: torch.device,
                    walls: Dict[str, Dict[str, float]]) -> None:
    """``spec`` for every observation of ``lane`` at once, one thread
    each, every member a broker party before any of them starts."""
    bk = broker_mod.get_broker()
    party = (BROKER_UNITS[spec.name], broker_mod.device_scope(device))
    for _ in lane:
        bk._party_enter(party)
    errors: Dict[str, BaseException] = {}

    def body(obs: Observation) -> None:
        try:
            t0 = time.perf_counter()
            # the thread's current card is the lane's: the kernels launch
            # on the current device of the calling thread
            with (torch.cuda.device(device) if device.type == "cuda"
                  else contextlib.nullcontext()):
                spec.execute(obs, cfg, device=device)
            walls[obs.name][spec.name] = time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001 - re-raised by the lane
            errors[obs.name] = e
        finally:
            bk._party_exit(party)

    threads = [threading.Thread(target=body, args=(obs,), daemon=True,
                                name=f"lane-{obs.name}-{spec.name}")
               for obs in lane]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for obs in lane:
        e = errors.get(obs.name)
        if e is None:
            continue
        if is_oom_error(e) and device.type == "cuda":
            total = torch.cuda.get_device_properties(device).total_memory
            raise RuntimeError(
                f"a lane of {len(lane)} observations ran out of device "
                f"memory in stage {spec.name!r} ({obs.name}): peak "
                f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB "
                f"of the card's {total / 1e9:.1f} GB; run a narrower lane "
                f"(width=) or a smaller configuration") from e
        raise e


def run_lane(observations: Sequence[Observation], cfg: SurveyConfig,
             device="cuda", width: int = broker_mod.LANE_WIDTH,
             wait_ms: float = broker_mod.WAIT_MS) -> dict:
    """Run every observation's chain (:func:`~pypulsar_tpu_torch.survey.
    dag.build_dag` of ``cfg``) in lanes of up to ``width`` observations
    on ``device`` (default ``"cuda"``, which raises without a card;
    ``"cpu"`` runs the plain versions). ``wait_ms`` is the broker's
    window, how long a leader holds an open batch for its batchmates
    (set on the process's broker). Returns ``{"walls": {name: {stage:
    seconds}}, "wall_s": seconds of the whole call}``; the first
    failing observation's error is raised once its stage's threads have
    ended (a device OOM as a RuntimeError that names the lane's peak
    memory)."""
    device = resolve_device(device)
    obs = list(observations)
    if width < 1:
        raise ValueError(f"width={width} must be >= 1")
    for attr in ("name", "outbase"):
        seen = [getattr(o, attr) for o in obs]
        if len(set(seen)) != len(seen):
            raise ValueError(f"the lane's observations share a {attr}: "
                             f"{seen}")
    broker_mod.get_broker().wait_ms = float(wait_ms)
    walls: Dict[str, Dict[str, float]] = {o.name: {} for o in obs}
    t0 = time.perf_counter()
    for l0 in range(0, len(obs), width):
        lane = obs[l0:l0 + width]
        for spec in build_dag(cfg):
            if spec.name in BROKER_UNITS and len(lane) > 1:
                _run_concurrent(spec, lane, cfg, device, walls)
                continue
            for o in lane:
                t1 = time.perf_counter()
                spec.execute(o, cfg, device=device)
                walls[o.name][spec.name] = time.perf_counter() - t1
    return {"walls": walls, "wall_s": time.perf_counter() - t0}
