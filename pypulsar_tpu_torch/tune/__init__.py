"""Auto-tuning: the knob registry, the bounded search and the persisted
geometry-keyed cache.

Port of ``pypulsar_tpu/tune/``. Three layers, one surface (this module):

- :mod:`~pypulsar_tpu_torch.tune.knobs`: each stage's tunables, resolved
  ``trial > explicit > tuned > default``;
- :mod:`~pypulsar_tpu_torch.tune.search`: deterministic, budgeted
  coordinate descent timing real stage dispatches
  (:mod:`~pypulsar_tpu_torch.tune.stages`);
- :mod:`~pypulsar_tpu_torch.tune.cache`: the JSON cache keyed by
  geometry, engine, device name and the torch and CUDA versions.

The stage entry points consult it with their run's geometry
(:func:`apply_cached`): ``cli.sweep`` (sweep, accel and, with
``--spectral``, specfuse), ``cli.accelsearch`` (``--batch auto``) and
``parallel.foldpipe.fold_pipeline`` (fold). The mode is a keyword (the
CLIs' ``--tune``):

- ``cache`` (the default): a hit returns the stored config, a miss
  returns ``{}`` (the defaults; no search is paid unasked);
- ``search``: a miss runs the bounded search at the stage's geometry and
  stores the winner (a stage with no measure builder stays cache-only);
- ``off``: no consult and no file I/O.

Both functions *return* the applied config; the caller passes it on as
the stage's keywords, below its explicit flags. Nothing is installed
process-wide, so two stages in two threads never see each other's
values. Neither raises on a broken cache file: tuning is a passenger,
never the payload.

Telemetry (the reference's names): ``tune.cache_hit``,
``tune.cache_miss`` and ``tune.trials`` counters, ``tune.applied`` and
``tune.winner`` events, a ``tune_search`` span around each search
(``tune_trial`` around each timed run).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.tune import knobs
from pypulsar_tpu_torch.tune.cache import TuneCache, make_key
from pypulsar_tpu_torch.tune.search import DEFAULT_TRIALS

__all__ = ["MODES", "TuneCache", "apply_cached", "autotune", "knobs",
           "make_key", "tuning_mode"]

MODES = ("cache", "search", "off")


def tuning_mode(mode: Optional[str] = "cache") -> str:
    """``cache``, ``search`` or ``off`` (None is ``cache``); ValueError
    on any other word."""
    mode = "cache" if mode is None else mode
    if mode not in MODES:
        raise ValueError(f"tuning mode {mode!r} is not one of {MODES}")
    return mode


def _applied(stage: str, ent, engine) -> Dict[str, Any]:
    applied = knobs.sanitize(stage, ent["config"], engine)
    if applied:
        telemetry.event("tune.applied", stage=stage, config=applied)
    return applied


def apply_cached(stage: str, *, mode: Optional[str] = "cache",
                 cache_path: Optional[str] = None,
                 nchan: Optional[int] = None, nsamp: Optional[int] = None,
                 dtype: Optional[str] = None, zmax: Optional[int] = None,
                 engine: Optional[str] = None, device=None,
                 explicit: Optional[Mapping[str, Any]] = None
                 ) -> Dict[str, Any]:
    """The entry points' consult: the cached config of this geometry
    (``{}`` on a miss or ``off``); in ``search`` mode a miss runs the
    bounded search first (stages with a measure builder). ``explicit``
    names the caller's explicit values: a search does not move them.
    Never raises on the cache's account: only an unknown ``mode`` is a
    ValueError."""
    from pypulsar_tpu_torch.tune.stages import MEASURED_STAGES

    mode = tuning_mode(mode)
    if mode == "off":
        return {}
    try:
        if mode == "search" and stage in MEASURED_STAGES:
            return autotune(stage, nchan=nchan, nsamp=nsamp, dtype=dtype,
                            zmax=zmax, engine=engine, device=device,
                            cache_path=cache_path, explicit=explicit)
        ent = TuneCache(cache_path).lookup(make_key(
            stage, nchan=nchan, nsamp=nsamp, dtype=dtype, zmax=zmax,
            engine=engine, device=device))
        return {} if ent is None else _applied(stage, ent, engine)
    except Exception:  # noqa: BLE001 - tuning is a passenger
        return {}


def autotune(stage: str, *, nchan: Optional[int] = None,
             nsamp: Optional[int] = None, dtype: Optional[str] = None,
             zmax: Optional[int] = None, engine: Optional[str] = None,
             device=None, measure=None, cache_path: Optional[str] = None,
             explicit: Optional[Mapping[str, Any]] = None,
             budget: int = DEFAULT_TRIALS, force_search: bool = False,
             verbose: bool = False, **measure_kw) -> Dict[str, Any]:
    """Cache or search: a hit returns the stored config with zero
    trials; a miss (or ``force_search``) runs the bounded search with
    ``measure`` (built by :func:`~pypulsar_tpu_torch.tune.stages.
    measure_for_stage` at this geometry, ``measure_kw`` passed on, when
    not given), stores the winner, emits ``tune.winner`` and returns the
    winning config."""
    from pypulsar_tpu_torch.tune.search import coordinate_search
    from pypulsar_tpu_torch.tune.stages import measure_for_stage

    cache = TuneCache(cache_path)
    key = make_key(stage, nchan=nchan, nsamp=nsamp, dtype=dtype, zmax=zmax,
                   engine=engine, device=device)
    ent = cache.lookup(key)
    if ent is not None and not force_search:
        return _applied(stage, ent, engine)
    explicit = {k: v for k, v in (explicit or {}).items() if v is not None}
    if measure is None:
        measure = measure_for_stage(
            stage, nchan=nchan, nsamp=nsamp, zmax=zmax, engine=engine,
            device=device if device is not None else "cuda",
            explicit=explicit, **measure_kw)
    with telemetry.span("tune_search", aggregate=False, stage=stage):
        res = coordinate_search(stage, measure, engine=engine,
                                pinned=tuple(explicit), budget=budget,
                                device=device, verbose=verbose)
    config = res.tuned_config()
    meta = {"stage": stage, "n_trials": res.n_trials,
            "baseline_s": round(res.baseline_s, 6),
            "best_s": round(res.best_s, 6),
            "speedup": round(res.speedup, 4), "baseline": res.baseline}
    cache.store(key, config, meta=meta)
    telemetry.event("tune.winner", stage=stage, key=key, config=config,
                    n_trials=res.n_trials,
                    baseline_s=round(res.baseline_s, 6),
                    best_s=round(res.best_s, 6))
    return knobs.sanitize(stage, config, engine)
