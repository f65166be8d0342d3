"""Bounded on-line config search: deterministic, budgeted coordinate
descent over the declared knob domains.

Port of ``pypulsar_tpu/tune/search.py``, with its visiting order:

- one knob at a time in declaration order, each domain probed nearest
  value first, upward then downward from the current value;
- early cutoff: a candidate slower than ``cutoff`` x the best so far
  abandons the rest of that direction;
- at most two passes, and never more than ``budget`` timed trials;
- each config timed as the least of ``repeats`` runs (the first run
  pays the builds and the caches).

The candidate config reaches the measured stage as the measure
callable's keywords (``measure(**config)``), not through an overlay, so
nothing a search does is visible outside its call. Knobs the caller gave
explicitly (``pinned``) are not searched, and knobs whose results vary
under ``engine`` are left out (:func:`~pypulsar_tpu_torch.tune.knobs.
searchable_knobs`). On a CUDA ``device`` each run is bracketed by
``torch.cuda.synchronize``, so its wall holds the work it queued.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.tune import knobs

__all__ = ["DEFAULT_TRIALS", "SearchResult", "coordinate_search"]

#: trial budget of one stage's search (the reference's default)
DEFAULT_TRIALS = 20


@dataclass
class SearchResult:
    stage: str
    baseline: Dict[str, Any]
    baseline_s: float
    best: Dict[str, Any]
    best_s: float
    n_trials: int
    trials: List[Tuple[Dict[str, Any], float]] = field(default_factory=list)

    @property
    def speedup(self) -> float:
        return self.baseline_s / self.best_s if self.best_s > 0 else 1.0

    def tuned_config(self) -> Dict[str, Any]:
        """The knobs the search moved off the baseline: what the cache
        stores (an unchanged knob would pin today's default)."""
        return {k: v for k, v in self.best.items()
                if self.baseline.get(k) != v}


def coordinate_search(stage: str, measure: Callable[..., Any], *,
                      engine: Optional[str] = None, pinned=(),
                      budget: int = DEFAULT_TRIALS, repeats: int = 2,
                      cutoff: float = 1.35, device=None,
                      verbose: bool = False) -> SearchResult:
    """Tune ``stage``'s searchable knobs against ``measure``, which runs
    one stage dispatch at the run's geometry with the candidate config
    as its keywords, from the knobs' defaults. Returns the
    :class:`SearchResult`; the caller decides whether to store it."""
    import torch

    coords = list(knobs.searchable_knobs(stage, engine, pinned))
    baseline = {k.name: k.default for k in coords}
    sync = (torch.device(device).type == "cuda"
            if device is not None else False)
    spent = [0]

    def timed(cfg: Dict[str, Any]) -> float:
        best = None
        for _ in range(max(1, repeats)):
            with telemetry.span("tune_trial", stage=stage):
                if sync:
                    torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                measure(**cfg)
                if sync:
                    torch.cuda.synchronize(device)
                dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        telemetry.counter("tune.trials")
        spent[0] += 1
        if verbose:
            moved = {k: v for k, v in cfg.items() if baseline.get(k) != v}
            print(f"# tune[{stage}] trial {spent[0]}: {best:.4f}s  "
                  f"{moved or '(baseline)'}")
        return best

    current = dict(baseline)
    baseline_s = best_s = timed(current)
    trials: List[Tuple[Dict[str, Any], float]] = [(dict(current),
                                                   baseline_s)]
    improved, passes = True, 0
    while improved and passes < 2 and spent[0] < budget:
        improved = False
        passes += 1
        for k in coords:
            if spent[0] >= budget:
                break
            dom = sorted(set(k.domain))
            cur = current[k.name]
            below = [v for v in dom if v < cur][::-1]  # nearest first
            above = [v for v in dom if v > cur]
            for direction in (above, below):
                for v in direction:
                    if spent[0] >= budget:
                        break
                    cand = dict(current, **{k.name: v})
                    t = timed(cand)
                    trials.append((dict(cand), t))
                    if t < best_s:
                        best_s, current, improved = t, cand, True
                    elif t > cutoff * best_s:
                        break  # this direction regresses past noise
    return SearchResult(stage=stage, baseline=baseline,
                        baseline_s=baseline_s, best=dict(current),
                        best_s=best_s, n_trials=spent[0], trials=trials)
