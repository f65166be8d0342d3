"""The state a search carries besides its data: the sweep's plan and the
acceleration search's configuration.

A sweep has no weights. What fixes its result apart from the data is the
plan's trial DMs and integer shift tables, so this is what is carried
over from the reference: :func:`plan_from_reference` builds the port's
:class:`~pypulsar_tpu_torch.parallel.sweep.SweepPlan` from the fields of
a reference ``SweepPlan`` given as numpy arrays, so both packages can run
the same shift tables. :func:`accel_config_from_reference` does the same
for the acceleration search's configuration (its grids, stages and
thresholds follow from the fields).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from pypulsar_tpu_torch.fourier.accelsearch import AccelSearchConfig
from pypulsar_tpu_torch.parallel.sweep import SweepPlan


def plan_from_reference(dms, freqs, dt: float, nsub: int, group_size: int,
                        stage1_bins, stage2_bins, subdms, n_real_trials: int,
                        widths: Sequence[int]) -> SweepPlan:
    """The port's plan from a reference plan's fields (checked shapes)."""
    stage1 = np.ascontiguousarray(stage1_bins, dtype=np.int32)
    stage2 = np.ascontiguousarray(stage2_bins, dtype=np.int32)
    dms = np.asarray(dms, dtype=np.float64)
    freqs = np.asarray(freqs, dtype=np.float64)
    G, C = stage1.shape
    if stage2.shape != (G, int(group_size), int(nsub)) or len(freqs) != C:
        raise ValueError(f"inconsistent plan: stage1 {stage1.shape}, stage2 "
                         f"{stage2.shape}, {len(freqs)} channels, nsub "
                         f"{nsub}, group {group_size}")
    if len(dms) != G * int(group_size) or not 0 < n_real_trials <= len(dms):
        raise ValueError(f"{len(dms)} trial DMs for {G} groups of "
                         f"{group_size} ({n_real_trials} real)")
    return SweepPlan(dms=dms, freqs=freqs, dt=float(dt), nsub=int(nsub),
                     group_size=int(group_size), stage1_bins=stage1,
                     stage2_bins=stage2,
                     subdms=np.asarray(subdms, dtype=np.float64),
                     n_real_trials=int(n_real_trials),
                     widths=tuple(int(w) for w in widths))


def accel_config_from_reference(cfg) -> AccelSearchConfig:
    """The port's :class:`~pypulsar_tpu_torch.fourier.accelsearch.
    AccelSearchConfig` with every field of a reference configuration
    ``cfg`` (any object with those attributes)."""
    return AccelSearchConfig(**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(AccelSearchConfig)})
