"""Single-pulse event grouping: a copy of ``pypulsar_tpu/parallel/events.py``
(host Python).

The sweep's per-chunk events (:meth:`StagedSweepResult.events
<pypulsar_tpu_torch.parallel.staged.StagedSweepResult.events>`,
``cli.sweep --all-events``) report every above-threshold (chunk, trial,
width) cell on its own, so one bright pulse appears once per DM trial and
boxcar width that detects it. :func:`group_events` joins them by
friends-of-friends in the (time, DM) plane: events whose peak times lie
within ``time_tol`` and whose DMs lie within ``dm_tol`` of a member join
one group, which reports its peak-SNR member, its extent and its count.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

__all__ = ["group_events"]


def group_events(
    events: Sequence[dict],
    time_tol: float = 0.02,
    dm_tol: float = 10.0,
) -> List[dict]:
    """Cluster event records into pulse groups.

    ``events``: dicts with at least dm, snr, time_sec (the sweep's event
    schema; width_bins/sample/downsamp are carried through from each
    group's peak member). Association is transitive (friends-of-friends):
    sorted by time, an event joins the current group if it lies within
    ``time_tol`` seconds of the group's latest member and within
    ``dm_tol`` of ANY member's DM; otherwise it opens a new group.

    Returns one record per group, sorted by descending peak SNR::

        {**peak_event, "n_hits": int, "dm_lo": float, "dm_hi": float,
         "time_lo": float, "time_hi": float}
    """
    if not events:
        return []
    ordered = sorted(events, key=lambda e: (e["time_sec"], e["dm"]))
    done: List[Dict] = []
    active: List[Dict] = []
    for ev in ordered:
        t = ev["time_sec"]
        # events arrive time-sorted and an active group's time_hi only
        # grows, so a group that falls out of the time window is retired
        # PERMANENTLY — grouping stays O(n) instead of rescanning every
        # group per event
        still = []
        for g in active:
            (still if t - g["time_hi"] <= time_tol else done).append(g)
        active = still
        # true friends-of-friends: an event touching SEVERAL open groups
        # bridges them — merge all matches into one (greedy first-match
        # would split one physical pulse across rows)
        matches = [g for g in active
                   if g["dm_lo"] - dm_tol <= ev["dm"] <= g["dm_hi"] + dm_tol]
        if not matches:
            active.append(dict(
                peak=ev, n_hits=1, dm_lo=ev["dm"], dm_hi=ev["dm"],
                time_lo=t, time_hi=t))
            continue
        home = matches[0]
        for g in matches[1:]:
            home["n_hits"] += g["n_hits"]
            home["dm_lo"] = min(home["dm_lo"], g["dm_lo"])
            home["dm_hi"] = max(home["dm_hi"], g["dm_hi"])
            home["time_lo"] = min(home["time_lo"], g["time_lo"])
            home["time_hi"] = max(home["time_hi"], g["time_hi"])
            if g["peak"]["snr"] > home["peak"]["snr"]:
                home["peak"] = g["peak"]
            active.remove(g)
        home["n_hits"] += 1
        home["dm_lo"] = min(home["dm_lo"], ev["dm"])
        home["dm_hi"] = max(home["dm_hi"], ev["dm"])
        home["time_hi"] = max(home["time_hi"], t)
        if ev["snr"] > home["peak"]["snr"]:
            home["peak"] = ev

    out = []
    for g in done + active:
        rec = dict(g["peak"])
        rec.update(n_hits=g["n_hits"], dm_lo=g["dm_lo"], dm_hi=g["dm_hi"],
                   time_lo=g["time_lo"], time_hi=g["time_hi"])
        out.append(rec)
    out.sort(key=lambda r: -r["snr"])
    return out
