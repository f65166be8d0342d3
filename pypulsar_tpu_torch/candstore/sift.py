"""Cross-observation candidate sifting (``candsift``; a copy of
``pypulsar_tpu/candstore/sift.py``, host only).

Folds the within-observation harmonic sift (``cli/sift.py``) up to
survey scale: cluster the store's records across epochs by
harmonic-aware (P, DM) proximity, veto known sources via the SAME
matching implementation (``candstore.match``), and rank the survivors.
A pulsar detected at three epochs — possibly at a harmonic of itself in
one of them — becomes ONE cluster with ``n_epochs == 3``, while
per-epoch noise stays in singleton clusters at the bottom of the list.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from pypulsar_tpu_torch.candstore.match import (KnownSource, format_ratio,
                                          harmonic_ratio, match_known)
from pypulsar_tpu_torch.obs import telemetry

__all__ = ["cross_sift"]


def cross_sift(records: Sequence[dict],
               tol_p: Optional[float] = None,
               tol_dm: Optional[float] = None,
               known: Optional[Sequence[KnownSource]] = None,
               max_harm: int = 8) -> List[dict]:
    """Cluster CandidateRecords across observations.

    Greedy strongest-first clustering: records sort by SNR descending,
    each record joins the first cluster whose seed it matches (DM
    within ``tol_dm`` and period a small-integer harmonic ratio of the
    seed's within fractional ``tol_p``) or seeds a new one.  ``known``
    sources annotate (and flag) matching clusters rather than silently
    dropping them — the query surface decides whether to hide them.

    Returns cluster dicts ranked by (epochs seen desc, best SNR desc):
    ``p_s``/``dm`` (seed), ``best_snr``, ``best_sigma``, ``n_hits``,
    ``n_epochs``, ``epochs`` (sorted MJDs), ``per_epoch`` (MJD -> hit
    count), ``obs`` (names), ``tenants``, ``harmonics`` (ratio strings
    seen), ``members`` (record uids), ``known_source``/``known_ratio``.
    The tolerances default to the store's (``store.DEFAULT_TOL_P``,
    ``store.DEFAULT_TOL_DM``).
    """
    from pypulsar_tpu_torch.candstore.store import (DEFAULT_TOL_DM,
                                                    DEFAULT_TOL_P)

    if tol_p is None:
        tol_p = DEFAULT_TOL_P
    if tol_dm is None:
        tol_dm = DEFAULT_TOL_DM

    usable = [r for r in records
              if isinstance(r.get("p_s"), (int, float))
              and isinstance(r.get("dm"), (int, float))]
    usable.sort(key=lambda r: (
        -(float(r["snr"]) if isinstance(r.get("snr"), (int, float))
          else -1e30),
        str(r.get("uid", ""))))

    clusters: List[Dict] = []
    for rec in usable:
        placed = False
        for cl in clusters:
            if abs(rec["dm"] - cl["dm"]) > tol_dm:
                continue
            ratio = harmonic_ratio(rec["p_s"], cl["p_s"], tol_p,
                                   max_harm=max_harm)
            if ratio is None:
                continue
            _absorb(cl, rec, ratio)
            placed = True
            break
        if not placed:
            clusters.append(_seed(rec))

    for cl in clusters:
        cl["epochs"] = sorted(cl["per_epoch"])
        cl["n_epochs"] = len(cl["epochs"]) or 1
        cl["obs"] = sorted(cl["obs"])
        cl["tenants"] = sorted(cl["tenants"])
        cl["harmonics"] = sorted(cl["harmonics"])
        if known:
            hit = match_known(cl["p_s"], cl["dm"], known,
                              tol_p=tol_p, tol_dm=tol_dm,
                              max_harm=max(max_harm, 16))
            if hit is not None:
                src, ratio = hit
                cl["known_source"] = src.name
                cl["known_ratio"] = format_ratio(ratio)

    clusters.sort(key=lambda c: (
        -c["n_epochs"],
        -(c["best_snr"] if c["best_snr"] is not None else -1e30),
        str(c.get("members", [""])[0])))
    if usable:
        telemetry.gauge("candstore.dedup_factor",
                        len(usable) / max(1, len(clusters)))
    return clusters


def _seed(rec: dict) -> Dict:
    cl = {
        "p_s": float(rec["p_s"]), "dm": float(rec["dm"]),
        "best_snr": None, "best_sigma": None,
        "n_hits": 0, "per_epoch": {}, "obs": set(), "tenants": set(),
        "harmonics": set(), "members": [],
        "known_source": None, "known_ratio": None,
    }
    _absorb(cl, rec, (1, 1))
    return cl


def _absorb(cl: Dict, rec: dict, ratio) -> None:
    cl["n_hits"] += 1
    cl["members"].append(str(rec.get("uid", "")))
    cl["harmonics"].add(format_ratio(ratio))
    if rec.get("obs"):
        cl["obs"].add(str(rec["obs"]))
    if rec.get("tenant"):
        cl["tenants"].add(str(rec["tenant"]))
    e = rec.get("epoch_mjd")
    if isinstance(e, (int, float)):
        cl["per_epoch"][float(e)] = cl["per_epoch"].get(float(e), 0) + 1
    snr = rec.get("snr")
    if isinstance(snr, (int, float)) and (
            cl["best_snr"] is None or snr > cl["best_snr"]):
        cl["best_snr"] = float(snr)
    sig = rec.get("sigma")
    if isinstance(sig, (int, float)) and (
            cl["best_sigma"] is None or sig > cl["best_sigma"]):
        cl["best_sigma"] = float(sig)
