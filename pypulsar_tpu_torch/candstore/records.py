"""Normalizing one observation's terminal artifacts into
CandidateRecords for the store (a port of
``pypulsar_tpu/candstore/records.py``, host only; it reads the artifacts
through the port's own readers, ``io/filterbank`` and ``io/accelcands``).

The ingest edge reads what the DAG already wrote — ``<outbase>_snr.json``
(the ``pfd_snr --json`` batch rows) and ``<outbase>.accelcands`` (the
sifted candidate list) — and emits flat dicts carrying everything the
query surface and the cross-observation sift need: obs id, tenant,
epoch MJD, sky position, P, DM, z, SNR, harmonic count, artifact paths
and trace id.  It only ever READS stage outputs: per-obs artifacts stay
byte-identical whether or not the store is enabled (the A/B acceptance
contract).

The publish fingerprint is a digest over the artifact files the records
were derived from, so a resume that re-lands on unchanged artifacts is
an exactly-once no-op in the store's books, while a re-run that changed
the artifacts supersedes the old records.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

from pypulsar_tpu_torch.resilience.journal import file_digest

__all__ = ["normalize_obs", "publish_obs", "snr_json_path",
           "accelcands_path"]


def snr_json_path(outbase: str) -> str:
    return f"{outbase}_snr.json"


def accelcands_path(outbase: str) -> str:
    return f"{outbase}.accelcands"


def _digest_or_missing(path: str) -> str:
    if not os.path.exists(path):
        return "missing"
    try:
        size, digest = file_digest(path)
    except OSError:
        return "missing"
    return f"{size}:{digest}"


def _ra_dec_from_header(infile: str) -> Tuple[Optional[str], Optional[str],
                                              Optional[float]]:
    """(ra, dec, epoch MJD) from the observation's filterbank header.
    Best-effort: the scheduler's stub-stage tests run with fake input
    files, and a position-blind record is better than no record."""
    try:
        from pypulsar_tpu_torch.io.filterbank import FilterbankFile

        with FilterbankFile(infile) as fil:
            hdr = fil.header
    except Exception:
        return None, None, None
    return (_sex(hdr.get("src_raj"), hours=True),
            _sex(hdr.get("src_dej"), hours=False),
            float(hdr["tstart"]) if isinstance(hdr.get("tstart"),
                                               (int, float)) else None)


def _sex(v, hours: bool) -> Optional[str]:
    """sigproc packs RA as float HHMMSS.s and Dec as (-)DDMMSS.s —
    render the human sexagesimal string the pfd headers use."""
    if not isinstance(v, (int, float)):
        return None
    sign = "-" if (v < 0 and not hours) else ""
    v = abs(float(v))
    d = int(v // 10000)
    m = int((v - d * 10000) // 100)
    s = v - d * 10000 - m * 100
    return f"{sign}{d:02d}:{m:02d}:{s:07.4f}"


def _load_snr_rows(path: str) -> List[dict]:
    try:
        with open(path) as f:
            rows = json.load(f)
    except (OSError, ValueError):
        return []
    return [r for r in rows if isinstance(r, dict)]


def _load_accelcands(path: str) -> List:
    try:
        from pypulsar_tpu_torch.io.accelcands import parse_candlist

        return list(parse_candlist(path))
    except Exception:
        return []


def normalize_obs(obs_name: str, outbase: str, infile: str,
                  tenant: str = "default",
                  trace_id: Optional[str] = None
                  ) -> Tuple[List[dict], str]:
    """One observation's CandidateRecords + the publish fingerprint.

    Primary rows come from the folded-SNR JSON (one per refined .pfd),
    augmented with z/numharm/sigma from the nearest (P, DM) sifted
    accelcand; when no SNR JSON exists (sift-only DAG slice) the
    accelcands themselves become the records.  Row-level ``ra``/``dec``
    (pfd_snr's rows carry them) win over the filterbank header's
    position."""
    snr_path = snr_json_path(outbase)
    acc_path = accelcands_path(outbase)
    ra, dec, epoch = _ra_dec_from_header(infile)
    cands = _load_accelcands(acc_path)
    records: List[dict] = []

    def base(p_s, dm) -> Dict:
        return {
            "obs": obs_name, "tenant": tenant, "trace_id": trace_id,
            "epoch_mjd": epoch,
            "p_s": float(p_s) if isinstance(p_s, (int, float)) else None,
            "dm": float(dm) if isinstance(dm, (int, float)) else None,
            "ra": ra, "dec": dec,
        }

    rows = _load_snr_rows(snr_path)
    for row in rows:
        if row.get("period") is None:
            continue  # failed fold: no (P, DM) to index on
        rec = base(row.get("period"), row.get("best_dm"))
        rec.update({
            "snr": row.get("snr"),
            "smean_mjy": row.get("smean_mjy"),
            "artifacts": [p for p in (row.get("pfd"), snr_path)
                          if p],
        })
        if row.get("ra") is not None:
            rec["ra"] = row["ra"]
        if row.get("dec") is not None:
            rec["dec"] = row["dec"]
        near = _nearest_cand(cands, rec["p_s"], rec["dm"])
        if near is not None:
            rec["z"] = float(near.z)
            rec["numharm"] = int(near.numharm)
            rec["sigma"] = float(near.sigma)
        records.append(rec)
    if not rows:
        for c in cands:
            rec = base(c.period, c.dm)
            rec.update({
                "snr": float(c.snr), "sigma": float(c.sigma),
                "z": float(c.z), "numharm": int(c.numharm),
                "artifacts": [acc_path],
            })
            records.append(rec)

    h = hashlib.sha256()
    h.update(obs_name.encode())
    # metadata that rides on every record but is NOT derivable from
    # the artifact files: if the tenant mapping or the filterbank
    # header's position/epoch changes between runs while the artifacts
    # do not, the fingerprint must still change, so the re-publish
    # supersedes the stale records instead of being dup-skipped and
    # leaving e.g. /candidates?tenant= filtering wrong forever
    # (trace_id stays OUT — it differs every run and would defeat the
    # exactly-once resume no-op)
    h.update(f"\x00{tenant}\x00{ra}\x00{dec}\x00{epoch}\x00".encode())
    h.update(_digest_or_missing(snr_path).encode())
    h.update(_digest_or_missing(acc_path).encode())
    return records, h.hexdigest()


def _nearest_cand(cands, p_s, dm):
    """The sifted accelcand closest to (P, DM) within loose bounds —
    how a folded row recovers the z/harmonic family it came from."""
    if p_s is None or not cands:
        return None
    best = None
    best_d = None
    for c in cands:
        if dm is not None and abs(c.dm - dm) > 2.0:
            continue
        d = abs(c.period - p_s) / p_s
        if d > 0.01:
            continue
        if best_d is None or d < best_d:
            best, best_d = c, d
    return best


def publish_obs(outdir: str, obs_name: str, outbase: str, infile: str,
                tenant: str = "default",
                trace_id: Optional[str] = None,
                fence: Optional[Callable[[], None]] = None,
                token: Optional[int] = None, **store_kw) -> int:
    """Normalize + publish one observation in one call (the scheduler's
    terminal-edge ingest); ``store_kw`` goes to :class:`CandStore`.
    Returns the number of records appended."""
    from pypulsar_tpu_torch.candstore.store import CandStore

    records, fingerprint = normalize_obs(
        obs_name, outbase, infile, tenant=tenant, trace_id=trace_id)
    store = CandStore(outdir, fence=fence, **store_kw)
    return store.publish(obs_name, records, fingerprint, token=token)
