"""The fleet's shared directory and its read-only status view (the
single-host part of ``pypulsar_tpu/survey/fleet.py``).

A fleet keeps its shared state under ``<outdir>/_fleet/`` (:func:`plane_dir`):
the candidate store (``candstore/``) and the flight recorder's postmortem
capsules (``postmortem/``). On several hosts the reference also keeps
the host leases (``hosts/``) and the observation claims (``claims/``)
there; that plane (``FleetPlane``: heartbeat-renewed host leases,
fencing tokens, claims and adoption) is ROADMAP.md S21: the scheduler
refuses a plane and ``survey --hosts``/``--host-id`` exit 2 naming S21.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = [
    "PLANE_DIR",
    "plane_dir",
    "read_plane_status",
]

PLANE_DIR = "_fleet"


def plane_dir(outdir: str) -> str:
    return os.path.join(outdir, PLANE_DIR)


def read_plane_status(outdir: str) -> Optional[dict]:
    """The plane view ``survey --status`` renders: ``{"hosts": {},
    "claims": {}}`` whenever ``<outdir>/_fleet`` exists (a single-host
    fleet holds no host lease and no claim, and the reference's view of
    it has both empty, which adds the owner column), None otherwise."""
    if not os.path.isdir(plane_dir(outdir)):
        return None
    return {"hosts": {}, "claims": {}}
