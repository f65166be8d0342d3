"""The observation a survey chain runs on (a copy of
``pypulsar_tpu/survey/state.py``'s :class:`Observation`; the fleet's
manifests, status views and traces are not ported, ROADMAP.md Queue 1
item 16)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Observation:
    """One survey member: a raw file plus the basename its whole artifact
    chain (mask, .cands, .dat/.cand trails, .accelcands, .pfd, SNR
    summary) is rooted at."""

    name: str
    infile: str
    outbase: str
