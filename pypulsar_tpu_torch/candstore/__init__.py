"""Candidate data plane of the PyTorch/CUDA port (mirrors
pypulsar_tpu/candstore): the survey's system of record for pulsar
candidates, host only.

- ``store``   — append-only segment log + compacted indexed
  snapshot under ``<outdir>/_fleet/candstore/``
- ``records`` — normalizing per-obs terminal artifacts into
  CandidateRecords (the scheduler's ingest edge)
- ``sift``    — cross-observation harmonic clustering + known-source
  veto (``candsift``)
- ``match``   — the ONE (P, DM) matching implementation shared with
  ``cli/sift.py --known-sources``
"""

from pypulsar_tpu_torch.candstore.match import (CatalogError, KnownSource,
                                                catalog_digest, format_ratio,
                                                harmonic_ratio, load_catalog,
                                                match_known)
from pypulsar_tpu_torch.candstore.records import normalize_obs, publish_obs
from pypulsar_tpu_torch.candstore.sift import cross_sift
from pypulsar_tpu_torch.candstore.store import CandStore, store_dir

__all__ = [
    "CandStore", "store_dir",
    "normalize_obs", "publish_obs",
    "cross_sift",
    "KnownSource", "CatalogError", "load_catalog", "match_known",
    "harmonic_ratio", "format_ratio", "catalog_digest",
]
