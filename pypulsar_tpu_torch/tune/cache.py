"""The persisted, geometry-keyed tuning cache.

Port of ``pypulsar_tpu/tune/cache.py``. One JSON file maps a tuning key
(schema, stage, nchan, the nsamp power-of-two bucket, dtype, zmax,
engine, the torch device's name, the torch and CUDA versions) to the
winning config the bounded search found there, with its provenance
(trials, baseline and best seconds). Where the reference keys the
backend's device kind and the JAX version, this key takes
``torch.cuda.get_device_name`` (``"cpu"`` off the card) and
``torch.__version__`` with ``torch.version.cuda``.

Durability (``tests/test_torch_tune.py``):

- a corrupt or torn file is ignored (a ``tune.cache_corrupt`` event) and
  rebuilt by the next store, never fatal;
- a changed key component is another key, so a torch upgrade, another
  card or a schema change never serves a stale config;
- writes are atomic (tmp + ``os.replace``) and merged under an ``flock``
  on ``PATH.lock`` (read, merge, write), so concurrent writers, threads
  or processes, keep each other's entries;
- ``nsamp`` is bucketed to the next power of two.

The path is a keyword (default :func:`default_cache_path`); nothing is
read from the environment.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import torch

from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.resilience.journal import atomic_write_text

__all__ = ["SCHEMA_VERSION", "TuneCache", "default_cache_path",
           "device_name", "make_key"]

SCHEMA_VERSION = 1


def default_cache_path() -> str:
    """``~/.cache/pypulsar_tpu_torch/tune.json``."""
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "pypulsar_tpu_torch", "tune.json")


def pow2_bucket(n: Optional[int]) -> Optional[int]:
    if n is None or n <= 0:
        return n
    return 1 << (int(n) - 1).bit_length()


def device_name(device=None) -> str:
    """The name of the device tuned numbers are measured on: the CUDA
    card's name, or ``"cpu"``; ``None`` is the card when there is one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(dev)


def versions() -> str:
    """``torch=VERSION|cuda=VERSION`` (``cuda=none`` for a CPU build)."""
    return f"torch={torch.__version__}|cuda={torch.version.cuda or 'none'}"


def make_key(stage: str, *, nchan: Optional[int] = None,
             nsamp: Optional[int] = None, dtype: Optional[str] = None,
             zmax: Optional[int] = None, engine: Optional[str] = None,
             device=None) -> str:
    """Canonical key string: every component that can move the optimum,
    or the meaning of the stored config, is in it."""
    parts = [
        "s%d" % SCHEMA_VERSION,
        "stage=%s" % stage,
        "nchan=%s" % (nchan if nchan is not None else "-"),
        "nsamp=%s" % (pow2_bucket(nsamp) if nsamp is not None else "-"),
        "dtype=%s" % (dtype or "-"),
        "zmax=%s" % (zmax if zmax is not None else "-"),
        "engine=%s" % (engine or "-"),
        "device=%s" % device_name(device),
        versions(),
    ]
    return "|".join(parts)


def _empty() -> Dict[str, Any]:
    return {"schema": SCHEMA_VERSION, "entries": {}}


class TuneCache:
    """Load, look up and store against one cache file (the module
    docstring's contract)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_cache_path()

    def _load(self) -> Dict[str, Any]:
        try:
            with open(self.path) as f:
                data = json.load(f)
        except FileNotFoundError:
            return _empty()
        except (OSError, ValueError):
            telemetry.event("tune.cache_corrupt", path=self.path)
            return _empty()
        if (not isinstance(data, dict)
                or data.get("schema") != SCHEMA_VERSION
                or not isinstance(data.get("entries"), dict)):
            telemetry.event("tune.cache_corrupt", path=self.path)
            return _empty()
        return data

    def _write_locked(self, mutate) -> None:
        """Read, merge and write under an exclusive ``flock`` of
        ``PATH.lock``; the write is tmp + ``os.replace``."""
        import fcntl

        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path + ".lock", "a+") as lf:
            fcntl.flock(lf.fileno(), fcntl.LOCK_EX)
            data = self._load()
            mutate(data["entries"])
            atomic_write_text(self.path, json.dumps(data, indent=1,
                                                    sort_keys=True))

    def entries(self) -> Dict[str, Any]:
        return self._load()["entries"]

    def lookup(self, key: str) -> Optional[Dict[str, Any]]:
        """The entry at ``key`` (``{"config": ..., "meta": ...}``) or
        None; counts ``tune.cache_hit`` or ``tune.cache_miss``."""
        ent = self._load()["entries"].get(key)
        if isinstance(ent, dict) and isinstance(ent.get("config"), dict):
            telemetry.counter("tune.cache_hit")
            return ent
        telemetry.counter("tune.cache_miss")
        return None

    def store(self, key: str, config: Dict[str, Any],
              meta: Optional[Dict[str, Any]] = None) -> None:
        entry = {"config": dict(config),
                 "meta": dict(meta or {}, written_unix=time.time())}
        self._write_locked(lambda entries: entries.__setitem__(key, entry))

    def clear(self, stage: Optional[str] = None) -> int:
        """Drop every entry, or one stage's; returns how many went."""
        removed = [0]

        def mutate(entries):
            victims = [k for k in entries
                       if stage is None or f"|stage={stage}|" in k]
            removed[0] = len(victims)
            for k in victims:
                del entries[k]

        self._write_locked(mutate)
        return removed[0]
