"""The knob registry: the tunables of the stages the auto-tuner serves.

Port of ``pypulsar_tpu/tune/knobs.py`` for the stages it tunes (sweep,
accel, specfuse, fold) and the batch broker's window. Each knob is a
declaration: the stage keyword its value reaches, its type, the module
constant that is its default, the bounded search domain (throughput
knobs only), whether it is results-invariant, and the JAX package's
knob it stands for (``ref``, that package's environment variable).

The reference resolves ``trial > env > tuned > default`` through
process-global overlays. Here nothing is global and nothing reads the
environment: the caller's explicit keyword or flag takes the env layer's
place, and a value reaches a stage only as that stage's keyword::

    trial  >  explicit  >  tuned  >  default

(:func:`resolve`). A search trial's config is the measure callable's
keywords; a cached config is what :func:`pypulsar_tpu_torch.tune.
apply_cached` returns, which the caller passes on.

Science invariance: a knob that can change results is declared
``invariant=False`` and is never searched or cached (:func:`sanitize`
drops it from any stored config). These are the sweep engine, host
downsampling, the ``.dat`` writers' crossover and the specfuse mode.
``variant_engines`` narrows it per engine: ``chunk_fft_len`` keeps the
gather, scan and tree engines' bytes but moves the Fourier engine's FFT
rounding, so the sweep search drops it under ``fourier``. The
single-pulse detector never takes a tuned chunk: its per-chunk
statistics make the chunk part of its results, so only the series
passes (the ``.dat`` writer, the accel handoff) take it.

Defaults are read from their module constants at call time (``const``,
``module:NAME``), so the registry keeps no copy of those numbers.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

__all__ = [
    "Knob",
    "LEFT_OUT",
    "all_knobs",
    "knob",
    "resolve",
    "resolve_all",
    "sanitize",
    "searchable_knobs",
]


@dataclass(frozen=True)
class Knob:
    """One tunable of one stage (its keyword ``name``)."""

    name: str                # the stage keyword the value reaches
    stage: str               # sweep | accel | specfuse | fold | broker
    ktype: str               # int | float | str | bool
    const: Optional[str] = None  # "module:NAME" of the default
    value: Any = None        # the default where no module constant exists
    domain: Tuple = ()       # bounded search candidates (): not searched
    invariant: bool = True   # False: changes results, never searched
    variant_engines: Tuple[str, ...] = ()  # engines where results vary
    ref: str = ""            # the JAX package's knob
    help: str = ""

    @property
    def default(self) -> Any:
        if self.const is None:
            return self.value
        mod, name = self.const.split(":")
        return getattr(importlib.import_module(mod), name)

    def parse(self, raw: Any) -> Any:
        """The typed value of a stored or given ``raw``; ValueError or
        TypeError on garbage."""
        if self.ktype == "int":
            return int(float(raw))
        if self.ktype == "float":
            return float(raw)
        if self.ktype == "bool":
            if isinstance(raw, bool):
                return raw
            raise ValueError(f"{self.name}: not a bool: {raw!r}")
        return str(raw)


_REGISTRY: Dict[Tuple[str, str], Knob] = {}


def _declare(name: str, stage: str, ktype: str, **kw) -> Knob:
    k = Knob(name, stage, ktype, **kw)
    _REGISTRY[(stage, name)] = k
    return k


def knob(stage: str, name: str) -> Knob:
    return _REGISTRY[(stage, name)]


def all_knobs(stage: Optional[str] = None) -> Iterator[Knob]:
    for k in _REGISTRY.values():
        if stage is None or k.stage == stage:
            yield k


def searchable_knobs(stage: str, engine: Optional[str] = None,
                     pinned=()) -> Iterator[Knob]:
    """The knobs a search of ``stage`` may move, in declaration order: a
    domain, results-invariant (under ``engine``), and not ``pinned`` (a
    name the caller gave explicitly, which always wins)."""
    for k in all_knobs(stage):
        if not k.domain or not k.invariant:
            continue
        if engine is not None and engine in k.variant_engines:
            continue
        if k.name in pinned:
            continue
        yield k


def sanitize(stage: str, config: Optional[Mapping[str, Any]],
             engine: Optional[str] = None) -> Dict[str, Any]:
    """The part of a stored or searched ``config`` that may reach
    ``stage``: registered, results-invariant (under ``engine``) knobs,
    each parsed to its type. Anything else is dropped, a value that does
    not parse too: a cache file never flips an engine or a mode."""
    out = {}
    for name, raw in (config or {}).items():
        k = _REGISTRY.get((stage, name))
        if k is None or not k.invariant:
            continue
        if engine is not None and engine in k.variant_engines:
            continue
        try:
            out[name] = k.parse(raw)
        except (TypeError, ValueError):
            continue
    return out


def resolve(stage: str, name: str, explicit: Any = None,
            tuned: Optional[Mapping[str, Any]] = None,
            trial: Optional[Mapping[str, Any]] = None) -> Any:
    """One knob's value: ``trial > explicit > tuned > default``.
    ``explicit`` None means the caller gave none."""
    k = knob(stage, name)
    if trial and name in trial:
        return trial[name]
    if explicit is not None:
        return explicit
    if tuned and name in tuned:
        return tuned[name]
    return k.default


def resolve_all(stage: str, explicit: Optional[Mapping[str, Any]] = None,
                tuned: Optional[Mapping[str, Any]] = None,
                trial: Optional[Mapping[str, Any]] = None
                ) -> Dict[str, Any]:
    """Every knob of ``stage`` through :func:`resolve`."""
    explicit = explicit or {}
    return {k.name: resolve(stage, k.name, explicit.get(k.name), tuned,
                            trial)
            for k in all_knobs(stage)}


# ---------------------------------------------------------------------------
# declarations: the reference's rows (knobs.py:314-440) for these stages
# ---------------------------------------------------------------------------

# -- sweep ------------------------------------------------------------------
_declare("chunk_fft_len", "sweep", "int",
         const="pypulsar_tpu_torch.parallel.sweep:DEFAULT_CHUNK_FFT_LEN",
         domain=(1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20),
         variant_engines=("fourier",), ref="PYPULSAR_TPU_SWEEP_CHUNK",
         help="FFT length of a series pass's chunk (payload + overlap); "
              "reaches the .dat writer and the accel handoff as "
              "chunk_payload, never the single-pulse detector")
_declare("engine", "sweep", "str", value="auto", invariant=False,
         ref="PYPULSAR_TPU_SWEEP_ENGINE",
         help="chunk formulation: results-affecting, never searched")
_declare("host_downsample", "sweep", "bool", value=False, invariant=False,
         ref="PYPULSAR_TPU_HOST_DOWNSAMP",
         help="sum eligible blocks on the host before the ship")
_declare("dats_resident_limit", "sweep", "float",
         const="pypulsar_tpu_torch.cli.sweep:DATS_RESIDENT_LIMIT",
         invariant=False, ref="PYPULSAR_TPU_DATS_RESIDENT_LIMIT",
         help="float32 bytes of a file above which --write-dats streams "
              "instead of dedispersing a resident Spectra; the two "
              "writers give other series (the reference declares it "
              "invariant)")

# -- accel ------------------------------------------------------------------
_declare("batch", "accel", "int",
         const="pypulsar_tpu_torch.parallel.accelpipe:ACCEL_BATCH",
         domain=(8, 16, 32, 64), ref="PYPULSAR_TPU_ACCEL_BATCH",
         help="spectra per batched search dispatch (flags still win)")
_declare("hbm_budget_bytes", "accel", "float",
         const="pypulsar_tpu_torch.fourier.accelsearch:ACCEL_HBM_BYTES",
         domain=(2e9, 5e9, 8e9), ref="PYPULSAR_TPU_ACCEL_HBM",
         help="device bytes the batched search plans for")
_declare("stream_ram_bytes", "accel", "float",
         const="pypulsar_tpu_torch.parallel.accelpipe:STREAM_RAM_BYTES",
         ref="PYPULSAR_TPU_ACCEL_STREAM_RAM",
         help="host bytes of the handoff's series buffer")
_declare("bank_cache_bytes", "accel", "float",
         const="pypulsar_tpu_torch.fourier.accelsearch:BANK_CACHE_BYTES",
         ref="PYPULSAR_TPU_ACCEL_BANK_CACHE",
         help="device bytes of cached template banks")

# -- specfuse ---------------------------------------------------------------
_declare("specfuse_hbm_bytes", "specfuse", "float",
         const="pypulsar_tpu_torch.parallel.specfuse:SPECFUSE_HBM_BYTES",
         ref="PYPULSAR_TPU_SPECFUSE_HBM",
         help="device bytes of one --spectral fused DM slice")
_declare("specfuse_mode", "specfuse", "str", value="stitch",
         invariant=False, ref="PYPULSAR_TPU_SPECFUSE_MODE",
         help="stitch or decimate: results-affecting, never searched")

# -- fold -------------------------------------------------------------------
_declare("stream_ram_bytes", "fold", "float",
         const="pypulsar_tpu_torch.parallel.foldpipe:STREAM_RAM_BYTES",
         ref="PYPULSAR_TPU_FOLD_STREAM_RAM",
         help="host bytes of the stream source's series buffer")
_declare("stack_bytes", "fold", "float",
         const="pypulsar_tpu_torch.parallel.foldpipe:FOLD_STACK_BYTES",
         ref="PYPULSAR_TPU_FOLD_BINIDX_RAM",
         help="device bytes of a fused fold's series stack (the port's "
              "stand-in for the reference's one-hot bins budget)")

# -- batch broker -----------------------------------------------------------
_declare("wait_ms", "broker", "float",
         const="pypulsar_tpu_torch.parallel.broker:WAIT_MS",
         domain=(25.0, 100.0, 400.0), ref="PYPULSAR_TPU_BROKER_WAIT_MS",
         help="window a broker leader holds an open batch for "
              "batchmates")

#: the JAX package's knobs of these stages with no port counterpart, and
#: why
LEFT_OUT = {
    "PYPULSAR_TPU_TREE_PLAN_CACHE":
        "a module constant of the tree engine's host plan cache "
        "(ops/tree_dedisperse.PLAN_CACHE_SIZE), no stage keyword",
    "PYPULSAR_TPU_BROKER":
        "the port's stages always submit to the broker",
    "PYPULSAR_TPU_BROKER_LANE":
        "the lane width is run_lane's and the scheduler's keyword",
    "PYPULSAR_TPU_BROKER_SLO_HOLD_S":
        "the broker's slo_hold_s keyword; not a throughput knob",
}
