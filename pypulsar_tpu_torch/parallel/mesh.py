"""Device meshes and the thread's device lease.

Port of ``pypulsar_tpu/parallel/mesh.py``. A :class:`Mesh` is a numpy
object array of ``torch.device``s with named axes: ``'dm'`` shards the
trial groups of a sweep (no communication until the host merges the
rows), and ``'time'`` shards the time axis of a chunk (each time shard
takes its right neighbour's overlap by a device-to-device copy,
``parallel/sweep.make_sharded_sweep_chunk_2d``). ``mesh.shape['dm']``
reads as in the reference.

The **lease** half: the survey scheduler hands a gang stage k leases,
and every mesh built below it must address those cards only.
:func:`device_lease` publishes the thread's device list (and the lease
ids that telemetry stamps); :func:`lease_devices` is the one resolver
every mesh builder goes through:

1. the thread's lease;
2. else the cards ``cuda:0..n-1`` rotated so the thread's current card
   comes first, minus the quarantined ones (off the card, the one
   ``device`` the caller names);
3. fewer than ``k`` raise: a gang never spills past its lease.

A lease, or an explicit ``devices=`` list, may name one card more than
once: that is how a machine with one card runs a mesh (each mesh
position is a logical device with its own shard of the work). No
resolver makes such a list on its own. Telemetry stamps a mesh
position's id (its lease id, or its position), never
``torch.device.index``, so that logical devices sharing a card stay
apart.

Device health (the reference's): :func:`device_health` is the
process-wide :class:`~pypulsar_tpu_torch.resilience.health.DeviceHealth`
keyed by card index; :func:`healthy_devices` drops the quarantined
cards unless that would leave none.
"""

from __future__ import annotations

import contextlib
import threading
from types import MappingProxyType
from typing import List, Optional, Sequence

import numpy as np
import torch

from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.parallel.prefetch import count_shipped
from pypulsar_tpu_torch.resilience.health import DeviceHealth

__all__ = [
    "Mesh",
    "current_lease",
    "device_health",
    "device_key",
    "device_lease",
    "gang_mesh",
    "gather_rows",
    "healthy_devices",
    "lease_device_ids",
    "lease_devices",
    "make_mesh",
    "on_device",
    "replicate",
    "reset_device_health",
]

_tls = threading.local()

# process-wide strike account keyed by card index; reset per fleet
_device_health = DeviceHealth()


def device_health() -> DeviceHealth:
    """The process-wide per-card strike and quarantine account."""
    return _device_health


def reset_device_health(limit: Optional[int] = None) -> DeviceHealth:
    """A fresh strike account (a new fleet, or a test), quarantining past
    ``limit`` strikes."""
    global _device_health
    _device_health = DeviceHealth(limit)
    return _device_health


def _norm(device) -> torch.device:
    """``torch.device(device)`` with a CUDA device's index made explicit
    (``cuda`` is the current card), so that equal cards compare equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def explicit_device(device) -> torch.device:
    """``device`` with a CUDA device's index made explicit: the public
    form of the registry's normalisation, for code outside it that keys
    or names a card."""
    return _norm(device)


def device_key(device) -> tuple:
    """(type, index) of a device: two mesh positions on one card share
    it."""
    d = _norm(device)
    return d.type, d.index


def on_device(device):
    """The calling thread's current CUDA device set to ``device`` for the
    block (the kernels launch on it); a no-op off the card."""
    d = torch.device(device)
    if d.type == "cuda":
        return torch.cuda.device(d)
    return contextlib.nullcontext()


def replicate(data: torch.Tensor, devices) -> List[torch.Tensor]:
    """``data`` on each of ``devices``, copied once per distinct device
    (a mesh that names one card twice holds one copy). A copy from the
    host to a card counts in ``h2d.bytes``, so every block crosses the
    host link once per distinct card; a copy from one card to another
    counts in ``d2d.bytes`` instead."""
    src = device_key(data.device)
    by_key = {src: data}
    out = []
    for d in devices:
        k = device_key(d)
        if k not in by_key:
            by_key[k] = data.to(_norm(d), non_blocking=True)
            nbytes = data.numel() * data.element_size()
            if k[0] == "cuda" and src[0] == "cuda":
                telemetry.counter("d2d.bytes", nbytes)
            elif k[0] == "cuda":
                count_shipped(nbytes)
        out.append(by_key[k])
    return out


def gather_rows(parts, device):
    """Per-shard outputs (tensors, or tuples of tensors) concatenated on
    the trial axis in shard order, on ``device``."""
    device = _norm(device)
    if isinstance(parts[0], tuple):
        return tuple(gather_rows([p[i] for p in parts], device)
                     for i in range(len(parts[0])))
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device, non_blocking=True) for p in parts])


def healthy_devices(devices) -> list:
    """``devices`` minus the quarantined cards, unless that empties the
    list (a host whose every card is quarantined stays usable)."""
    kept = [d for d in devices
            if not (d.type == "cuda"
                    and _device_health.is_quarantined(int(d.index)))]
    return kept if kept else list(devices)


@contextlib.contextmanager
def device_lease(devices, ids: Optional[Sequence[int]] = None):
    """Publish ``devices`` as this thread's device gang for the block
    (re-entrant: an inner lease shadows the outer one). ``ids`` are the
    lease ids telemetry stamps (default: the positions). Any mesh built
    below through :func:`lease_devices` sees only these devices."""
    prev = getattr(_tls, "lease", None)
    devs = tuple(_norm(d) for d in devices)
    lease_ids = (tuple(int(i) for i in ids) if ids is not None
                 else tuple(range(len(devs))))
    if len(lease_ids) != len(devs):
        raise ValueError(f"{len(lease_ids)} lease ids for {len(devs)} "
                         f"devices")
    _tls.lease = (devs, lease_ids)
    try:
        yield devs
    finally:
        _tls.lease = prev


def current_lease() -> Optional[tuple]:
    """The thread's leased device tuple, or None outside a lease."""
    lease = getattr(_tls, "lease", None)
    return None if lease is None else lease[0]


def lease_device_ids() -> Optional[List[int]]:
    """The ids of the thread's lease (what telemetry stamps on records),
    or None outside a lease."""
    lease = getattr(_tls, "lease", None)
    return None if lease is None else list(lease[1])


def lease_devices(k: Optional[int] = None, device="cuda") -> list:
    """The devices this thread's work may address, cut to ``k``: the
    thread's lease; else (``device`` a CUDA device) the healthy cards
    rotated so the thread's current card comes first; else ``[device]``.
    Raises when fewer than ``k`` remain."""
    lease = current_lease()
    if lease:
        # the scheduler's verdict: it excluded quarantined cards already
        devs = list(lease)
    elif torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: the port runs on the card by "
                "default; pass device='cpu' to run the plain PyTorch "
                "versions")
        n = torch.cuda.device_count()
        cur = torch.cuda.current_device()
        order = [(cur + i) % n for i in range(n)]
        devs = healthy_devices([torch.device("cuda", i) for i in order])
    else:
        devs = [_norm(device)]
    if k is not None:
        if len(devs) < k:
            raise ValueError(
                f"need {k} devices but this thread's lease or host offers "
                f"only {len(devs)} ({[str(d) for d in devs]}); a mesh over "
                f"one card named several times needs a lease or an "
                f"explicit device list")
        devs = devs[:k]
    return devs


class Mesh:
    """Devices on named axes: ``devices`` is a numpy object array of
    ``torch.device``s of one dimension per name in ``axis_names``;
    ``shape`` maps each name to its size; ``ids`` (same shape) are the
    positions' telemetry ids (lease ids, or positions)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 ids: Optional[np.ndarray] = None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes "
                             f"{self.axis_names}")
        self.shape = MappingProxyType(dict(zip(self.axis_names,
                                               devices.shape)))
        self.ids = (np.arange(devices.size).reshape(devices.shape)
                    if ids is None else np.asarray(ids).reshape(
                        devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _index(self, name: str, **fixed):
        """Devices and ids along axis ``name``, the other axes at
        ``fixed`` (default index 0)."""
        sel = tuple(slice(None) if a == name else int(fixed.get(a, 0))
                    for a in self.axis_names)
        return list(self.devices[sel]), [int(i) for i in self.ids[sel]]

    def axis_devices(self, name: str, **fixed) -> List[torch.device]:
        """The devices along axis ``name`` (the other axes at ``fixed``,
        default index 0)."""
        return self._index(name, **fixed)[0]

    def axis_ids(self, name: str, **fixed) -> List[int]:
        """The telemetry ids along axis ``name``."""
        return self._index(name, **fixed)[1]

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"{[str(d) for d in self.devices.flat]})")


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("dm", "time"),
              devices=None, device="cuda") -> Mesh:
    """A mesh over ``devices`` (default: :func:`lease_devices` of
    ``device``), all on the first axis unless ``axis_sizes`` says
    otherwise; devices fill the axes in row-major order. Inside a lease
    whose devices are the mesh's, the positions carry the lease ids."""
    if devices is None:
        devices = lease_devices(device=device)
    devs = [_norm(d) for d in devices]
    n = len(devs)
    if axis_sizes is None:
        axis_sizes = [n] + [1] * (len(axis_names) - 1)
    axis_sizes = [int(a) for a in axis_sizes]
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(f"axis sizes {axis_sizes} do not multiply to {n} "
                         f"devices")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devs):
        arr[i] = d
    ids = None
    lease = getattr(_tls, "lease", None)
    if lease is not None and list(lease[0][:n]) == devs:
        ids = np.asarray(lease[1][:n])
    return Mesh(arr.reshape(axis_sizes), axis_names,
                None if ids is None else ids.reshape(axis_sizes))


def gang_mesh(k: int, device="cuda") -> Mesh:
    """A 1-D ``'dm'`` mesh over this thread's ``k`` leased (or
    addressable) devices: the form every DM-sharding CLI path uses."""
    return make_mesh([k], ("dm",), devices=lease_devices(k, device))
