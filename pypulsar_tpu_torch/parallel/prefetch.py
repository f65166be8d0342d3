"""Ordered background ship of streamed blocks to the device.

Port of ``pypulsar_tpu/parallel/prefetch.py`` and ``staged._ship_ahead``.
A daemon thread pulls raw blocks (disk reads), copies each into pinned
host memory and starts its host-to-device copy with ``non_blocking`` on a
side CUDA stream, ``depth`` blocks ahead of the consumer. The consumer's
stream waits on each block's copy event before using it, so the copy of
block N+1 overlaps the kernels of block N.

Contract (as the reference's): items arrive in order; an exception in the
worker re-raises in the consumer at its next pull; a consumer that stops
early signals the worker, which then stops producing and closes the
items' iterator (a read-ahead ring's generator joins its thread there).
The transform retries a transient ``OSError`` (``retries``, through
``resilience.retry.retry_transient``) with the fault point
``{name}.produce`` inside the retry loop; the consumer waits at most
``timeout`` seconds an item (:data:`PREFETCH_TIMEOUT_S`; <= 0 waits
forever) and then raises ``TimeoutError`` after a
``resilience.prefetch_timeout`` event. Under a telemetry session the
queue fill goes to the ``{name}.pending_depth`` gauge, recorded by the
worker before it parks (so max == depth + 1 means the producer kept
fully ahead) and by the consumer after each pull; the bytes a ship
copies to a CUDA device go to ``h2d.bytes``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.resilience import faultinject
from pypulsar_tpu_torch.resilience.locks import TrackedEvent
from pypulsar_tpu_torch.resilience.retry import retry_transient

_DONE = object()
CLEANUP_DEADLINE_S = 5.0
#: seconds a consumer waits for one item before declaring the producer
#: wedged (the reference's ``PYPULSAR_TPU_PREFETCH_TIMEOUT`` default)
PREFETCH_TIMEOUT_S = 900.0


def _produce(xf: Callable, item, name: str, retries: int):
    def attempt():
        faultinject.trip(f"{name}.produce")
        return xf(item)

    return retry_transient(attempt, retries=retries, what=name)


def prefetch(items: Iterable, depth: int = 2,
             transform: Optional[Callable] = None, name: str = "prefetch",
             retries: int = 0, timeout: float = PREFETCH_TIMEOUT_S):
    """Yield ``transform(item)`` for each item, produced ``depth`` ahead
    on a daemon thread (module docstring for the contract)."""
    xf = transform if transform is not None else (lambda it: it)
    gauge_name = f"{name}.pending_depth"
    deadline = None if timeout <= 0 else timeout
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = TrackedEvent("prefetch.stop")
    # the consumer's trace context, re-entered by the worker so its spans
    # land on the stage's trace
    trace_ctx = telemetry.current_context()

    def worker():
        it = iter(items)
        with telemetry.adopt_context(trace_ctx):
            try:
                for item in it:
                    if stop.is_set():
                        return
                    out = _produce(xf, item, name, retries)
                    if telemetry.is_active():
                        telemetry.gauge(gauge_name, q.qsize() + 1)
                    q.put(out)
            except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
                q.put(e)
                return
            finally:  # the thread that iterates a generator closes it
                close = getattr(it, "close", None)
                if close is not None:
                    close()
            q.put(_DONE)

    t = threading.Thread(target=worker, name=f"pypulsar-torch-{name}",
                         daemon=True)
    t.start()
    try:
        while True:
            try:
                item = q.get(timeout=deadline)
            except queue.Empty:
                telemetry.event("resilience.prefetch_timeout",
                                pipeline=name, timeout_s=deadline)
                raise TimeoutError(
                    f"prefetch {name!r}: producer delivered nothing for "
                    f"{deadline:.0f}s (worker "
                    f"{'alive' if t.is_alive() else 'dead'})") from None
            if item is _DONE:
                break
            if isinstance(item, BaseException):
                raise item
            if telemetry.is_active():
                telemetry.gauge(gauge_name, q.qsize())
            yield item
    finally:
        # an abandoned consumer: signal the worker and free a parked put
        stop.set()
        give_up = time.monotonic() + CLEANUP_DEADLINE_S
        while t.is_alive() and time.monotonic() < give_up:
            try:
                q.get_nowait()
            except queue.Empty:
                t.join(timeout=0.1)


def host_tensor(block: np.ndarray) -> torch.Tensor:
    """Host tensor over a native-dtype block (uint16 travels as int16,
    uint32 as int32, and is widened on the device)."""
    block = np.ascontiguousarray(block)
    if block.dtype == np.uint16:
        block = block.view(np.int16)
    elif block.dtype == np.uint32:
        block = block.view(np.int32)
    return torch.from_numpy(block)


_count_lock = threading.Lock()
#: the ship-ahead's prefetch name (its gauge and fault point prefix)
SHIP_NAME = "sweep.ship"


def ship(block, device: torch.device):
    """One host block (or a tuple of arrays) on ``device`` now, its bytes
    counted in ``ship_ahead.bytes`` when the device is a CUDA one: the
    single-block form of :func:`ship_ahead`, for random-access reads."""
    device = torch.device(device)
    parts = block if isinstance(block, tuple) else (block,)
    hosts = [host_tensor(b) for b in parts]
    if device.type == "cuda":
        count_shipped(sum(h.numel() * h.element_size() for h in hosts))
    devs = tuple(h.to(device) for h in hosts)
    return devs if isinstance(block, tuple) else devs[0]


def _copied(block):
    """A copy of a host block (or of each array of a tuple)."""
    if isinstance(block, tuple):
        return tuple(np.array(b) for b in block)
    return np.array(block)


def count_shipped(nbytes: int) -> None:
    """Count ``nbytes`` copied to a CUDA device in ``ship_ahead.bytes``
    and the ``h2d.bytes`` counter."""
    with _count_lock:
        ship_ahead.bytes += nbytes
    telemetry.counter("h2d.bytes", nbytes)


def ship_ahead(raw_blocks: Iterable, device: torch.device, depth: int = 2):
    """(pos, device tensor) for each (pos, host block), shipped ahead. A
    block may be a tuple of arrays (a PSRFITS block and its scales); it
    arrives as the tuple of their tensors. ``ship_ahead.bytes`` (and the
    ``h2d.bytes`` counter) count the bytes copied to a CUDA device (set it
    to 0 to start again). The worker's transform retries a transient read
    error twice; its fault point is ``sweep.ship.produce``.

    A block may be a buffer lent until the next one is pulled (a
    read-ahead ring's slot): the worker copies it, into pinned memory on
    a CUDA device and into a host tensor of its own on the CPU, before it
    pulls the next."""
    device = torch.device(device)
    if device.type != "cuda":
        yield from prefetch(raw_blocks, depth,
                            lambda it: (it[0], ship(_copied(it[1]), device)),
                            name=SHIP_NAME, retries=2)
        return
    side = torch.cuda.Stream(device)

    def ship_pinned(item):
        pos, block = item
        parts = block if isinstance(block, tuple) else (block,)
        hosts = [host_tensor(b).pin_memory() for b in parts]
        with torch.cuda.stream(side):
            devs = [h.to(device, non_blocking=True) for h in hosts]
            ready = torch.cuda.Event()
            ready.record(side)
        count_shipped(sum(h.numel() * h.element_size() for h in hosts))
        dev = tuple(devs) if isinstance(block, tuple) else devs[0]
        return pos, dev, ready, hosts

    current = torch.cuda.current_stream(device)
    pulled = prefetch(raw_blocks, depth, ship_pinned, name=SHIP_NAME,
                      retries=2)
    try:
        for pos, dev, ready, hosts in pulled:
            current.wait_event(ready)
            for d in (dev if isinstance(dev, tuple) else (dev,)):
                d.record_stream(current)
            del hosts  # the pinned buffers are the allocator's once copied
            yield pos, dev
    finally:  # an early stop ends the worker now
        pulled.close()


ship_ahead.bytes = 0
