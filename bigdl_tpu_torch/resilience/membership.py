"""Worker membership for elastic training (counterpart of
`bigdl_tpu/resilience/membership.py`).

- `WorkerRegistry`: lease-based membership. Each worker (a host, or a
  group of devices standing in for one) registers with a lease and
  renews it by heartbeat; `sweep()` expires stale leases. Losses and
  (re)joins emit `worker_lost` / `worker_joined` events carrying the
  fleet's `degraded_capacity`. The clock is injectable, so lease expiry
  is testable in virtual time.
- `DeviceLossError` / `CollectiveError`: the failures the elastic loop
  (`DistriOptimizer.set_elastic`) recovers from. Injected ones (the fault
  sites `mesh.device_loss` / `mesh.collective`) name the lost workers.
- `SimulatedCluster`: N logical workers over the local devices behind one
  registry, with `fail()` / `restore()` to script a preemption and the
  capacity coming back.

Device identity. A port device list may name one device several times
(`["cpu"] * 2` in the tests, four slots of `cuda:0` on one card), the
port's stand-in for the JAX tests' virtual CPU devices. Two slots of one
device must stay two workers, so a cluster never keys a worker on
`torch.device` equality: it wraps each entry of its device list in a
`Slot` (its index in the list and its `torch.device`), and every lookup
(`worker_for_device`, `mark_device_lost`, an `ElasticPlan`'s devices, the
elastic loop's lead) compares slots by identity. A registry filled by
hand may hold any objects as devices; it matches them by identity, then
by equality, as the reference's does.

`CollectiveError` here is the elastic vocabulary (a cross-device exchange
failed with no device proven dead: rebuild over the same devices and
replay), not `parallel.collectives.CollectiveError`, the failure of a
`torch.distributed` collective between processes, which the retry policy
classes as permanent.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

logger = logging.getLogger("bigdl_tpu_torch.resilience")


class DeviceLossError(RuntimeError):
    """A device (or the worker owning it) disappeared mid-step. `lost`
    names the lost workers (ids or devices) when known; empty means
    "probe to find out"."""

    def __init__(self, msg: str = "device lost", lost: Sequence = ()):
        super().__init__(msg)
        self.lost = tuple(lost)


class CollectiveError(RuntimeError):
    """A cross-device exchange failed without a proven device loss.
    Recoverable by rebuilding over the same devices and replaying the
    interrupted window."""


class Slot:
    """One entry of a cluster's device list: its position `index` and its
    `torch.device`. Equal only to itself, so that n slots of one device are
    n workers' devices."""

    __slots__ = ("index", "device")

    def __init__(self, index: int, device):
        self.index = int(index)
        self.device = torch.device(device)

    def __repr__(self):
        return f"Slot({self.index}, {self.device})"


class _Worker:
    __slots__ = ("worker_id", "devices", "lease_until", "alive", "meta")

    def __init__(self, worker_id, devices, lease_until, meta):
        self.worker_id = worker_id
        self.devices = list(devices)
        self.lease_until = lease_until
        self.alive = True
        self.meta = meta or {}


class WorkerRegistry:
    """Lease/heartbeat membership over a set of workers.

    Thread-safe; `clock` is any zero-argument float callable (default
    `time.monotonic`). Events, into `telemetry` when set:
    - `worker_joined` on `register` and on a heartbeat that revives a lost
      worker (`rejoined: true`); fields `worker`, `devices`, `alive`,
      `total`, `degraded_capacity`;
    - `worker_lost` on `mark_lost` or a lease expired in `sweep()`
      (`reason: "lease_expired"`), the same fields;
    - `worker_left` on `remove()` (a voluntary departure), the same fields.

    `alive_devices()` lists the alive workers' devices in registration
    order, so that a replan maps logical replicas onto the survivors
    deterministically."""

    def __init__(self, lease_s: float = 10.0,
                 clock: Optional[Callable[[], float]] = None,
                 telemetry=None):
        if lease_s <= 0:
            raise ValueError(f"lease_s must be > 0, got {lease_s}")
        self.lease_s = float(lease_s)
        self.clock = clock or time.monotonic
        self.telemetry = telemetry
        self._lock = threading.Lock()
        self._workers: Dict[str, _Worker] = {}  # in registration order

    def _event(self, kind: str, worker: _Worker, **extra):
        """One membership event, emitted outside the lock (a slow sink must
        not serialize the registry), with the fleet counts taken under
        it."""
        if self.telemetry is None:
            return
        with self._lock:
            alive = len(self._alive_unlocked())
            total = len(self._workers)
            degraded = self._degraded_unlocked()
        role = (worker.meta or {}).get("role")
        if role is not None:
            extra = {"role": role, **extra}
        try:
            self.telemetry.event(
                kind, worker=worker.worker_id,
                devices=len(worker.devices), alive=alive, total=total,
                degraded_capacity=degraded, **extra)
        except Exception:
            logger.exception("membership telemetry emit of %s failed", kind)

    # -- writes ---------------------------------------------------------------

    def register(self, worker_id: str, devices: Sequence = (),
                 meta: Optional[Dict] = None) -> "WorkerRegistry":
        """Add a worker with a fresh lease (registering again renews it)."""
        with self._lock:
            w = self._workers.get(worker_id)
            if w is None:
                w = _Worker(worker_id, devices, 0.0, meta)
                self._workers[worker_id] = w
            elif devices:
                w.devices = list(devices)
            w.alive = True
            w.lease_until = self.clock() + self.lease_s
        self._event("worker_joined", w, rejoined=False)
        return self

    def heartbeat(self, worker_id: str) -> bool:
        """Renew a worker's lease. A heartbeat from a lost worker revives
        it (`worker_joined` with `rejoined: true`); returns True then."""
        with self._lock:
            w = self._workers.get(worker_id)
            if w is None:
                raise KeyError(f"unknown worker {worker_id!r}")
            revived = not w.alive
            w.alive = True
            w.lease_until = self.clock() + self.lease_s
        if revived:
            self._event("worker_joined", w, rejoined=True)
        return revived

    def mark_lost(self, worker_id: str, reason: str = "observed failure"):
        """Declare a worker lost now (a failure proved it)."""
        with self._lock:
            w = self._workers.get(worker_id)
            if w is None:
                raise KeyError(f"unknown worker {worker_id!r}")
            was_alive = w.alive
            w.alive = False
        if was_alive:
            self._event("worker_lost", w, reason=reason)

    def mark_device_lost(self, device, reason: str = "observed failure"):
        """Declare the worker owning `device` lost; an unknown device is
        ignored (a probe may report devices outside the registry)."""
        wid = self.worker_for_device(device)
        if wid is not None:
            self.mark_lost(wid, reason=reason)

    def remove(self, worker_id: str) -> bool:
        """Deregister a worker (a voluntary departure, `worker_left`);
        True when it existed."""
        with self._lock:
            w = self._workers.pop(worker_id, None)
        if w is None:
            return False
        self._event("worker_left", w, reason="removed")
        return True

    def sweep(self) -> List[str]:
        """Expire stale leases; returns the newly lost worker ids."""
        now = self.clock()
        newly_lost = []
        with self._lock:
            for w in self._workers.values():
                if w.alive and w.lease_until < now:
                    w.alive = False
                    newly_lost.append(w)
        for w in newly_lost:
            self._event("worker_lost", w, reason="lease_expired")
        return [w.worker_id for w in newly_lost]

    # -- reads (under the lock: a heartbeat thread may revive a worker
    # while the training loop replans) ----------------------------------------

    def _alive_unlocked(self) -> List[str]:
        return [w.worker_id for w in self._workers.values() if w.alive]

    def _alive_devices_unlocked(self) -> List:
        return [d for w in self._workers.values() if w.alive
                for d in w.devices]

    def _total_devices_unlocked(self) -> int:
        return sum(len(w.devices) for w in self._workers.values())

    def _degraded_unlocked(self) -> float:
        total = self._total_devices_unlocked()
        if total == 0:
            return 0.0
        return round(1.0 - len(self._alive_devices_unlocked()) / total, 6)

    def alive(self) -> List[str]:
        """Alive worker ids, in registration order."""
        with self._lock:
            return self._alive_unlocked()

    def lost(self) -> List[str]:
        with self._lock:
            return [w.worker_id for w in self._workers.values()
                    if not w.alive]

    def alive_devices(self) -> List:
        """The alive workers' devices, in registration order."""
        with self._lock:
            return self._alive_devices_unlocked()

    def total_devices(self) -> int:
        with self._lock:
            return self._total_devices_unlocked()

    def worker_for_device(self, device) -> Optional[str]:
        """The worker holding `device`: the same object, else an equal
        one (a `Slot` equals only itself)."""
        with self._lock:
            for w in self._workers.values():
                if any(d is device for d in w.devices):
                    return w.worker_id
            for w in self._workers.values():
                if any(d == device for d in w.devices):
                    return w.worker_id
        return None

    def degraded_capacity(self) -> float:
        """The share of the registered devices currently lost: 0.0 is the
        whole fleet, 0.5 half of its devices gone."""
        with self._lock:
            return self._degraded_unlocked()

    def snapshot(self) -> Dict:
        """Each worker's liveness, devices and remaining lease, and the
        fleet's counts."""
        now = self.clock()
        with self._lock:
            return {
                "workers": {
                    w.worker_id: {
                        "alive": w.alive,
                        "devices": len(w.devices),
                        "lease_remaining_s": round(w.lease_until - now, 3),
                    } for w in self._workers.values()},
                "alive": len(self._alive_unlocked()),
                "total": len(self._workers),
                "degraded_capacity": self._degraded_unlocked(),
            }


class SimulatedCluster:
    """`n_workers` logical workers over `devices` (default: every CUDA
    device) behind one `WorkerRegistry`. Each entry of the device list
    becomes a `Slot` (see the module docstring), and the slots are split
    contiguously in worker order (worker0 gets the first chunk).
    `fail(w)` / `restore(w)` script a preemption and the capacity coming
    back; `shard(items, i, n)` is the `DistributedDataSet` interleaving
    (item k to worker k % n)."""

    def __init__(self, n_workers: int, devices: Optional[Sequence] = None,
                 lease_s: float = 1e9, clock=None, telemetry=None):
        if devices is None:
            from bigdl_tpu_torch._device import resolve_device
            resolve_device("cuda")  # raises without a CUDA device
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        slots = [Slot(i, d) for i, d in enumerate(devices)]
        if not 1 <= n_workers <= len(slots):
            raise ValueError(
                f"n_workers must be in [1, {len(slots)}], got {n_workers}")
        self.n_workers = n_workers
        self.registry = WorkerRegistry(lease_s=lease_s, clock=clock,
                                       telemetry=telemetry)
        per, extra = divmod(len(slots), n_workers)
        pos = 0
        #: worker id -> its slots
        self.assignment: Dict[str, List[Slot]] = {}
        for i in range(n_workers):
            k = per + (1 if i < extra else 0)
            wid = f"worker{i}"
            self.assignment[wid] = slots[pos:pos + k]
            self.registry.register(wid, slots[pos:pos + k])
            pos += k

    def workers(self) -> List[str]:
        return list(self.assignment)

    def devices(self) -> List[Slot]:
        """Every slot of the cluster, in worker order."""
        return [d for ds in self.assignment.values() for d in ds]

    def fail(self, worker_id: str, reason: str = "simulated preemption"):
        self.registry.mark_lost(worker_id, reason=reason)

    def restore(self, worker_id: str) -> bool:
        return self.registry.heartbeat(worker_id)

    @staticmethod
    def shard(items: Sequence, worker_index: int, n_workers: int) -> List:
        """The `DistributedDataSet` interleaving for one worker."""
        return [x for i, x in enumerate(items)
                if i % n_workers == worker_index]
