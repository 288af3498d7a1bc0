"""Fault injection and recovery (counterpart of `bigdl_tpu.resilience`).

- `faults`: the seeded `FaultInjector` and the sites the port instruments.
- `retry`: `RetryPolicy`.
- `breaker`: `CircuitBreaker`, tripped by consecutive failures, shedding
  while open, recovering through half-open probes; the serving engines
  key one per batch bucket.
- `membership`: `WorkerRegistry` (leases, heartbeats, an injectable
  clock), `SimulatedCluster`, the `Slot`s that give repeated devices an
  identity each, and `DeviceLossError` / `CollectiveError`.
- `elastic`: `ElasticController`, survivors to a training shape and the
  replay boundary; `DistriOptimizer.set_elastic` turns it into shrink,
  replay and grow.
- `preemption`: `PreemptionHandler`, SIGTERM to a checkpoint, a drain and
  a clean `run_abort`, the previous disposition restored."""

from bigdl_tpu_torch.resilience.breaker import (CLOSED, HALF_OPEN, OPEN,
                                                CircuitBreaker)
from bigdl_tpu_torch.resilience.elastic import (ElasticController,
                                                ElasticPlan,
                                                InsufficientCapacityError)
from bigdl_tpu_torch.resilience.faults import (KNOWN_SITES, FaultInjector,
                                               FaultSpec, InjectedFault,
                                               PermanentInjectedFault,
                                               TransientInjectedFault,
                                               active_injector, fire,
                                               known_sites, register_site)
from bigdl_tpu_torch.resilience.membership import (CollectiveError,
                                                   DeviceLossError,
                                                   SimulatedCluster, Slot,
                                                   WorkerRegistry)
from bigdl_tpu_torch.resilience.preemption import (PreemptedError,
                                                   PreemptionHandler)
from bigdl_tpu_torch.resilience.retry import (DEFAULT_PERMANENT,
                                              DEFAULT_TRANSIENT,
                                              RetryBudgetExhausted,
                                              RetryPolicy)

__all__ = ["FaultInjector", "FaultSpec", "fire", "active_injector",
           "register_site", "known_sites", "InjectedFault",
           "TransientInjectedFault", "PermanentInjectedFault",
           "RetryPolicy", "RetryBudgetExhausted", "CircuitBreaker",
           "WorkerRegistry", "SimulatedCluster", "Slot", "DeviceLossError",
           "CollectiveError", "ElasticController", "ElasticPlan",
           "InsufficientCapacityError", "PreemptionHandler",
           "PreemptedError"]
