"""Fault injection and recovery (counterpart of `bigdl_tpu.resilience`).
Ported: `faults` (the seeded `FaultInjector` and the sites the port
instruments) and `retry` (`RetryPolicy`). The circuit breaker, elastic
membership and preemption are not ported yet."""

from bigdl_tpu_torch.resilience.faults import (KNOWN_SITES, FaultInjector,
                                               FaultSpec, InjectedFault,
                                               PermanentInjectedFault,
                                               TransientInjectedFault,
                                               active_injector, fire,
                                               known_sites, register_site)
from bigdl_tpu_torch.resilience.retry import (DEFAULT_PERMANENT,
                                              DEFAULT_TRANSIENT,
                                              RetryBudgetExhausted,
                                              RetryPolicy)

__all__ = ["FaultInjector", "FaultSpec", "fire", "active_injector",
           "register_site", "known_sites", "InjectedFault",
           "TransientInjectedFault", "PermanentInjectedFault",
           "RetryPolicy", "RetryBudgetExhausted"]
