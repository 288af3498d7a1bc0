"""Retry policies: exponential backoff with full jitter, a wall-clock
budget, and transient-vs-permanent classification (counterpart of
`bigdl_tpu/resilience/retry.py`; the same delays for the same seed).

`DistriOptimizer`'s retry loop and the remote filesystem IO use it. A
failed collective (`parallel.collectives.CollectiveError`, and
`torch.distributed`'s own errors) is permanent: a peer that died or
timed out is gone, and no rank retries into it. A
seeded policy replays its jitter sequence; `sleep=` observes or elides
the sleeping (tests run a 5-retry schedule in microseconds).
"""

from __future__ import annotations

import logging
import random
import time
from typing import Callable, Optional, Tuple, Type

import torch.distributed as dist

from bigdl_tpu_torch.parallel.collectives import CollectiveError
from bigdl_tpu_torch.resilience.faults import (PermanentInjectedFault,
                                               TransientInjectedFault)

logger = logging.getLogger("bigdl_tpu_torch.resilience")

#: retried by default: failures a later attempt can plausibly survive
DEFAULT_TRANSIENT: Tuple[Type[BaseException], ...] = (
    OSError, TimeoutError, TransientInjectedFault)

#: never retried: deterministic program errors, which fail the same way
#: on every attempt, and failed collectives (a peer is gone)
DEFAULT_PERMANENT: Tuple[Type[BaseException], ...] = (
    TypeError, ValueError, KeyError, IndexError, AttributeError,
    ZeroDivisionError, AssertionError, NotImplementedError,
    PermanentInjectedFault, CollectiveError, dist.DistError)


class RetryBudgetExhausted(RuntimeError):
    """The policy's backoff budget ran out before an attempt succeeded
    (raised by `call`, with the last failure as `__cause__`)."""


class RetryPolicy:
    """Backoff and classification policy.

    max_retries : retries after the first attempt (5: up to 6 attempts).
    base_delay_s / max_delay_s : retry k (1-based) sleeps
        `uniform(0, min(max_delay_s, base_delay_s * 2**(k-1)))`.
    budget_s : optional cap on the total backoff slept in one `call` (or
        one caller-managed loop).
    transient / permanent : exception-type tuples; permanent wins.
    classify : optional `exc -> bool | None`, consulted first: True forces
        transient, False permanent, None falls through to the tuples.
    unknown_transient : the class of an exception in neither tuple (True:
        retry, as the reference's retry-everything loop does).
    seed : seeds the jitter rng.
    sleep : the sleep function.
    telemetry : a `Telemetry` (or any object with `event(kind,
        **fields)`) that gets a `retry` event a retry, or None.
    """

    def __init__(self, max_retries: int = 5, base_delay_s: float = 0.1,
                 max_delay_s: float = 30.0,
                 budget_s: Optional[float] = None,
                 transient: Tuple[Type[BaseException], ...] =
                 DEFAULT_TRANSIENT,
                 permanent: Tuple[Type[BaseException], ...] =
                 DEFAULT_PERMANENT,
                 classify: Optional[Callable[[BaseException],
                                             Optional[bool]]] = None,
                 unknown_transient: bool = True,
                 seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 telemetry=None, name: str = "retry"):
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if base_delay_s < 0 or max_delay_s < 0:
            raise ValueError("delays must be >= 0")
        self.max_retries = int(max_retries)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.budget_s = budget_s
        self.transient = tuple(transient)
        self.permanent = tuple(permanent)
        self.classify = classify
        self.unknown_transient = bool(unknown_transient)
        self._rng = random.Random(seed)
        self.sleep = sleep
        self.telemetry = telemetry
        self.name = name

    def is_transient(self, exc: BaseException) -> bool:
        """True when a later attempt could succeed: `classify` first, then
        the permanent tuple, then the transient one."""
        if self.classify is not None:
            verdict = self.classify(exc)
            if verdict is not None:
                return bool(verdict)
        if isinstance(exc, self.permanent):
            return False
        if isinstance(exc, self.transient):
            return True
        return self.unknown_transient

    def delay_s(self, attempt: int) -> float:
        """Full-jitter backoff for retry `attempt` (1-based)."""
        if attempt < 1:
            raise ValueError(f"attempt must be >= 1, got {attempt}")
        cap = min(self.max_delay_s,
                  self.base_delay_s * (2.0 ** (attempt - 1)))
        return self._rng.uniform(0.0, cap)

    def next_delay(self, attempt: int, spent_s: float = 0.0,
                   exc: Optional[BaseException] = None) -> Optional[float]:
        """The backoff before retry `attempt` (1-based) of a caller-managed
        loop, or None to stop (a permanent error, retries used up, or the
        budget gone). `spent_s` is the backoff already slept."""
        if exc is not None and not self.is_transient(exc):
            return None
        if attempt > self.max_retries:
            return None
        delay = self.delay_s(attempt)
        if self.budget_s is not None and spent_s + delay > self.budget_s:
            return None
        return delay

    def call(self, fn: Callable, *args, **kwargs):
        """`fn(*args, **kwargs)`, retrying transient failures. A permanent
        failure re-raises at once; a blown budget raises
        `RetryBudgetExhausted` from the last failure."""
        attempt = 0
        spent = 0.0
        while True:
            try:
                return fn(*args, **kwargs)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                attempt += 1
                delay = self.next_delay(attempt, spent, e)
                if delay is None:
                    if self.is_transient(e) and self.budget_s is not None \
                            and attempt <= self.max_retries:
                        raise RetryBudgetExhausted(
                            f"{self.name}: backoff budget "
                            f"{self.budget_s}s exhausted after "
                            f"{attempt - 1} retries") from e
                    raise
                logger.warning("%s: attempt %d failed (%r); backing off "
                               "%.3fs", self.name, attempt, e, delay)
                if self.telemetry is not None:
                    try:
                        self.telemetry.event(
                            "retry", policy=self.name, attempt=attempt,
                            delay_s=round(delay, 6), error=repr(e),
                            transient=True)
                    except Exception:
                        logger.exception("retry telemetry emit failed")
                spent += delay
                if delay > 0:
                    self.sleep(delay)
