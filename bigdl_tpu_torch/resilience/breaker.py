"""Circuit breaker (counterpart of `bigdl_tpu/resilience/breaker.py`):
trip on consecutive failures, shed while open, recover through half-open
probes.

After `failure_threshold` consecutive failures the circuit OPENS and
callers are refused at once; after `reset_timeout_s` it goes HALF-OPEN
and admits one probe at a time; `probe_successes` probe successes CLOSE
it again, one probe failure re-opens it. The class knows nothing of
serving (the serving engines key one per batch bucket) and is thread
safe. The clock is injectable, so tests drive the state machine without
sleeping.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional

logger = logging.getLogger("bigdl_tpu_torch.resilience")

#: state constants (strings so snapshots are JSON-safe)
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Consecutive-failure circuit breaker with half-open probing.

    Protocol: call `allow()` before attempting the guarded operation —
    False means shed (fast-fail) without attempting; then report the
    outcome with `record_success()` / `record_failure()`.

    Parameters
    ----------
    failure_threshold : consecutive failures (while closed) that trip
        the circuit open.
    reset_timeout_s : how long an open circuit refuses everything before
        moving to half-open on the next `allow()`.
    probe_successes : successful probes required to close from half-open.
    clock : monotonic time source (injectable for tests).
    on_transition : optional callback `(old_state, new_state, breaker)`
        fired OUTSIDE the lock on every state change — the serving engine
        hangs its `circuit_open`/`circuit_close` telemetry here.
    name : label carried into snapshots and transitions.
    """

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0, probe_successes: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable] = None,
                 name: str = ""):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        if probe_successes < 1:
            raise ValueError(
                f"probe_successes must be >= 1, got {probe_successes}")
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self.probe_successes = int(probe_successes)
        self.clock = clock
        self.on_transition = on_transition
        self.name = name
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._probe_ok = 0
        self._probe_inflight = False
        self._opened_at: Optional[float] = None
        self._n_open = 0      # times tripped open (lifetime)
        self._n_shed = 0      # allow() calls refused

    # ------------------------------------------------------------ queries
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def snapshot(self) -> Dict:
        """JSON-safe state dump for `health()` surfaces and tests."""
        with self._lock:
            snap = {"state": self._state,
                    "consecutive_failures": self._consecutive_failures,
                    "times_opened": self._n_open,
                    "shed": self._n_shed}
            if self._state == OPEN and self._opened_at is not None:
                snap["open_for_s"] = round(
                    max(0.0, self.clock() - self._opened_at), 3)
            if self.name:
                snap["name"] = self.name
            return snap

    # ----------------------------------------------------------- protocol
    def allow(self) -> bool:
        """May the guarded operation run now? Open circuits refuse until
        `reset_timeout_s` elapses, then admit exactly ONE in-flight probe
        at a time (half-open); closed circuits always admit."""
        fire = None
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self.clock() - self._opened_at < self.reset_timeout_s:
                    self._n_shed += 1
                    return False
                fire = (OPEN, HALF_OPEN)
                self._set_unlocked(HALF_OPEN)
            # half-open: one probe in flight at a time
            if self._probe_inflight:
                self._n_shed += 1
                admitted = False
            else:
                self._probe_inflight = True
                admitted = True
        if fire is not None:
            self._fire(*fire)
        return admitted

    def record_success(self, probe: Optional[bool] = None):
        """Report a successful guarded operation. `probe` says whether
        this outcome belongs to a call admitted while HALF-OPEN (the
        caller knows: it observed the state right after `allow()`);
        pass False for calls that were in flight BEFORE the trip so
        their stale outcomes cannot close the circuit or consume the
        live probe's slot. None keeps the legacy behavior (any outcome
        in half-open counts as the probe's)."""
        fire = None
        with self._lock:
            self._consecutive_failures = 0
            if self._state == HALF_OPEN and probe is not False:
                self._probe_inflight = False
                self._probe_ok += 1
                if self._probe_ok >= self.probe_successes:
                    fire = (HALF_OPEN, CLOSED)
                    self._set_unlocked(CLOSED)
        if fire is not None:
            self._fire(*fire)

    def record_failure(self, probe: Optional[bool] = None):
        """Report a failed guarded operation (`probe` as in
        `record_success`: False = a stale pre-trip call's outcome, which
        must not re-trip a half-open circuit)."""
        fire = None
        with self._lock:
            if self._state == HALF_OPEN:
                if probe is False:
                    return  # stale pre-trip outcome: not probe evidence
                # the probe failed: straight back to open, timer restarted
                self._probe_inflight = False
                fire = (HALF_OPEN, OPEN)
                self._trip_unlocked()
            elif self._state == CLOSED:
                self._consecutive_failures += 1
                if self._consecutive_failures >= self.failure_threshold:
                    fire = (CLOSED, OPEN)
                    self._trip_unlocked()
            # already open: outcome of an in-flight call from before the
            # trip — nothing changes
        if fire is not None:
            self._fire(*fire)

    # ------------------------------------------------------------ internal
    def _set_unlocked(self, state: str):
        self._state = state
        if state == HALF_OPEN:
            self._probe_ok = 0
            self._probe_inflight = False
        elif state == CLOSED:
            self._consecutive_failures = 0
            self._opened_at = None

    def _trip_unlocked(self):
        self._state = OPEN
        self._opened_at = self.clock()
        self._consecutive_failures = 0
        self._n_open += 1

    def _fire(self, old: str, new: str):
        if self.on_transition is not None:
            try:
                self.on_transition(old, new, self)
            except Exception:  # a callback must not break the protocol
                logger.exception("circuit-breaker transition callback failed")
