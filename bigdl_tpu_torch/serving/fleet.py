"""Replicated serving fleet (counterpart of `bigdl_tpu/serving/fleet.py`):
membership-driven routing, drain and re-route on replica loss, and
autoscaling.

- N serving replicas (`InferenceEngine`s by default, any engine through
  `engine_factory`), each a worker of a `resilience.membership.
  WorkerRegistry` with a lease renewed by heartbeat (`ServingFleet.
  maintain` is the heartbeat and sweep tick);
- a `Router` dispatching by each replica's `health()` (per-bucket breaker
  state, queue depth): consistent-hash session affinity for keyed traffic
  (`_HashRing`: blake2b, 64 virtual nodes a replica, the reference's walk
  for the same key) and power-of-two choices for the rest;
- an `AutoscalePolicy` growing and shrinking the replica set off p99
  latency, queue depth and shed rate.

A replica that misses its lease (or crashes through the
`serve.replica_crash` fault site, or `fail()`) is drained: its in-flight
futures get `drain_grace_s` to finish, what is still unresolved after the
grace is re-routed exactly once (idempotent requests re-submit to a
survivor with their deadline budget decremented; non-idempotent ones, and
ones re-routed once already, fail with `ServingReroutedError`), and a
replica restored with `restore()` is re-warmed before it re-enters the
rotation. Every accepted request so resolves to a result, a deadline
timeout or `ServingReroutedError`, exactly once: the caller's future is
not the replica engine's, and the router resolves it once. Scale-down
retires a replica by voluntary drain (out of the rotation, its queue
served, then deregistered), so autoscaling drops no accepted work.
`FleetTokenStream` carries a generation stream over the fleet: when its
replica is lost it restarts from the prompt on a survivor and skips the
tokens already delivered (greedy decode gives the same tokens).

Fault sites, registered with `register_site` on import:

    serve.replica_crash   fired per active replica in `maintain()`; a
                          raise kills that replica (mark_lost + crash
                          drain), as a lost lease does
    serve.route           fired per routing attempt in `submit()`; a
                          transient raise fails one routing decision (the
                          router retries), a permanent one surfaces
    serve.drain           fired at drain start; a raise collapses the
                          grace window to zero (the drain itself goes on)

Observability: the registry's `worker_lost` / `worker_joined` /
`worker_left` events, a `serving_fleet` record (replicas alive and
draining, reroute and scale counters, per-replica queue depth), one
`replica_drained` event a drain, each replica's `trace` records with its
`replica_id`, one `fleet_request` / `fleet_generate` trace record for
each outcome the router decided, and with `trace=True` one `SpanTracer`
process lane a replica, merged by `export_trace()` into one Perfetto
file. A replica builds on the fleet's device through `engine_kwargs`
(`{"device": "cpu"}` on the CPU); a replica that fails to build closes
the ones that did and raises, the fleet never serves on fewer.
"""

from __future__ import annotations

import bisect
import functools
import hashlib
import inspect
import logging
import random
import threading
import time
import weakref
from concurrent.futures import wait as _futures_wait
from typing import Callable, Dict, Iterator, List, Optional, Set

from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.resilience.membership import WorkerRegistry
from bigdl_tpu_torch.resilience.retry import RetryPolicy
from bigdl_tpu_torch.serving.engine import (EngineClosedError,
                                            InferenceEngine,
                                            QueueFullError, ServingError,
                                            ServingTimeoutError,
                                            ServingUnavailableError,
                                            _resolve)

logger = logging.getLogger("bigdl_tpu_torch.serving")

#: Fleet fault sites — registered here (not in faults.KNOWN_SITES) as the
#: reference use of the out-of-tree `register_site` path, so `FaultSpec`
#: accepts them the moment this module imports.
SITE_REPLICA_CRASH = faults.register_site("serve.replica_crash")
SITE_ROUTE = faults.register_site("serve.route")
SITE_DRAIN = faults.register_site("serve.drain")

#: Replica lifecycle states.
WARMING = "warming"
ACTIVE = "active"
DRAINING = "draining"
LOST = "lost"
RETIRED = "retired"


class ServingReroutedError(ServingError):
    """This request's replica was drained and the request could NOT be
    transparently re-routed — it is non-idempotent, it was already
    re-routed once (exactly-once contract), or no healthy replica
    remained. The fleet will never RE-submit it after this error, but —
    the standard distributed-timeout uncertainty — the abandoned replica
    may or may not have executed it before dying (any late result is
    discarded). Callers holding an idempotent request may safely
    resubmit; callers holding a non-idempotent one must decide with
    their own dedup key."""


def default_router_policy(max_retries: int = 2, **kw) -> RetryPolicy:
    """The router's default failure classification: shed-shaped serving
    errors are TRANSIENT (they prove the *replica* is unhealthy, not the
    request — `ServingUnavailableError` = open breaker shed without a
    forward, `ServingTimeoutError` = lapsed in a queue, `QueueFullError`
    and `EngineClosedError` = replica full/closing), so they trigger a
    re-route instead of a caller-visible failure. Any other
    `ServingError` (a batch forward actually failed) is PERMANENT —
    a deterministic model error must surface on attempt 1, never burn
    re-routes. Unknown exception types are permanent (`unknown_transient
    =False`): a router that retries everything hides real bugs."""
    def _classify(exc: BaseException) -> Optional[bool]:
        if isinstance(exc, (ServingUnavailableError, ServingTimeoutError,
                            QueueFullError, EngineClosedError)):
            return True
        if isinstance(exc, ServingError):
            return False
        return None

    kw.setdefault("base_delay_s", 0.0)
    kw.setdefault("name", "router")
    return RetryPolicy(max_retries=max_retries, classify=_classify,
                       unknown_transient=False, **kw)


def _status_of(exc: BaseException) -> str:
    """Trace-record status for a caller-visible failure — shared by the
    admission and completion paths so their SLO records cannot drift."""
    if isinstance(exc, ServingTimeoutError):
        return "timeout"
    if isinstance(exc, (ServingUnavailableError, QueueFullError)):
        return "shed"
    return "error"


class _HashRing:
    """Consistent-hash ring with virtual nodes — session affinity that
    stays STABLE across scale events: adding/removing one replica moves
    only ~1/N of the sessions (the classic consistent-hashing property,
    asserted in tests/test_fleet.py). Hashing is blake2b, not `hash()`,
    so placement is deterministic across processes and
    PYTHONHASHSEED."""

    def __init__(self, vnodes: int = 64):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = vnodes
        self._points: List = []  # sorted (hash, replica_id)

    @staticmethod
    def _hash(key: str) -> int:
        return int.from_bytes(
            hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(),
            "big")

    def add(self, replica_id: str):
        for v in range(self.vnodes):
            bisect.insort(self._points,
                          (self._hash(f"{replica_id}#{v}"), replica_id))

    def remove(self, replica_id: str):
        self._points = [(h, r) for h, r in self._points
                        if r != replica_id]

    def walk(self, key: str) -> Iterator[str]:
        """Distinct replica ids in ring order starting at `key`'s point —
        the first yielded id is the session's home; the rest are the
        deterministic fallback order while the home is unhealthy."""
        if not self._points:
            return
        i = bisect.bisect_left(self._points, (self._hash(key), ""))
        seen: Set[str] = set()
        n = len(self._points)
        for k in range(n):
            _, rid = self._points[(i + k) % n]
            if rid not in seen:
                seen.add(rid)
                yield rid


class AutoscalePolicy:
    """Grow/shrink decision off the fleet's live signals (serving p99
    latency, queue depth, shed rate, from the replicas' `stats()`),
    evaluated at `maintain()` cadence.

    Scale UP (+1) when any pressure signal breaches: aggregate p99
    latency above `p99_high_ms`, mean queue depth per replica above
    `queue_high`, or shed rate (breaker sheds PLUS admission rejections
    over the last window's traffic — fleet replicas reject-on-full, so
    overload surfaces as rejections) above `shed_high`. Scale DOWN (-1) only when EVERY quiet signal
    holds: queue depth per replica below `queue_low`, nothing shed in
    the window, and p99 under half the ceiling. One step per decision,
    bounded by [min_replicas, max_replicas], with a `cooldown_s`
    refractory period (injectable clock) so a scale event's own
    transient (warmup, drain) cannot trigger the next one."""

    def __init__(self, min_replicas: int = 1, max_replicas: int = 8,
                 p99_high_ms: Optional[float] = None,
                 queue_high: float = 8.0, shed_high: float = 0.01,
                 queue_low: float = 0.5, cooldown_s: float = 30.0,
                 clock: Optional[Callable[[], float]] = None):
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"[{min_replicas}, {max_replicas}]")
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.p99_high_ms = p99_high_ms
        self.queue_high = queue_high
        self.shed_high = shed_high
        self.queue_low = queue_low
        self.cooldown_s = cooldown_s
        self.clock = clock or time.monotonic
        self._last_scale_t = self.clock()

    def decide(self, signals: Dict, n_replicas: int) -> int:
        """-1 / 0 / +1 given `signals` (`p99_ms`, `queue_depth`,
        `shed_rate` — None means "no data", which never scales)."""
        now = self.clock()
        if now - self._last_scale_t < self.cooldown_s:
            return 0
        p99 = signals.get("p99_ms")
        depth = signals.get("queue_depth")
        shed = signals.get("shed_rate")
        per_rep = depth / max(1, n_replicas) if depth is not None else None
        up = ((self.p99_high_ms is not None and p99 is not None
               and p99 > self.p99_high_ms)
              or (per_rep is not None and per_rep > self.queue_high)
              or (shed is not None and shed > self.shed_high))
        if up and n_replicas < self.max_replicas:
            self._last_scale_t = now
            return 1
        down = (not up and n_replicas > self.min_replicas
                and per_rep is not None and per_rep < self.queue_low
                and (shed is None or shed <= 0.0)
                and (self.p99_high_ms is None or p99 is None
                     or p99 < self.p99_high_ms / 2))
        if down:
            self._last_scale_t = now
            return -1
        return 0


class FleetTokenStream:
    """Caller-facing generation stream over the fleet: pulls from a
    replica-pinned `GenerationEngine` TokenStream, transparently
    RESTARTING FROM THE PROMPT on a survivor when the pinned replica is
    lost.

    A decode stream is STATEFUL — its per-slot KV cache lives on one
    replica — so replica loss cannot transparently migrate it the way a
    one-shot request re-routes. But greedy decode is deterministic: the
    restarted stream re-produces the SAME token sequence, and this
    wrapper's index-based pulls (`get(i)`) consume the dead replica's
    delivered prefix from its buffer, then read position `i` onward from
    the survivor's fresh stream — exactly-once token delivery, no gap,
    no duplicate. Idempotent-only: a non-idempotent stream (or one past
    `max_reroutes`) fails with `ServingReroutedError` instead, because
    the dead replica may have produced (and a side effect consumed)
    tokens the caller never saw.
    """

    def __init__(self, fleet: "ServingFleet", prompt, session,
                 idempotent: bool, gen_kwargs: Dict,
                 deadline_ms: Optional[float] = None):
        self._fleet = fleet
        self._prompt = prompt
        self._session = session
        self._idempotent = idempotent
        self._kw = gen_kwargs
        self._excluded: Set[str] = set()
        self.reroutes = 0
        self.replica_id: Optional[str] = None
        self._stream = None
        self.t_submit = time.perf_counter()
        # ONE absolute deadline for the stream's whole fleet life: a
        # re-route passes the REMAINING budget, never a fresh one
        self._deadline = self.t_submit + deadline_ms / 1e3 \
            if deadline_ms is not None else None
        self._failure_traced = False
        try:
            self._attach()
        except Exception as e:
            # a synchronous admission failure is caller-visible: the
            # trace stream must see it (no engine record is coming)
            self._trace_failure(_status_of(e), e)
            raise
        with fleet._lock:
            fleet._generations_total += 1

    def _attach(self):
        """Start (or restart) the stream on a routable replica. Like
        `Router._route`: a replica whose admission fails shed-shaped
        (full queue, closing, open breaker) is excluded and the next
        attempt tries another, up to `route_attempts`."""
        deadline_ms = None
        if self._deadline is not None:
            deadline_ms = (self._deadline - time.perf_counter()) * 1e3
            if deadline_ms <= 0:
                raise ServingTimeoutError(
                    "deadline lapsed before the generation stream "
                    "reached a replica")
        tried: Set[str] = set(self._excluded)
        last_exc: Optional[BaseException] = None
        for _ in range(self._fleet.router.route_attempts):
            rep = self._fleet.router._pick(self._session, tried)
            gen = getattr(rep.engine, "generate", None)
            if gen is None:
                raise ServingError(
                    f"replica {rep.replica_id} does not support "
                    "generation — build the fleet with an "
                    "engine_factory returning GenerationEngine replicas")
            try:
                self._stream = gen(self._prompt, deadline_ms=deadline_ms,
                                   **self._kw)
            except (QueueFullError, EngineClosedError,
                    ServingUnavailableError) as e:
                tried.add(rep.replica_id)
                last_exc = e
                continue
            self.replica_id = rep.replica_id
            return
        raise last_exc if last_exc is not None else \
            ServingUnavailableError("no routable replica")

    def _reroute(self, cause: BaseException):
        if self.replica_id is not None:
            self._excluded.add(self.replica_id)
        self.reroutes += 1
        try:
            self._attach()
        except Exception as e:
            err = ServingReroutedError(
                "generation stream lost its replica and could not "
                f"restart on a survivor: {e!r}")
            err.__cause__ = cause
            self._trace_failure(_status_of(err), err)
            raise err from cause
        with self._fleet._lock:
            self._fleet._stream_reroutes_total += 1
        self._fleet._event("stream_rerouted", replica=self.replica_id,
                           reroutes=self.reroutes)

    def _recoverable(self, exc: BaseException) -> bool:
        return (self._idempotent
                and self.reroutes < self._fleet.router.max_reroutes
                and self._fleet.router.retry_policy.is_transient(exc))

    def _trace_failure(self, status: str, exc: BaseException):
        """ONE caller-visible `fleet_generate` trace per surfaced
        failure (repeated get() calls re-raise without re-counting)."""
        if self._failure_traced:
            return
        self._failure_traced = True
        self._fleet._trace_outcome(self, status, error=repr(exc),
                                   kind="fleet_generate")

    def get(self, i: int, timeout: Optional[float] = None):
        """Token `i` (blocking), or None when the stream finished OK
        with fewer tokens — restarting on a survivor when the pinned
        replica died before producing it."""
        while True:
            try:
                return self._stream.get(i, timeout)
            except ServingTimeoutError as e:
                # a client-side wait timeout (the stream itself is
                # fine) or a replica queue-deadline lapse: neither is a
                # replica loss, so neither re-routes; only the
                # stream-fatal lapse is a caller-visible outcome
                if self._stream.done:
                    self._trace_failure("timeout", e)
                raise
            except Exception as e:
                if not self._recoverable(e):
                    if self._fleet.router.retry_policy.is_transient(e) \
                            and not isinstance(e, ServingReroutedError):
                        err = ServingReroutedError(
                            f"generation stream on replica "
                            f"{self.replica_id} was lost and was not "
                            f"re-routed: "
                            f"{'already re-routed once' if self.reroutes else 'non-idempotent' if not self._idempotent else 'not recoverable'}")
                        err.__cause__ = e
                        self._trace_failure(_status_of(err), err)
                        raise err from e
                    self._trace_failure(_status_of(e), e)
                    raise
                self._reroute(e)

    def cancel(self):
        """Cancel the CURRENT backing stream (frees its decode slot)."""
        if self._stream is not None:
            self._stream.cancel()

    @property
    def done(self) -> bool:
        """True once no further tokens will EVER arrive: the backing
        stream finished OK, or failed UNRECOVERABLY. A backing failure
        the next `get()` would transparently restart from (replica loss
        on an idempotent stream with re-route budget) is NOT done."""
        st = self._stream
        if st is None or not st.done:
            return False
        if st.status == "ok":
            return True
        exc = st.error
        return exc is None or not self._recoverable(exc)

    def __iter__(self):
        i = 0
        while True:
            tok = self.get(i)
            if tok is None:
                return
            yield tok
            i += 1

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block for completion; returns ALL tokens (re-routes included,
        exactly once each)."""
        deadline = time.monotonic() + timeout if timeout is not None \
            else None
        out: List[int] = []
        while True:
            wait = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            tok = self.get(len(out), wait)
            if tok is None:
                return out
            out.append(tok)


class _FleetRequest:
    """One caller-facing request: the router's future is distinct from
    whichever replica engine future currently backs it, so a re-route
    swaps the backing without the caller noticing, and the outcome is
    resolved exactly once."""

    __slots__ = ("sample", "future", "deadline", "idempotent", "session",
                 "reroutes", "replica_id", "engine_future", "t_submit")

    def __init__(self, sample, deadline: Optional[float],
                 idempotent: bool, session):
        from concurrent.futures import Future
        self.sample = sample
        self.future = Future()
        self.deadline = deadline  # absolute perf_counter seconds, or None
        self.idempotent = idempotent
        self.session = session
        self.reroutes = 0
        self.replica_id: Optional[str] = None
        self.engine_future = None
        self.t_submit = time.perf_counter()

    def remaining_ms(self) -> Optional[float]:
        """Deadline budget left (the original budget decremented by time
        already spent) — what a re-submit passes as `deadline_ms`."""
        if self.deadline is None:
            return None
        return (self.deadline - time.perf_counter()) * 1e3


class _Replica:
    __slots__ = ("replica_id", "engine", "state", "outstanding",
                 "health_cache", "tracer", "warmups", "accepts_session")

    def __init__(self, replica_id: str, engine, tracer=None):
        self.replica_id = replica_id
        self.engine = engine
        self.state = WARMING
        self.outstanding: Set[_FleetRequest] = set()  # under fleet lock
        self.health_cache: Optional[Dict] = None
        self.tracer = tracer
        self.warmups = 0
        # whether engine.submit takes session= — probed ONCE here, not
        # per request, because `engine_factory` doubles (tests, remote
        # shims) predate the kwarg and a TypeError mid-route would read
        # as a replica failure
        self.accepts_session = _submit_accepts_session(engine)


def _submit_accepts_session(engine) -> bool:
    try:
        params = inspect.signature(engine.submit).parameters
    except (TypeError, ValueError):
        return False
    return ("session" in params
            or any(p.kind is p.VAR_KEYWORD for p in params.values()))


class Router:
    """Dispatch front-end over a `ServingFleet`'s replica table.

    Routing order per request: the `serve.route` fault site fires, then

    - `session=` traffic walks the consistent-hash ring from the
      session's point and takes the first ACTIVE replica — the same
      session lands on the same replica while it lives, and on a
      deterministic fallback while it doesn't,
    - unaffinitized traffic uses power-of-two-choices: two random ACTIVE
      replicas, the less loaded wins. Load is (degraded?, outstanding +
      queue depth) — "degraded" (any open breaker bucket, from the
      cached `health()` snapshot `maintain()` refreshes) loses to
      healthy regardless of depth, so a replica shedding one bucket
      drains its share of traffic toward clean replicas before the
      breaker error even fires.

    A routing attempt that fails shed-shaped (`QueueFullError`,
    `EngineClosedError`, open-breaker `ServingUnavailableError` raised
    at submit) excludes that replica and retries, up to
    `route_attempts`. Failures AFTER dispatch come back through the
    engine future: the `retry_policy` classifies them, transient ones
    re-route (at most `max_reroutes` times per request — default 1, the
    exactly-once contract shared with drain), permanent ones surface on
    attempt 1 untouched.
    """

    def __init__(self, fleet: "ServingFleet",
                 retry_policy: Optional[RetryPolicy] = None,
                 max_reroutes: int = 1, route_attempts: int = 3,
                 vnodes: int = 64, seed: int = 0):
        if max_reroutes < 0:
            raise ValueError(
                f"max_reroutes must be >= 0, got {max_reroutes}")
        if route_attempts < 1:
            raise ValueError(
                f"route_attempts must be >= 1, got {route_attempts}")
        self.fleet = fleet
        self.retry_policy = retry_policy or default_router_policy()
        self.max_reroutes = max_reroutes
        self.route_attempts = route_attempts
        self.ring = _HashRing(vnodes=vnodes)
        self._rng = random.Random(seed)
        # counters, under the fleet lock
        self.routed_total = 0
        self.affinity_routes_total = 0
        self.reroutes_total = 0
        self.reroute_failed_total = 0

    # ------------------------------------------------------------ routing
    def submit(self, sample, deadline_ms: Optional[float] = None,
               session=None, idempotent: bool = True):
        """Route one request; returns the caller's future. `session`
        pins consistent-hash affinity; `idempotent=False` marks the
        request as unsafe to re-submit (it then fails fast with
        `ServingReroutedError` instead of re-routing on replica loss)."""
        fleet = self.fleet
        if fleet._closing:
            raise EngineClosedError("serving fleet is closed")
        now = time.perf_counter()
        deadline = now + deadline_ms / 1e3 if deadline_ms is not None \
            else None
        req = _FleetRequest(sample, deadline, idempotent, session)
        try:
            return self._route(req, session)
        except Exception as e:
            # an admission failure is caller-visible too: without a
            # record here, a TOTAL outage (no healthy replica, every
            # queue full) would leave the SLO stream all-green while
            # every caller fails at submit
            fleet._trace_outcome(req, _status_of(e), error=repr(e))
            raise

    def _route(self, req: _FleetRequest, session):
        fleet = self.fleet
        last_exc: Optional[BaseException] = None
        excluded: Set[str] = set()
        for attempt in range(1, self.route_attempts + 1):
            try:
                faults.fire(SITE_ROUTE, session=session, attempt=attempt)
                rep = self._pick(session, excluded)
            except ServingUnavailableError:
                raise  # no healthy replica: retrying the pick cannot help
            except Exception as e:
                # an injected/odd routing failure: transient ones retry
                # (the next attempt re-fires the site), permanent raise
                if not self.retry_policy.is_transient(e) \
                        or attempt >= self.route_attempts:
                    raise
                last_exc = e
                continue
            try:
                self._submit_to(req, rep)
            except (QueueFullError, EngineClosedError,
                    ServingUnavailableError) as e:
                excluded.add(rep.replica_id)
                last_exc = e
                continue
            with fleet._lock:
                self.routed_total += 1
                if session is not None:
                    self.affinity_routes_total += 1
            return req.future
        raise last_exc if last_exc is not None else \
            ServingUnavailableError("no routable replica")

    def _pick(self, session, excluded: Set[str]) -> _Replica:
        fleet = self.fleet
        with fleet._lock:
            cands = [rep for rep in fleet._replicas.values()
                     if rep.state == ACTIVE
                     and rep.replica_id not in excluded]
            if not cands:
                raise ServingUnavailableError(
                    "no healthy replica in the fleet "
                    f"(alive={sorted(r.replica_id for r in fleet._replicas.values() if r.state == ACTIVE)}, "
                    f"excluded={sorted(excluded)})")
            if session is not None:
                for rid in self.ring.walk(str(session)):
                    rep = fleet._replicas.get(rid)
                    if rep is not None and rep.state == ACTIVE \
                            and rid not in excluded:
                        return rep
            if len(cands) == 1:
                return cands[0]
            a, b = self._rng.sample(cands, 2)
            return min((a, b), key=self._load)

    @staticmethod
    def _load(rep: _Replica):
        """Ordering key for power-of-two-choices: degraded replicas (any
        open breaker bucket) always lose to clean ones; ties break on
        router-tracked outstanding plus the cached engine queue depth."""
        h = rep.health_cache or {}
        degraded = 1 if (h.get("status") == "degraded"
                         or h.get("open_buckets")) else 0
        depth = h.get("queue_depth")
        depth = depth if isinstance(depth, (int, float)) else 0
        return (degraded, len(rep.outstanding) + depth)

    def _submit_to(self, req: _FleetRequest, rep: _Replica):
        """Hand `req` to one replica engine and track it. Raises the
        engine's synchronous admission errors (caller handles)."""
        deadline_ms = req.remaining_ms()
        if deadline_ms is not None and deadline_ms <= 0:
            raise ServingTimeoutError(
                "deadline lapsed before the request reached a replica")
        if rep.accepts_session and req.session is not None:
            ef = rep.engine.submit(req.sample, deadline_ms=deadline_ms,
                                   session=req.session)
        else:
            ef = rep.engine.submit(req.sample, deadline_ms=deadline_ms)
        with self.fleet._lock:
            req.replica_id = rep.replica_id
            req.engine_future = ef
            rep.outstanding.add(req)
        ef.add_done_callback(functools.partial(self._on_engine_done, req))

    # ------------------------------------------------------- completion
    def _on_engine_done(self, req: _FleetRequest, fut):
        # a cancelled engine future means the drain path owns the
        # outcome — and this callback fires INLINE under fut.cancel(),
        # possibly with the fleet lock held, so bail before locking
        if fut.cancelled():
            return
        fleet = self.fleet
        exc = fut.exception()
        with fleet._lock:
            rep = fleet._replicas.get(req.replica_id)
            if rep is not None:
                rep.outstanding.discard(req)
        if exc is None:
            _resolve(req.future, value=fut.result())
            return
        if req.future.done():
            return  # drain already decided (rerouted or failed fast)
        if fleet._closing:
            if self.retry_policy.is_transient(exc):
                # a caller failed by fleet shutdown must still be
                # visible on the trace stream: its engine record is a
                # replica-internal casualty and no survivor record is
                # coming (a drain-less close traces its casualties;
                # permanent errors count through their engine `error`
                # record already)
                fleet._trace_outcome(req, "cancelled", error=repr(exc))
        elif self.retry_policy.is_transient(exc):
            if self.try_reroute(req, exclude=req.replica_id):
                return
            if isinstance(exc, EngineClosedError):
                # the replica died under this request and it could not
                # move — surface the CONTRACT error, not the mechanism
                wrapped = ServingReroutedError(
                    f"replica {req.replica_id} closed before serving "
                    "this request and re-route was not possible "
                    f"({'already re-routed once' if req.reroutes else 'non-idempotent' if not req.idempotent else 'no healthy replica'})")
                wrapped.__cause__ = exc
                exc = wrapped
            # a transient-shaped engine record is replica-internal (an
            # SLO reader skips a fleet replica's shed/timeout/cancelled
            # serving_request records); this is the ONE caller-visible
            # record of what the caller actually saw
            fleet._trace_outcome(req, _status_of(exc), error=repr(exc))
        _resolve(req.future, exc=exc)

    def try_reroute(self, req: _FleetRequest, exclude: str) -> bool:
        """Move an unresolved request to a survivor. Returns True when
        the router now owns the outcome (re-submitted, or resolved as a
        deadline timeout); False when re-route is not allowed (budget
        spent, non-idempotent, exactly-once exhausted, or no healthy
        replica) — the caller then fails the request fast."""
        fleet = self.fleet
        with fleet._lock:
            if req.reroutes >= self.max_reroutes or not req.idempotent:
                return False
            cands = [rep for rep in fleet._replicas.values()
                     if rep.state == ACTIVE
                     and rep.replica_id != exclude]
            if not cands:
                self.reroute_failed_total += 1
                return False
            # claim the reroute under the lock (the exactly-once gate
            # against a concurrent drain/callback racing this request);
            # a claim whose submit then FAILS rolls back the PER-REQUEST
            # count only — reroutes_total is a counter and must stay
            # monotonic, so it increments after success
            req.reroutes += 1
            rep = min(cands, key=self._load)

        def _unclaim():
            with fleet._lock:
                req.reroutes -= 1
                self.reroute_failed_total += 1

        remaining = req.remaining_ms()
        if remaining is not None and remaining <= 0:
            _unclaim()
            _resolve(req.future, exc=ServingTimeoutError(
                "deadline lapsed before the re-route could dispatch"))
            fleet._trace_outcome(req, "timeout")
            return True
        try:
            self._submit_to(req, rep)
        except Exception as e:
            logger.warning("re-route of a request from %s to %s failed: "
                           "%r", exclude, rep.replica_id, e)
            _unclaim()
            return False
        with fleet._lock:
            self.reroutes_total += 1  # counts requests that MOVED
        return True


# Fleets still open at interpreter exit get a drain-less close so their
# non-daemon maintenance thread (and their replicas' dispatchers) cannot
# hang shutdown — the engine's backstop (a regular atexit hook would run
# after threading._shutdown joined them: too late).
_LIVE_FLEETS: "weakref.WeakSet" = weakref.WeakSet()


def _close_live_fleets():
    for fl in list(_LIVE_FLEETS):
        try:
            fl.close(drain=False)
        except Exception:
            pass


threading._register_atexit(_close_live_fleets)


class ServingFleet:
    """N serving replicas behind one router, with lease/heartbeat
    membership, drain/re-route on loss, and optional autoscaling.

    Example (a 3-replica fleet over one model):
        >>> import numpy as np
        >>> import bigdl_tpu_torch.nn as nn
        >>> from bigdl_tpu_torch.dataset.sample import Sample
        >>> from bigdl_tpu_torch.serving import ServingFleet
        >>> m = (nn.Sequential().add(nn.Linear(4, 2, device="cpu"))
        ...      .add(nn.LogSoftMax()))
        >>> s = Sample(np.ones(4, np.float32))
        >>> fleet = ServingFleet(m, n_replicas=3, warmup_sample=s,
        ...                      engine_kwargs={"max_batch_size": 4,
        ...                                     "max_wait_ms": 0.5,
        ...                                     "device": "cpu"})
        >>> out = fleet.predict(s, session="user-1")
        >>> out.shape
        (2,)
        >>> fleet.close()

    Parameters
    ----------
    model : the trained module every default replica serves. Ignored
        when `engine_factory` is given.
    n_replicas : initial replica count (autoscaling may change it).
    engine_factory : optional `replica_id -> engine` callable replacing
        the default `InferenceEngine` construction — the seam a test
        double, a `GenerationEngine` fleet or any out-of-tree replica
        transport plugs into. The returned object must speak the engine protocol:
        `submit(sample, deadline_ms=) -> Future`, `health() -> dict`,
        `warmup(sample)`, `stats() -> dict`, `close(drain=)`.
    engine_kwargs : kwargs for the default `InferenceEngine` replicas.
        `admission` defaults to "reject" here (NOT the engine's "block"):
        the router IS the upstream shedder — a full replica must fail
        fast so the router tries another, not park the caller.
    warmup_sample : when given, every replica (initial, scaled-up, and
        REJOINING) is `warmup()`-ed with it before entering rotation.
    registry : a `WorkerRegistry` to join (default: a private one with
        `lease_s`/`clock`); share one to co-locate serving and training
        membership on a single surface.
    telemetry : `observability.Telemetry` for the whole tier: registry
        worker events, per-replica engine stats/trace records, fleet
        `serving_fleet` records, drain/scale events.
    trace : when True, each replica gets its own `SpanTracer` process
        lane (`serving:<replica_id>` via the process_name registry);
        `export_trace(path)` merges them into one Perfetto file.
    drain_grace_s : how long a drain waits for a lost replica's
        in-flight futures before re-routing the remainder.
    retire_grace_s : bound on a VOLUNTARY (scale-down) drain's wait for
        its outstanding futures after the engine finished its queue.
    max_reroutes / retry_policy / route_attempts / vnodes / seed :
        router knobs — see `Router`.
    autoscale : an `AutoscalePolicy`, or None to disable.
    maintain_interval_s : when set, a non-daemon maintenance thread
        calls `maintain()` on this period (joined by `close()`); when
        None (default — and in every deterministic test) the owner calls
        `maintain()` itself.
    """

    def __init__(self, model=None, n_replicas: int = 2,
                 engine_factory: Optional[Callable] = None,
                 engine_kwargs: Optional[Dict] = None,
                 warmup_sample=None,
                 registry: Optional[WorkerRegistry] = None,
                 lease_s: float = 10.0,
                 clock: Optional[Callable[[], float]] = None,
                 telemetry=None, trace: bool = False,
                 drain_grace_s: float = 2.0, retire_grace_s: float = 30.0,
                 max_reroutes: int = 1,
                 retry_policy: Optional[RetryPolicy] = None,
                 route_attempts: int = 3, vnodes: int = 64, seed: int = 0,
                 autoscale: Optional[AutoscalePolicy] = None,
                 maintain_interval_s: Optional[float] = None):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if model is None and engine_factory is None:
            raise ValueError("need a model or an engine_factory")
        if drain_grace_s < 0 or retire_grace_s < 0:
            raise ValueError("grace windows must be >= 0")
        if maintain_interval_s is not None and maintain_interval_s <= 0:
            # validate BEFORE replicas build: failing after would leak
            # warmed engines the caller has no handle to close
            raise ValueError("maintain_interval_s must be > 0")
        self._model = model
        self._factory = engine_factory
        self._engine_kwargs = dict(engine_kwargs or {})
        self._warmup_sample = warmup_sample
        self.telemetry = telemetry
        self._trace = bool(trace)
        self.drain_grace_s = float(drain_grace_s)
        self.retire_grace_s = float(retire_grace_s)
        self.registry = registry if registry is not None else \
            WorkerRegistry(lease_s=lease_s, clock=clock,
                           telemetry=telemetry)
        self.autoscale = autoscale
        self._lock = threading.RLock()
        # arrival_offset_ms anchor for the fleet's caller-visible trace
        # records — same contract as InferenceEngine._t0_perf
        self._t0_perf = time.perf_counter()
        self._replicas: Dict[str, _Replica] = {}
        self._next_idx = 0
        self._closing = False
        self._suspended: Set[str] = set()  # heartbeat withheld (tests)
        # fleet counters, under the lock
        self._drains_total = 0
        self._scale_ups_total = 0
        self._scale_downs_total = 0
        self._generations_total = 0
        self._stream_reroutes_total = 0
        self._last_counts: Dict[str, tuple] = {}  # rid -> (shed, subm)
        self.router = Router(self, retry_policy=retry_policy,
                             max_reroutes=max_reroutes,
                             route_attempts=route_attempts,
                             vnodes=vnodes, seed=seed)
        self._maint_stop = threading.Event()
        self._maint_thread: Optional[threading.Thread] = None
        try:
            for _ in range(n_replicas):
                self._add_replica()
        except Exception:
            # a replica that failed to build must not leak the ones
            # that DID build (their non-daemon dispatchers would hang
            # shutdown)
            self.close(drain=False)
            raise
        self._emit_fleet()
        _LIVE_FLEETS.add(self)
        if maintain_interval_s is not None:
            self._maint_thread = threading.Thread(
                target=self._maintain_loop, args=(maintain_interval_s,),
                name="bigdl-fleet-maintain", daemon=False)
            self._maint_thread.start()

    # ------------------------------------------------------------ replicas
    def _new_engine(self, replica_id: str, tracer):
        if self._factory is not None:
            return self._factory(replica_id)
        kw = dict(self._engine_kwargs)
        kw.setdefault("admission", "reject")
        return InferenceEngine(self._model, telemetry=self.telemetry,
                               tracer=tracer, replica_id=replica_id,
                               **kw)

    def _tracer_for(self, replica_id: str):
        if not self._trace:
            return None
        from bigdl_tpu_torch.observability.spans import SpanTracer
        return SpanTracer(process_name=f"serving:{replica_id}")

    def _add_replica(self) -> str:
        """Build, warm, and register one new replica; returns its id."""
        with self._lock:
            rid = f"replica{self._next_idx}"
            self._next_idx += 1
        tracer = self._tracer_for(rid)
        engine = self._new_engine(rid, tracer)
        rep = _Replica(rid, engine, tracer=tracer)
        try:
            self._warm(rep)
        except Exception:
            try:
                engine.close(drain=False)
            except Exception:
                pass
            raise
        # role=serving rides the membership events (an SLO reader picks
        # the right recovery proof for this worker's losses by it)
        self.registry.register(rid, devices=(rid,),
                               meta={"role": "serving"})
        with self._lock:
            self._replicas[rid] = rep
            rep.state = ACTIVE
            self.router.ring.add(rid)
        return rid

    def _warm(self, rep: _Replica):
        """Precompile a replica's buckets before it takes traffic (cold
        executables must never pay their compiles on live requests)."""
        if self._warmup_sample is None:
            return
        rep.engine.warmup(self._warmup_sample)
        rep.warmups += 1

    def replica_ids(self, state: Optional[str] = None) -> List[str]:
        """Replica ids, optionally filtered by lifecycle state."""
        with self._lock:
            return [rid for rid, rep in self._replicas.items()
                    if state is None or rep.state == state]

    # ------------------------------------------------------------ requests
    def submit(self, sample, deadline_ms: Optional[float] = None,
               session=None, idempotent: bool = True):
        """Route one request through the fleet; returns a future. See
        `Router.submit`."""
        return self.router.submit(sample, deadline_ms=deadline_ms,
                                  session=session, idempotent=idempotent)

    def predict(self, sample, timeout: Optional[float] = None,
                deadline_ms: Optional[float] = None, session=None,
                idempotent: bool = True):
        """Blocking convenience: `submit` + wait, with the engine's
        one-exception-family timeout contract."""
        from concurrent.futures import TimeoutError as FuturesTimeoutError
        fut = self.submit(sample, deadline_ms=deadline_ms,
                          session=session, idempotent=idempotent)
        try:
            return fut.result(timeout)
        except FuturesTimeoutError:
            fut.cancel()  # abandoned: the router/drain won't re-route it
            raise ServingTimeoutError(
                f"result not ready within {timeout}s") from None

    def generate(self, prompt, session=None,
                 max_new_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 idempotent: bool = True) -> FleetTokenStream:
        """Route one autoregressive generation stream through the fleet
        (replicas must be `GenerationEngine`s — pass an
        `engine_factory`). `session` pins the stream to its replica via
        the SAME consistent-hash affinity as `submit` — a decode stream
        is stateful (its KV cache lives on that replica), so affinity is
        correctness here, not just cache-warmth. On replica loss the
        stream RESTARTS FROM THE PROMPT on a survivor with
        already-delivered tokens skipped (greedy decode is
        deterministic — exactly-once delivery); `idempotent=False`
        streams fail fast with `ServingReroutedError` instead. See
        `FleetTokenStream`."""
        with self._lock:
            if self._closing:
                raise EngineClosedError("serving fleet is closed")
        kw: Dict = {}
        if max_new_tokens is not None:
            kw["max_new_tokens"] = max_new_tokens
        if eos_id is not None:
            kw["eos_id"] = eos_id
        return FleetTokenStream(self, prompt, session, idempotent, kw,
                                deadline_ms=deadline_ms)

    # ------------------------------------------------------------ failures
    def fail(self, replica_id: str, reason: str = "observed failure"):
        """Declare a replica crashed NOW: mark it lost in the registry
        and run the crash drain (engine killed first, queued work fails
        over to survivors through the router's transient re-route)."""
        try:
            self.registry.mark_lost(replica_id, reason=reason)
        except KeyError:
            pass
        self._drain(replica_id, reason=reason, kill=True)

    def restore(self, replica_id: str) -> bool:
        """Bring a LOST replica back: build a fresh engine, RE-WARM it,
        then revive its registry lease and re-enter rotation. Returns
        False when the replica is not in a restorable state."""
        with self._lock:
            rep = self._replicas.get(replica_id)
            # close() marks every replica LOST — exactly the state this
            # accepts — so a restore racing (or following) close() must
            # refuse, or it would resurrect an engine nothing will close
            if self._closing or rep is None or rep.state != LOST:
                return False
            # claim under the lock: a concurrent restore() of the same
            # replica would otherwise both build engines — one would
            # leak (live non-daemon dispatcher) and the ring would hold
            # the replica's vnodes twice
            rep.state = WARMING
        tracer = rep.tracer or self._tracer_for(replica_id)
        try:
            engine = self._new_engine(replica_id, tracer)
        except Exception:
            with self._lock:
                rep.state = LOST
            raise
        rep2 = _Replica(replica_id, engine, tracer=tracer)
        rep2.warmups = rep.warmups
        try:
            self._warm(rep2)
        except Exception:
            try:
                engine.close(drain=False)
            except Exception:
                pass
            with self._lock:
                rep.state = LOST
            raise
        try:
            self.registry.heartbeat(replica_id)
        except KeyError:
            self.registry.register(replica_id, devices=(replica_id,),
                                   meta={"role": "serving"})
        with self._lock:
            # close() may have raced in while this engine warmed; a
            # replica inserted now would never be closed by anything
            aborted = self._closing
            if not aborted:
                self._replicas[replica_id] = rep2
                rep2.state = ACTIVE
                self.router.ring.add(replica_id)
                self._suspended.discard(replica_id)
        if aborted:
            try:
                engine.close(drain=False)
            except Exception:
                pass
            try:
                self.registry.remove(replica_id)
            except AttributeError:
                pass
            return False
        self._emit_fleet()
        return True

    def _heartbeat_alive(self, extra: Optional[str] = None):
        """Renew every ACTIVE, non-suspended replica's lease — called
        from inside long drain/retire waits so one slow scale event
        cannot starve the fleet's heartbeats until every OTHER lease
        expires and the sweep mass-drains the survivors. `extra` names
        one additional replica to renew: a VOLUNTARILY retiring replica
        is DRAINING but must keep its lease, or a drain longer than
        `lease_s` gets swept as `worker_lost` mid-retirement (a planned
        departure masquerading as an outage)."""
        with self._lock:
            rids = [rid for rid, rep in self._replicas.items()
                    if rep.state == ACTIVE
                    and rid not in self._suspended]
        if extra is not None:
            rids.append(extra)
        for rid in rids:
            try:
                self.registry.heartbeat(rid)
            except KeyError:
                pass

    def _wait_with_heartbeats(self, futs, timeout_s: float,
                              extra: Optional[str] = None):
        """`futures.wait` in lease-sized chunks, renewing survivor
        leases between chunks (a grace window may exceed `lease_s`)."""
        futs = [f for f in futs if f is not None]
        if not futs:
            return
        chunk = max(0.05, self.registry.lease_s / 4.0)
        deadline = time.monotonic() + timeout_s
        while futs:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            _, pending = _futures_wait(futs,
                                       timeout=min(chunk, remaining))
            futs = list(pending)
            self._heartbeat_alive(extra=extra)

    def suspend_heartbeat(self, replica_id: str):
        """Stop heartbeating one replica (test/chaos hook): its lease
        then expires naturally and the next `maintain()` sweep drains
        it — the lease-miss path, as opposed to `fail()`'s crash path."""
        with self._lock:
            self._suspended.add(replica_id)

    def _drain(self, replica_id: str, reason: str, kill: bool):
        """The involuntary drain: grace-wait in-flight work, re-route
        the remainder exactly once, kill the engine. `kill=True` (crash)
        closes the engine FIRST so its queued-but-undispatched requests
        fail over immediately instead of finishing on a replica we
        just declared dead."""
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None or rep.state in (DRAINING, LOST, RETIRED):
                return
            rep.state = DRAINING
            self.router.ring.remove(replica_id)
            pending = list(rep.outstanding)
            self._drains_total += 1
        grace = self.drain_grace_s
        try:
            faults.fire(SITE_DRAIN, replica=replica_id,
                        pending=len(pending))
        except Exception as e:
            # an injected drain failure must not lose the drain itself —
            # it collapses the grace window instead (fail-fast drain)
            logger.warning("drain of %s hit an injected fault (%r); "
                           "skipping the grace wait", replica_id, e)
            grace = 0.0
        if kill:
            # crash: engine down first; close(drain=False) resolves its
            # queue with EngineClosedError, which the router classifies
            # transient and re-routes (exactly-once) via callbacks
            try:
                rep.engine.close(drain=False)
            except Exception:
                logger.exception("closing crashed replica %s failed",
                                 replica_id)
        if pending and grace > 0:
            self._wait_with_heartbeats(
                [r.engine_future for r in pending], grace)
        with self._lock:
            leftover = [r for r in rep.outstanding if not r.future.done()]
        rerouted = failed = 0
        for req in leftover:
            with self._lock:
                # a concurrent engine callback may have re-routed this
                # request to a SURVIVOR since the snapshot — cancelling
                # its (new) engine future would kill healthy work and
                # fail an already-saved request
                if req.future.done() or req.replica_id != replica_id:
                    continue
                ef = req.engine_future
            if ef is not None and not ef.cancel() and not ef.cancelled():
                continue  # resolved concurrently: its callback owns it
            if req.future.done():
                continue
            if self.router.try_reroute(req, exclude=replica_id):
                rerouted += 1
                continue
            failed += 1
            why = ("already re-routed once" if req.reroutes
                   else "non-idempotent" if not req.idempotent
                   else "no healthy replica available")
            err = ServingReroutedError(
                f"replica {replica_id} was drained ({reason}) and this "
                f"request was not re-routed: {why}")
            _resolve(req.future, exc=err)
            self._trace_outcome(req, "error", error=repr(err))
        if not kill:
            try:
                rep.engine.close(drain=False)
            except Exception:
                logger.exception("closing drained replica %s failed",
                                 replica_id)
        with self._lock:
            rep.state = LOST
            rep.outstanding.clear()
        self._event("replica_drained", replica=replica_id, reason=reason,
                    crash=kill, in_flight=len(pending),
                    completed_in_grace=len(pending) - len(leftover),
                    rerouted=rerouted, failed=failed)
        self._emit_fleet()

    # ---------------------------------------------------------- maintenance
    def maintain(self):
        """One membership/autoscale tick: fire the `serve.replica_crash`
        chaos site per active replica, heartbeat the survivors, sweep
        expired leases into drains, refresh the router's cached
        `health()` snapshots, run the autoscale policy, and emit the
        `serving_fleet` telemetry record. Call this on a loop (or let
        `maintain_interval_s` run it) — it is the fleet's heartbeat."""
        with self._lock:
            if self._closing:
                return
            active = [(rid, rep) for rid, rep in self._replicas.items()
                      if rep.state == ACTIVE]
            suspended = set(self._suspended)
        for rid, rep in active:
            try:
                faults.fire(SITE_REPLICA_CRASH, replica=rid)
            except Exception as e:
                self.fail(rid, reason=f"injected crash: {e!r}")
                continue
            if rid in suspended:
                continue
            try:
                self.registry.heartbeat(rid)
            except KeyError:
                pass  # removed by a concurrent scale-down
        for rid in self.registry.sweep():
            # _drain takes the lock and no-ops on an unknown/terminal
            # replica — no unguarded membership pre-check needed here
            self._drain(rid, reason="lease_expired", kill=False)
        with self._lock:
            active = [rep for rep in self._replicas.values()
                      if rep.state == ACTIVE]
        for rep in active:
            try:
                rep.health_cache = rep.engine.health()
            except Exception:
                logger.exception("health() of %s failed", rep.replica_id)
        if self.autoscale is not None:
            self._autoscale_tick()
        self._emit_fleet()

    def _maintain_loop(self, interval_s: float):
        while not self._maint_stop.wait(interval_s):
            try:
                self.maintain()
            except Exception:
                logger.exception("fleet maintenance tick failed")

    def _autoscale_tick(self):
        signals = self._signals()
        n = len(self.replica_ids(ACTIVE))
        step = self.autoscale.decide(signals, n)
        ctx = {k: v for k, v in signals.items() if v is not None}
        if step > 0:
            try:
                self.scale_up(**ctx)
            except Exception:
                logger.exception("autoscale scale-up failed")
        elif step < 0:
            self.scale_down(**ctx)

    def scale_up(self, **event_ctx) -> str:
        """Add one warmed replica to the rotation (the autoscale policy's
        grow step; also the operator's manual knob). Returns its id."""
        rid = self._add_replica()
        with self._lock:
            self._scale_ups_total += 1
            n = sum(1 for rep in self._replicas.values()
                    if rep.state == ACTIVE)
        self._event("fleet_scale_up", replica=rid, replicas=n,
                    **event_ctx)
        self._emit_fleet()
        return rid

    def scale_down(self, replica_id: Optional[str] = None,
                   **event_ctx) -> Optional[str]:
        """Retire one replica by VOLUNTARY drain — it leaves the
        rotation, finishes every queued request, then deregisters
        (`worker_left`, never `worker_lost`). Picks the least-loaded
        ACTIVE replica unless `replica_id` names one. Returns the
        retired id, or None when nothing could be retired."""
        victim = replica_id if replica_id is not None \
            else self._retire_candidate()
        if victim is None or not self._retire(victim):
            return None
        with self._lock:
            self._scale_downs_total += 1
            n = sum(1 for rep in self._replicas.values()
                    if rep.state == ACTIVE)
        self._event("fleet_scale_down", replica=victim, replicas=n,
                    **event_ctx)
        self._emit_fleet()
        return victim

    def _signals(self) -> Dict:
        """The autoscale inputs, from the replicas' `stats()`: max
        per-replica p99 latency, total queue depth, and the shed rate
        over the window since the last tick."""
        p99s: List[float] = []
        depth = 0.0
        counts: Dict[str, tuple] = {}
        with self._lock:
            active = [rep for rep in self._replicas.values()
                      if rep.state == ACTIVE]
        for rep in active:
            try:
                s = rep.engine.stats()
            except Exception:
                continue
            v = s.get("latency_ms_p99")
            if isinstance(v, (int, float)):
                p99s.append(float(v))
            d = s.get("queue_depth")
            if isinstance(d, (int, float)):
                depth += d
            # "rejected" joins "shed": fleet replicas default to
            # admission="reject", so overload surfaces as rejections —
            # an autoscaler reading only breaker sheds would keep
            # bouncing 100% of overflow traffic instead of growing
            counts[rep.replica_id] = (
                int(s.get("shed") or 0) + int(s.get("rejected") or 0),
                int(s.get("submitted") or 0)
                + int(s.get("rejected") or 0))
        d_shed = d_sub = 0
        with self._lock:
            # per-replica deltas against PER-REPLICA baselines: summing
            # fleet-wide totals across different replica sets makes the
            # window go negative the tick after a crash (reading as
            # "nothing shed" and green-lighting a scale-down right after
            # losing capacity); a restored replica's fresh engine resets
            # its counters, so a shrunken count restarts its baseline
            for rid, (sh, su) in counts.items():
                base_sh, base_su = self._last_counts.get(rid, (0, 0))
                if sh < base_sh or su < base_su:
                    base_sh = base_su = 0
                d_shed += sh - base_sh
                d_sub += su - base_su
            # MERGE into the baselines (don't replace): a replica whose
            # stats() failed this tick keeps its old baseline, instead
            # of re-reporting its lifetime totals as one phantom window
            # next tick; prune to the current replica table for bound
            merged = {**self._last_counts, **counts}
            self._last_counts = {rid: v for rid, v in merged.items()
                                 if rid in self._replicas}
        return {
            "p99_ms": max(p99s) if p99s else None,
            "queue_depth": depth,
            "shed_rate": (d_shed / d_sub) if d_sub > 0 else None,
        }

    def _retire_candidate(self) -> Optional[str]:
        """Scale-down victim: the ACTIVE replica with the least load."""
        with self._lock:
            active = [rep for rep in self._replicas.values()
                      if rep.state == ACTIVE]
            if len(active) <= 1:
                return None
            return min(active, key=self.router._load).replica_id

    def _retire(self, replica_id: str) -> bool:
        """VOLUNTARY drain (scale-down): leave the rotation, then finish
        every queued request before deregistering — the serving twin of
        the elastic loop's commit/boundary discipline: a scale event
        never drops accepted work. Returns False when the replica was
        not retirable (unknown id, or no longer ACTIVE — e.g. a crash
        raced the autoscale tick), so the caller must not count it."""
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None or rep.state != ACTIVE:
                return False
            rep.state = DRAINING
            self.router.ring.remove(replica_id)
        def _close_draining():
            try:
                rep.engine.close(drain=True)  # blocks: queue served
            except Exception:
                logger.exception("retiring replica %s failed mid-drain",
                                 replica_id)

        # the drain can outlast lease_s on a loaded replica; close on a
        # side thread and keep renewing survivor leases meanwhile
        closer = threading.Thread(target=_close_draining,
                                  name="bigdl-fleet-retire",
                                  daemon=False)
        closer.start()
        hb = max(0.05, self.registry.lease_s / 4.0)
        while closer.is_alive():
            closer.join(timeout=hb)
            self._heartbeat_alive(extra=replica_id)
        with self._lock:
            pending = [r.engine_future for r in rep.outstanding
                       if r.engine_future is not None]
        if pending:
            self._wait_with_heartbeats(pending, self.retire_grace_s,
                                       extra=replica_id)
        with self._lock:
            leftover = [r for r in rep.outstanding if not r.future.done()]
        for req in leftover:  # should be empty; involuntary fallback
            if req.engine_future is not None:
                req.engine_future.cancel()
            if req.future.done():
                continue
            if not self.router.try_reroute(req, exclude=replica_id):
                err = ServingReroutedError(
                    f"replica {replica_id} retired before this request "
                    "completed and it could not be re-routed")
                _resolve(req.future, exc=err)
                self._trace_outcome(req, "error", error=repr(err))
        try:
            self.registry.remove(replica_id)
        except AttributeError:  # foreign registry without remove()
            pass
        with self._lock:
            rep.state = RETIRED
            rep.outstanding.clear()
            del self._replicas[replica_id]
        self._event("replica_retired", replica=replica_id)
        return True

    # ------------------------------------------------------------ telemetry
    def _trace_outcome(self, req, status: str,
                       error: Optional[str] = None,
                       kind: str = "fleet_request"):
        """One caller-visible `trace` record for an outcome the ROUTER
        decided (a surfaced transient failure, a refused re-route, a
        deadline lapsed mid-re-route): the replica engines recorded such
        requests only as transient-shaped casualties (`cancelled`/
        `shed`/`timeout`) — which an SLO reader skips for fleet-managed
        replicas, since the router may have saved them — so this record
        is what keeps the trace stream honest about what
        the CALLER actually saw."""
        if self.telemetry is None:
            return
        from bigdl_tpu_torch.observability.spans import TraceContext
        rec = {"type": "trace",
               "trace_id": TraceContext.new_trace().trace_id,
               "kind": kind, "status": status,
               "latency_ms": round(
                   (time.perf_counter() - req.t_submit) * 1e3, 3),
               "arrival_offset_ms": round(
                   (req.t_submit - self._t0_perf) * 1e3, 3)}
        # `req` is a _FleetRequest or a FleetTokenStream (private-name
        # variants of the same fields)
        session = getattr(req, "session", None)
        if session is None:
            session = getattr(req, "_session", None)
        if session is not None:
            rec["session_id"] = str(session)
        idem = getattr(req, "idempotent", None)
        if idem is None:
            idem = getattr(req, "_idempotent", None)
        if idem is not None:
            rec["idempotent"] = bool(idem)
        deadline = getattr(req, "deadline", None)
        if deadline is None:
            deadline = getattr(req, "_deadline", None)
        if deadline is not None:
            rec["deadline_budget_ms"] = round(
                (deadline - req.t_submit) * 1e3, 3)
        if req.replica_id is not None:
            rec["replica_id"] = req.replica_id
        if error is not None:
            rec["error"] = error
        try:
            self.telemetry.emit(rec)
        except Exception:
            logger.exception("fleet trace emission failed; dropped")

    def _event(self, kind: str, **fields):
        if self.telemetry is None:
            return
        try:
            self.telemetry.event(kind, **fields)
        except Exception:
            logger.exception("fleet telemetry event %s failed", kind)

    def _emit_fleet(self):
        """One `serving_fleet` record (`fleet_counters()`)."""
        if self.telemetry is None:
            return
        try:
            self.telemetry.emit({"type": "serving_fleet",
                                 **self.fleet_counters()})
        except Exception:
            logger.exception("serving_fleet telemetry emit failed")

    def fleet_counters(self) -> Dict:
        """The fleet-level counter/gauge snapshot (the `serving_fleet`
        record body; engine-level counters live in `stats()`)."""
        with self._lock:
            states = [rep.state for rep in self._replicas.values()]
            depths = {}
            for rid, rep in self._replicas.items():
                if rep.state not in (ACTIVE, DRAINING):
                    continue
                h = rep.health_cache or {}
                d = h.get("queue_depth")
                depths[rid] = int(d) if isinstance(d, (int, float)) \
                    else len(rep.outstanding)
            return {
                "replicas_alive": states.count(ACTIVE),
                "replicas_draining": states.count(DRAINING),
                "replicas_total": len(states),
                "reroutes_total": self.router.reroutes_total,
                "reroute_failed_total": self.router.reroute_failed_total,
                "routed_total": self.router.routed_total,
                "affinity_routes_total":
                    self.router.affinity_routes_total,
                "drains_total": self._drains_total,
                "scale_ups_total": self._scale_ups_total,
                "scale_downs_total": self._scale_downs_total,
                "generations_total": self._generations_total,
                "stream_reroutes_total": self._stream_reroutes_total,
                "replica_queue_depth": depths,
            }

    def stats(self) -> Dict:
        """Fleet counters plus the SUM of every live replica's engine
        counters (submitted/completed/failed/... as in
        `InferenceEngine.stats`)."""
        out = self.fleet_counters()
        agg: Dict = {}
        with self._lock:
            reps = [rep for rep in self._replicas.values()
                    if rep.state in (ACTIVE, DRAINING)]
        for rep in reps:
            try:
                s = rep.engine.stats()
            except Exception:
                continue
            for k, v in s.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                if k.endswith(("_p50", "_p95", "_p99")):
                    agg[k] = max(agg.get(k, float("-inf")), v)
                elif k.endswith(("_rate", "_fraction")) or k == "mfu":
                    continue  # ratios don't sum; read them per replica
                else:
                    agg[k] = agg.get(k, 0) + v
        out["engines"] = agg
        return out

    def health(self) -> Dict:
        """The fleet's load-balancer surface: overall status ("ok" while
        any replica serves clean, "degraded" while serving but impaired,
        "down"/"closed" otherwise), per-replica state + engine health,
        and the registry snapshot."""
        with self._lock:
            closing = self._closing
            reps = dict(self._replicas)
        per = {}
        n_ok = n_active = 0
        for rid, rep in reps.items():
            h = None
            if rep.state in (ACTIVE, DRAINING):
                try:
                    h = rep.engine.health()
                except Exception:
                    h = {"status": "error"}
            per[rid] = {"state": rep.state, "engine": h}
            if rep.state == ACTIVE:
                n_active += 1
                if h is not None and h.get("status") == "ok":
                    n_ok += 1
        status = "closed" if closing else \
            "down" if n_active == 0 else \
            "ok" if n_ok == n_active else "degraded"
        return {"status": status, "replicas": per,
                "registry": self.registry.snapshot()}

    def export_trace(self, path: str) -> str:
        """Merge every replica's tracer (nothing else: a caller merges
        its own tracer itself) into ONE Perfetto-loadable file; each replica
        renders as its own process lane. Requires `trace=True`."""
        from bigdl_tpu_torch.observability.spans import export_merged
        with self._lock:
            tracers = [rep.tracer for rep in self._replicas.values()
                       if rep.tracer is not None]
        if not tracers:
            raise ValueError(
                "no replica tracers (construct the fleet with trace=True)")
        return export_merged(path, tracers)

    # ------------------------------------------------------------ lifecycle
    def close(self, drain: bool = True):
        """Shut the fleet down: stop maintenance, close every replica
        (`drain=True` finishes queued work first), resolve any request
        still unowned. Idempotent."""
        with self._lock:
            if self._closing:
                return
            self._closing = True
        self._maint_stop.set()
        if self._maint_thread is not None and \
                self._maint_thread is not threading.current_thread():
            self._maint_thread.join()
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            if rep.state in (ACTIVE, DRAINING, WARMING):
                try:
                    rep.engine.close(drain=drain)
                except Exception:
                    logger.exception("closing replica %s failed",
                                     rep.replica_id)
        with self._lock:
            leftover = [req for rep in reps for req in rep.outstanding
                        if not req.future.done()]
            for rep in reps:
                rep.state = LOST if rep.state != RETIRED else RETIRED
                rep.outstanding.clear()
        for req in leftover:
            _resolve(req.future,
                     exc=EngineClosedError("serving fleet closed"))
            self._trace_outcome(req, "cancelled",
                                error="EngineClosedError('serving "
                                      "fleet closed')")
        _LIVE_FLEETS.discard(self)
        self._emit_fleet()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # backstop; callers close() explicitly
        try:
            self.close(drain=False)
        except Exception:
            pass
