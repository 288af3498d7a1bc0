"""Port parity: the serving fleet (`bigdl_tpu_torch/serving/fleet.py`),
after the reference's `tests/test_fleet.py`, its SLO and Prometheus cases
included (the `serving_fleet_*` and membership gauges, the `SloEngine`'s
MTTR and fleet-transient rules, close-time failures and a total outage
burning the error budget, and the drill's stream passing `metrics_cli
slo --check --mttr-s 60`).

Most routing cases run over `SimEngine`, the reference's engine-protocol
double (no dispatcher thread), copied here: routing, affinity across a
scale event, power-of-two choices; reroute (an open breaker's shed is
rerouted, a permanent error surfaces on attempt 1, exactly once, the
deadline budget, route faults); drain (grace, reroute after grace,
non-idempotent fails fast, a drain fault, rejoin re-warms, the
replica-crash site); autoscaling (scale-down drops no accepted work); the
fleet's records and traces; the hash ring. The crash test and the trace
lanes run real `InferenceEngine` replicas on the CPU; the soak is cut to
60 requests over 10 replicas.

Parity with the JAX package: `_HashRing.walk` for 200 keys,
`AutoscalePolicy.decide` over a grid of signals, one scripted scenario
(owner-driven `maintain()`, an injected clock, engines staged with
`start=False` so every routing decision is taken on a quiesced fleet)
through both packages' `ServingFleet` over the same MLP weights, and a
`FleetTokenStream` restarted on a survivor against the JAX greedy decode
of the same 1-layer `TransformerLM`. The scenario's rows agree within
1e-6 (the same f32 arithmetic, ~1e-7 apart).
"""

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FuturesTimeoutError

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset.sample import Sample as JSample
from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.observability import InMemorySink as JInMemorySink
from bigdl_tpu.observability import Telemetry as JTelemetry
from bigdl_tpu.serving import AutoscalePolicy as JAutoscalePolicy
from bigdl_tpu.serving import ServingFleet as JServingFleet
from bigdl_tpu.serving import greedy_decode_reference as jax_reference
from bigdl_tpu.serving.fleet import _HashRing as JHashRing
import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.interop import (load_transformer_lm_params,
                                     module_params_tree)
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.observability import (InMemorySink,
                                           PrometheusTextSink, SloEngine,
                                           Telemetry, default_slos,
                                           validate_record)
from bigdl_tpu_torch.optim import LocalPredictor
from bigdl_tpu_torch.resilience import (FaultInjector, FaultSpec,
                                        PermanentInjectedFault,
                                        TransientInjectedFault, known_sites)
from bigdl_tpu_torch.serving import (AutoscalePolicy, GenerationEngine,
                                     ServingError, ServingFleet,
                                     ServingReroutedError,
                                     ServingTimeoutError,
                                     ServingUnavailableError,
                                     default_router_policy)
from bigdl_tpu_torch.serving.engine import EngineClosedError
from bigdl_tpu_torch.serving.fleet import ACTIVE, LOST, _HashRing

#: the scripted scenario's rows, port against the JAX package
ROW_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _flight_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_FLIGHT_DIR", str(tmp_path / "flight"))


def _telemetry(*sinks):
    return Telemetry(*sinks, resources=False, flight=False)


# --------------------------------------------------------------------------
# SimEngine: the engine-protocol stand-in
# --------------------------------------------------------------------------
class SimEngine:
    """No-jit, no-thread engine double. `mode` scripts the behavior:

    - "echo"  — submits resolve immediately with `(replica_id, payload)`,
    - "hold"  — submits park on an internal queue until `release_all()`
      (or `close(drain=True)`) resolves them,
    - "fail"  — submits return a future already failed with `exc`.
    """

    def __init__(self, replica_id, mode="echo", exc=None):
        self.replica_id = replica_id
        self.mode = mode
        self.exc = exc
        self.held = deque()
        self.closed = False
        self.warmups = 0
        self.submits = 0
        self.last_deadline_ms = None
        self._lock = threading.Lock()

    def _outcome(self, fut, value=None, exc=None):
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(value)
        except InvalidStateError:
            pass

    def submit(self, sample, deadline_ms=None):
        with self._lock:
            if self.closed:
                raise EngineClosedError(f"{self.replica_id} closed")
            self.submits += 1
            self.last_deadline_ms = deadline_ms
            fut = Future()
            if self.mode == "hold":
                self.held.append((sample, fut))
                return fut
        if self.mode == "fail":
            exc = self.exc if isinstance(self.exc, BaseException) \
                else self.exc(f"{self.replica_id} scripted failure")
            self._outcome(fut, exc=exc)
        else:
            self._outcome(fut, value=(self.replica_id, sample))
        return fut

    def release_all(self):
        with self._lock:
            items = list(self.held)
            self.held.clear()
        for sample, fut in items:
            self._outcome(fut, value=(self.replica_id, sample))

    def fail_all(self, exc):
        with self._lock:
            items = list(self.held)
            self.held.clear()
        for _, fut in items:
            self._outcome(fut, exc=exc)

    def warmup(self, sample):
        self.warmups += 1
        return 0

    def health(self):
        return {"status": "ok", "open_buckets": [], "breakers": {},
                "queue_depth": len(self.held), "queue_capacity": 1024}

    def stats(self):
        return {"queue_depth": len(self.held), "submitted": self.submits,
                "completed": self.submits - len(self.held), "shed": 0}

    def close(self, drain=True):
        with self._lock:
            if self.closed:
                return
            self.closed = True
            items = list(self.held)
            self.held.clear()
        for sample, fut in items:
            if drain:
                self._outcome(fut, value=(self.replica_id, sample))
            else:
                self._outcome(fut, exc=EngineClosedError(
                    f"{self.replica_id} closed"))


class _Clock:
    """Mutable virtual clock for lease-expiry tests."""

    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def sim_fleet(n=3, telemetry=None, clock=None, **kw):
    """A fleet of SimEngines; returns (fleet, engines dict). The dict
    always holds the CURRENT engine per replica id (restore() rebuilds)."""
    engines = {}

    def factory(rid):
        eng = SimEngine(rid)
        engines[rid] = eng
        return eng

    kw.setdefault("warmup_sample", "w")
    kw.setdefault("drain_grace_s", 0.2)
    fleet = ServingFleet(engine_factory=factory, n_replicas=n,
                         telemetry=telemetry, clock=clock, **kw)
    return fleet, engines


def session_for(fleet, rid):
    """A session key whose consistent-hash home is `rid`."""
    for i in range(100_000):
        s = f"sess{i}"
        if next(iter(fleet.router.ring.walk(s))) == rid:
            return s
    raise AssertionError(f"no session hashes to {rid}")



# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------
class TestRouting:
    def test_echo_round_trip(self):
        fleet, engines = sim_fleet(3)
        try:
            futs = [fleet.submit(f"p{i}") for i in range(12)]
            for i, f in enumerate(futs):
                rid, payload = f.result(5)
                assert payload == f"p{i}"
                assert rid in engines
        finally:
            fleet.close()

    def test_session_affinity_stable(self):
        fleet, engines = sim_fleet(4)
        try:
            homes = set()
            for _ in range(20):
                rid, _ = fleet.submit("x", session="user-7").result(5)
                homes.add(rid)
            assert len(homes) == 1
        finally:
            fleet.close()

    def test_affinity_stability_across_scale_event(self):
        fleet, _ = sim_fleet(4)
        try:
            sessions = [f"s{i}" for i in range(300)]

            def mapping():
                return {s: next(iter(fleet.router.ring.walk(s)))
                        for s in sessions}

            before = mapping()
            fleet.scale_up()
            after = mapping()
            moved = sum(1 for s in sessions if before[s] != after[s])
            # consistent hashing: adding 1 of 5 replicas moves ~1/5 of
            # the keys; a modulo router would move ~4/5
            assert moved / len(sessions) < 0.40
            # sessions that did move all moved TO the new replica
            new_rid = (set(after.values()) - set(before.values())) or \
                {after[s] for s in sessions if before[s] != after[s]}
            for s in sessions:
                if before[s] != after[s]:
                    assert after[s] in new_rid
        finally:
            fleet.close()

    def test_p2c_prefers_less_loaded(self):
        fleet, engines = sim_fleet(2)
        try:
            engines["replica0"].mode = "hold"
            # unaffinitized traffic: p2c sees replica0's outstanding pile
            # up and steers to replica1
            futs = [fleet.submit(f"p{i}") for i in range(40)]
            assert engines["replica1"].submits > engines["replica0"].submits
            engines["replica0"].release_all()
            for f in futs:
                f.result(5)
        finally:
            fleet.close()

    def test_no_healthy_replica_raises(self):
        fleet, _ = sim_fleet(2)
        try:
            fleet.fail("replica0")
            fleet.fail("replica1")
            with pytest.raises(ServingUnavailableError):
                fleet.submit("x")
        finally:
            fleet.close()


# --------------------------------------------------------------------------
# re-route semantics (the satellite retry-classification contract)
# --------------------------------------------------------------------------
class TestReroute:
    def test_open_breaker_sheds_reroute_not_caller_failure(self):
        fleet, engines = sim_fleet(2)
        try:
            engines["replica0"].mode = "fail"
            engines["replica0"].exc = ServingUnavailableError
            sess = session_for(fleet, "replica0")
            rid, _ = fleet.submit("x", session=sess).result(5)
            assert rid == "replica1"
            assert fleet.router.reroutes_total == 1
        finally:
            fleet.close()

    def test_permanent_model_error_surfaces_on_attempt_1(self):
        fleet, engines = sim_fleet(2)
        try:
            engines["replica0"].mode = "fail"
            engines["replica0"].exc = ServingError("batch forward failed")
            sess = session_for(fleet, "replica0")
            before = engines["replica1"].submits
            with pytest.raises(ServingError):
                fleet.submit("x", session=sess).result(5)
            assert engines["replica1"].submits == before  # no re-route
            assert fleet.router.reroutes_total == 0
        finally:
            fleet.close()

    def test_reroute_is_exactly_once(self):
        fleet, engines = sim_fleet(2, max_reroutes=1)
        try:
            for rid in ("replica0", "replica1"):
                engines[rid].mode = "fail"
                engines[rid].exc = ServingUnavailableError
            with pytest.raises(ServingUnavailableError):
                fleet.submit("x").result(5)
            assert fleet.router.reroutes_total == 1  # not a retry storm
        finally:
            fleet.close()

    def test_reroute_decrements_deadline_budget(self):
        fleet, engines = sim_fleet(2, drain_grace_s=0.0)
        try:
            engines["replica0"].mode = "hold"
            sess = session_for(fleet, "replica0")
            fut = fleet.submit("x", deadline_ms=5_000.0, session=sess)
            time.sleep(0.15)
            fleet.fail("replica0")
            rid, _ = fut.result(5)
            assert rid == "replica1"
            # the re-submit carried the ORIGINAL deadline minus the time
            # already spent, not a fresh budget
            assert engines["replica1"].last_deadline_ms is not None
            assert engines["replica1"].last_deadline_ms < 4_900.0
        finally:
            fleet.close()

    def test_transient_injected_fault_on_route_retries(self):
        fleet, _ = sim_fleet(2)
        try:
            with FaultInjector(FaultSpec("serve.route", at_hit=1,
                                         times=1)):
                rid, _ = fleet.submit("x").result(5)
            assert rid in ("replica0", "replica1")
        finally:
            fleet.close()

    def test_permanent_injected_fault_on_route_surfaces(self):
        fleet, _ = sim_fleet(2)
        try:
            with FaultInjector(FaultSpec("serve.route",
                                         exc=PermanentInjectedFault)):
                with pytest.raises(PermanentInjectedFault):
                    fleet.submit("x")
        finally:
            fleet.close()


# --------------------------------------------------------------------------
# drain semantics
# --------------------------------------------------------------------------
class TestDrain:
    def _lease_fleet(self, **kw):
        clock = _Clock()
        fleet, engines = sim_fleet(2, clock=clock, lease_s=1.0, **kw)
        return fleet, engines, clock

    def test_in_flight_completes_within_grace(self):
        fleet, engines, clock = self._lease_fleet(drain_grace_s=5.0)
        try:
            engines["replica0"].mode = "hold"
            sess = session_for(fleet, "replica0")
            fut = fleet.submit("x", session=sess)
            # the replica misses its lease but is merely SLOW: its
            # in-flight work resolves inside the grace window
            t = threading.Timer(0.15, engines["replica0"].release_all)
            t.start()
            fleet.suspend_heartbeat("replica0")
            clock.t += 2.0
            fleet.maintain()  # sweeps the lease, drains with grace
            t.join()
            rid, payload = fut.result(5)
            assert rid == "replica0"  # finished where it started
            assert fleet.router.reroutes_total == 0
            assert "replica0" in fleet.replica_ids(LOST)
        finally:
            fleet.close()

    def test_queued_rerouted_after_grace(self):
        fleet, engines, clock = self._lease_fleet(drain_grace_s=0.05)
        try:
            engines["replica0"].mode = "hold"  # never releases
            sess = session_for(fleet, "replica0")
            fut = fleet.submit("x", session=sess)
            fleet.suspend_heartbeat("replica0")
            clock.t += 2.0
            fleet.maintain()
            rid, _ = fut.result(5)
            assert rid == "replica1"  # queued work completed on survivor
            assert fleet.router.reroutes_total == 1
        finally:
            fleet.close()

    def test_non_idempotent_fails_fast_with_rerouted_error(self):
        fleet, engines = sim_fleet(2, drain_grace_s=0.0)
        try:
            engines["replica0"].mode = "hold"
            sess = session_for(fleet, "replica0")
            before = engines["replica1"].submits
            fut = fleet.submit("x", session=sess, idempotent=False)
            fleet.fail("replica0")
            with pytest.raises(ServingReroutedError):
                fut.result(5)
            assert engines["replica1"].submits == before  # never re-ran
        finally:
            fleet.close()

    def test_second_drain_fails_fast_exactly_once(self):
        fleet, engines = sim_fleet(3, drain_grace_s=0.0)
        try:
            engines["replica0"].mode = "hold"
            sess = session_for(fleet, "replica0")
            fut = fleet.submit("x", session=sess)
            # every survivor also holds, so the re-routed request is
            # still queued when ITS replica dies too
            engines["replica1"].mode = "hold"
            engines["replica2"].mode = "hold"
            fleet.fail("replica0")
            assert fleet.router.reroutes_total == 1
            with fleet._lock:
                moved_to = next(
                    rid for rid, rep in fleet._replicas.items()
                    if any(r.future is fut for r in rep.outstanding))
            fleet.fail(moved_to)
            with pytest.raises(ServingReroutedError):
                fut.result(5)
            assert fleet.router.reroutes_total == 1  # exactly once
        finally:
            fleet.close()

    def test_injected_drain_fault_collapses_grace(self):
        fleet, engines = sim_fleet(2, drain_grace_s=30.0)
        try:
            engines["replica0"].mode = "hold"
            sess = session_for(fleet, "replica0")
            fut = fleet.submit("x", session=sess)
            t0 = time.perf_counter()
            with FaultInjector(FaultSpec("serve.drain")):
                fleet.fail("replica0")
            rid, _ = fut.result(5)
            assert rid == "replica1"
            # the 30s grace was skipped, not waited out
            assert time.perf_counter() - t0 < 5.0
        finally:
            fleet.close()

    def test_rejoin_rewarms_before_rotation(self):
        fleet, engines = sim_fleet(2, drain_grace_s=0.0)
        try:
            old = engines["replica0"]
            fleet.fail("replica0")
            assert fleet.restore("replica0")
            fresh = engines["replica0"]
            assert fresh is not old  # a NEW engine, not the dead one
            assert fresh.warmups == 1  # re-warmed before rotation
            sess = session_for(fleet, "replica0")
            rid, _ = fleet.submit("x", session=sess).result(5)
            assert rid == "replica0"
        finally:
            fleet.close()

    def test_fault_sites_registered(self):
        sites = known_sites()
        for site in ("serve.replica_crash", "serve.route", "serve.drain"):
            assert site in sites
            FaultSpec(site)  # fail-fast registry accepts them

    def test_injected_replica_crash_kills_replica(self):
        fleet, engines = sim_fleet(2, drain_grace_s=0.0)
        try:
            with FaultInjector(FaultSpec(
                    "serve.replica_crash",
                    when=lambda ctx: ctx.get("replica") == "replica1")):
                fleet.maintain()
            assert "replica1" in fleet.replica_ids(LOST)
            assert "replica0" in fleet.replica_ids(ACTIVE)
        finally:
            fleet.close()



# --------------------------------------------------------------------------
# autoscaling
# --------------------------------------------------------------------------
class TestAutoscale:
    def test_policy_decisions(self):
        clock = _Clock()
        pol = AutoscalePolicy(min_replicas=1, max_replicas=4,
                              p99_high_ms=100.0, queue_high=8.0,
                              shed_high=0.01, queue_low=0.5,
                              cooldown_s=10.0, clock=clock)
        clock.t += 11.0
        assert pol.decide({"p99_ms": 200.0, "queue_depth": 0.0,
                           "shed_rate": 0.0}, 2) == 1
        # cooldown: the scale event's own transient cannot re-trigger
        assert pol.decide({"p99_ms": 200.0, "queue_depth": 0.0,
                           "shed_rate": 0.0}, 3) == 0
        clock.t += 11.0
        assert pol.decide({"p99_ms": 1.0, "queue_depth": 0.0,
                           "shed_rate": 0.0}, 3) == -1
        clock.t += 11.0
        assert pol.decide({"p99_ms": 1.0, "queue_depth": 0.0,
                           "shed_rate": 0.0}, 1) == 0  # floor
        clock.t += 11.0
        assert pol.decide({"p99_ms": None, "queue_depth": 100.0,
                           "shed_rate": None}, 4) == 0  # ceiling

    def test_scale_up_on_queue_pressure(self):
        clock = _Clock()
        pol = AutoscalePolicy(min_replicas=2, max_replicas=4,
                              queue_high=2.0, cooldown_s=1.0,
                              clock=clock)
        fleet, engines = sim_fleet(2, autoscale=pol)
        try:
            for eng in engines.values():
                eng.mode = "hold"
            futs = [fleet.submit(f"p{i}") for i in range(16)]
            clock.t += 2.0
            fleet.maintain()
            assert len(fleet.replica_ids(ACTIVE)) == 3
            assert engines["replica2"].warmups == 1  # warmed before traffic
            for eng in engines.values():
                eng.release_all()
            for f in futs:
                f.result(5)
        finally:
            fleet.close()

    def test_scale_down_never_drops_accepted_work(self):
        sink = InMemorySink()
        tel = _telemetry(sink)
        fleet, engines = sim_fleet(3, telemetry=tel)
        try:
            engines["replica0"].mode = "hold"
            sess = session_for(fleet, "replica0")
            futs = [fleet.submit(f"p{i}", session=sess) for i in range(5)]
            fleet.scale_down("replica0")
            # voluntary drain: the queued work COMPLETED on the retiring
            # replica (close(drain=True)), nothing was re-routed or lost
            for i, f in enumerate(futs):
                rid, payload = f.result(5)
                assert rid == "replica0"
                assert payload == f"p{i}"
            assert fleet.router.reroutes_total == 0
            assert "replica0" not in fleet.replica_ids()
            events = [r.get("event") for r in sink.records
                      if r.get("type") == "event"]
            assert "worker_left" in events  # voluntary, never worker_lost
            assert "worker_lost" not in events
            assert "fleet_scale_down" in events
        finally:
            fleet.close()



# --------------------------------------------------------------------------
# observability: the fleet's records and traces
# --------------------------------------------------------------------------
class TestFleetObservability:
    def test_serving_fleet_record_validates(self):
        sink = InMemorySink()
        tel = _telemetry(sink)
        fleet, engines = sim_fleet(3, telemetry=tel, drain_grace_s=0.0)
        try:
            engines["replica0"].mode = "hold"
            sess = session_for(fleet, "replica0")
            fut = fleet.submit("x", session=sess)
            fleet.fail("replica0")
            fut.result(5)
            fleet.maintain()
            for r in sink.records:
                validate_record(r)
            last = [r for r in sink.records
                    if r["type"] == "serving_fleet"][-1]
            assert last["replicas_alive"] == 2
            assert last["reroutes_total"] == 1 and last["drains_total"] == 1
            assert "replica1" in last["replica_queue_depth"]
            drained = [r for r in sink.records
                       if r.get("event") == "replica_drained"]
            # a crash closes the engine first: its queued request fails
            # over through the router's callback inside the drain
            assert len(drained) == 1 and drained[0]["crash"] is True
            assert drained[0]["in_flight"] == 1
        finally:
            fleet.close()

    def test_fleet_request_outcome_traces(self):
        # a drain that FAILS a request leaves one caller-visible record
        sink = InMemorySink()
        tel = _telemetry(sink)
        fleet, engines = sim_fleet(2, telemetry=tel, drain_grace_s=0.0)
        try:
            engines["replica0"].mode = "hold"
            sess = session_for(fleet, "replica0")
            fut = fleet.submit("x", session=sess, idempotent=False)
            fleet.fail("replica0")
            with pytest.raises(ServingReroutedError):
                fut.result(5)
            traces = [r for r in sink.records if r.get("type") == "trace"]
            bad = [r for r in traces if r.get("status") == "error"
                   and r.get("kind") == "fleet_request"]
            assert len(bad) == 1
            assert "ServingReroutedError" in bad[0]["error"]
            assert bad[0]["replica_id"] == "replica0"
            assert bad[0]["session_id"] == sess
            assert bad[0]["idempotent"] is False
            for r in sink.records:
                validate_record(r)
        finally:
            fleet.close()

    def test_registry_events_carry_serving_role(self):
        sink = InMemorySink()
        tel = _telemetry(sink)
        fleet, _ = sim_fleet(2, telemetry=tel, drain_grace_s=0.0)
        try:
            fleet.fail("replica0")
            lost = next(r for r in sink.records
                        if r.get("event") == "worker_lost")
            assert lost["role"] == "serving"
        finally:
            fleet.close()

    def test_queue_timeout_counted_exactly_once(self):
        sink = InMemorySink()
        tel = _telemetry(sink)
        fleet, engines = sim_fleet(2, telemetry=tel)
        try:
            engines["replica0"].mode = "hold"
            sess = session_for(fleet, "replica0")
            fut = fleet.submit("x", deadline_ms=100.0, session=sess)
            time.sleep(0.15)  # budget gone
            engines["replica0"].fail_all(ServingTimeoutError(
                "deadline lapsed in the serving queue"))
            with pytest.raises(ServingTimeoutError):
                fut.result(5)
            fleet_traces = [r for r in sink.records
                            if r.get("type") == "trace"
                            and r.get("kind") == "fleet_request"]
            assert len(fleet_traces) == 1
            assert fleet_traces[0]["status"] == "timeout"
        finally:
            fleet.close()

    def test_failed_reroute_attempt_not_counted_as_reroute(self):
        fleet, engines = sim_fleet(2)
        try:
            engines["replica0"].mode = "fail"
            engines["replica0"].exc = ServingUnavailableError
            engines["replica1"].closed = True
            sess = session_for(fleet, "replica0")
            with pytest.raises(ServingUnavailableError):
                fleet.submit("x", session=sess).result(5)
            counters = fleet.fleet_counters()
            assert counters["reroutes_total"] == 0
            assert counters["reroute_failed_total"] == 1
        finally:
            fleet.close()

    def test_serving_fleet_record_validates_and_renders(self):
        sink, prom = InMemorySink(), PrometheusTextSink()
        tel = _telemetry(sink, prom)
        fleet, engines = sim_fleet(3, telemetry=tel, drain_grace_s=0.0)
        try:
            engines["replica0"].mode = "hold"
            sess = session_for(fleet, "replica0")
            fut = fleet.submit("x", session=sess)
            fleet.fail("replica0")
            fut.result(5)
            fleet.maintain()
            for r in sink.records:
                validate_record(r)
            render = prom.render()
            assert "bigdl_tpu_serving_fleet_replicas_alive 2" in render
            assert "bigdl_tpu_serving_fleet_reroutes_total 1" in render
            assert "bigdl_tpu_serving_fleet_drains_total 1" in render
            assert 'serving_fleet_replica_queue_depth{replica="replica1"}' \
                in render
        finally:
            fleet.close()

    def test_worker_left_updates_fleet_gauges(self):
        prom = PrometheusTextSink()
        fleet, _ = sim_fleet(3, telemetry=_telemetry(prom))
        try:
            fleet.scale_down("replica0")
            render = prom.render()
            assert "bigdl_tpu_workers_alive 2" in render
            assert "bigdl_tpu_workers_total 2" in render
        finally:
            fleet.close()

    def test_slo_mttr_recovers_on_ok_trace(self):
        engine = SloEngine(default_slos(mttr_s=60.0))
        t0 = 1000.0
        engine.emit({"type": "event", "event": "worker_lost",
                     "worker": "replica1", "role": "serving", "time": t0})
        engine.emit({"type": "trace", "trace_id": "ab", "status": "ok",
                     "kind": "serving_request", "latency_ms": 5.0,
                     "time": t0 + 3.0})
        engine.finalize()
        mttr = next(s for s in engine.status()
                    if s["slo"] == "training_mttr")
        assert (mttr["good"], mttr["bad"]) == (1, 0)
        engine2 = SloEngine(default_slos(mttr_s=60.0))
        engine2.emit({"type": "event", "event": "worker_lost",
                      "worker": "replica1", "role": "serving", "time": t0})
        engine2.finalize()
        assert "training_mttr" in engine2.violated()

    def test_slo_mttr_recovery_proof_matches_worker_domain(self):
        t0 = 1000.0
        eng = SloEngine(default_slos(mttr_s=60.0))
        eng.emit({"type": "event", "event": "worker_lost",
                  "worker": "worker0", "time": t0})
        eng.emit({"type": "trace", "trace_id": "x", "status": "ok",
                  "kind": "serving_request", "latency_ms": 5.0,
                  "time": t0 + 1.0})
        eng.finalize()
        assert "training_mttr" in eng.violated()
        eng2 = SloEngine(default_slos(mttr_s=60.0))
        eng2.emit({"type": "event", "event": "worker_lost",
                   "worker": "replica1", "role": "serving", "time": t0})
        eng2.emit({"type": "step", "step": 5, "time": t0 + 1.0})
        eng2.finalize()
        assert "training_mttr" in eng2.violated()

    def test_slo_skips_fleet_transient_engine_records_only(self):
        engine = SloEngine(default_slos())
        engine.emit({"type": "trace", "trace_id": "a1", "status": "ok",
                     "kind": "serving_request", "latency_ms": 5.0,
                     "time": 1.0})
        for i, status in enumerate(("cancelled", "shed", "timeout")):
            engine.emit({"type": "trace", "trace_id": f"a{2 + i}",
                         "status": status, "kind": "serving_request",
                         "replica_id": "replica0", "latency_ms": 5.0,
                         "time": 2.0 + i})
        err = next(s for s in engine.status()
                   if s["slo"] == "serving_errors")
        assert (err["good"], err["bad"]) == (1, 0)
        engine.emit({"type": "trace", "trace_id": "a5", "status": "error",
                     "kind": "serving_request", "replica_id": "replica0",
                     "latency_ms": 5.0, "time": 5.0})
        engine.emit({"type": "trace", "trace_id": "a6", "status": "timeout",
                     "kind": "fleet_request", "replica_id": "replica0",
                     "latency_ms": 5.0, "time": 6.0})
        engine.emit({"type": "trace", "trace_id": "a7",
                     "status": "cancelled", "kind": "serving_request",
                     "latency_ms": 5.0, "time": 7.0})
        err = next(s for s in engine.status()
                   if s["slo"] == "serving_errors")
        assert (err["good"], err["bad"]) == (1, 3)

    def test_close_time_failures_visible_to_slo(self):
        """The SLO half of the case below: callers failed by a drainless
        close burn the error budget (the engines' cancelled records are
        skipped, the router's count)."""
        sink = InMemorySink()
        tel = _telemetry(sink)
        fleet, engines = sim_fleet(2, telemetry=tel)
        engines["replica0"].mode = "hold"
        engines["replica1"].mode = "hold"
        futs = [fleet.submit(f"p{i}") for i in range(4)]
        fleet.close(drain=False)
        for f in futs:
            with pytest.raises(EngineClosedError):
                f.result(5)
        slo_eng = SloEngine(default_slos())
        for r in sink.records:
            slo_eng.emit(r)
        err = next(s for s in slo_eng.status()
                   if s["slo"] == "serving_errors")
        assert err["bad"] == 4

    def test_total_admission_outage_visible_to_slo(self):
        sink = InMemorySink()
        tel = _telemetry(sink)
        fleet, _ = sim_fleet(2, telemetry=tel, drain_grace_s=0.0)
        try:
            fleet.fail("replica0")
            fleet.fail("replica1")
            with pytest.raises(ServingUnavailableError):
                fleet.submit("x")
        finally:
            fleet.close()
        slo_eng = SloEngine(default_slos())
        for r in sink.records:
            slo_eng.emit(r)
        slo_eng.finalize()
        err = next(s for s in slo_eng.status()
                   if s["slo"] == "serving_errors")
        assert err["bad"] == 1 and "serving_errors" in slo_eng.violated()

    def test_close_time_failures_are_traced(self):
        sink = InMemorySink()
        tel = _telemetry(sink)
        fleet, engines = sim_fleet(2, telemetry=tel)
        engines["replica0"].mode = "hold"
        engines["replica1"].mode = "hold"
        futs = [fleet.submit(f"p{i}") for i in range(4)]
        fleet.close(drain=False)
        for f in futs:
            with pytest.raises(EngineClosedError):
                f.result(5)
        cancelled = [r for r in sink.records if r.get("type") == "trace"
                     and r.get("kind") == "fleet_request"
                     and r.get("status") == "cancelled"]
        assert len(cancelled) == 4

    def test_concurrent_restore_claims_once(self):
        fleet, engines = sim_fleet(2, drain_grace_s=0.0)
        try:
            fleet.fail("replica0")
            results = []
            barrier = threading.Barrier(2)

            def worker():
                barrier.wait()
                results.append(fleet.restore("replica0"))

            threads = [threading.Thread(target=worker) for _ in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert sorted(results) == [False, True]  # one claim wins
            sess = session_for(fleet, "replica0")
            rid, _ = fleet.submit("x", session=sess).result(5)
            assert rid == "replica0"
        finally:
            fleet.close()

    def test_scale_down_noop_not_counted(self):
        fleet, _ = sim_fleet(2)
        try:
            assert fleet.scale_down("no-such-replica") is None
            assert fleet.fleet_counters()["scale_downs_total"] == 0
        finally:
            fleet.close()

    def test_total_admission_outage_is_traced(self):
        sink = InMemorySink()
        tel = _telemetry(sink)
        fleet, _ = sim_fleet(2, telemetry=tel, drain_grace_s=0.0)
        try:
            fleet.fail("replica0")
            fleet.fail("replica1")
            with pytest.raises(ServingUnavailableError):
                fleet.submit("x")
            shed = [r for r in sink.records if r.get("type") == "trace"
                    and r.get("kind") == "fleet_request"
                    and r.get("status") == "shed"]
            assert len(shed) == 1
            assert fleet.health()["status"] == "down"
        finally:
            fleet.close()
        assert fleet.health()["status"] == "closed"

    def test_restore_refused_after_close(self):
        fleet, _ = sim_fleet(2)
        fleet.close()
        assert fleet.restore("replica0") is False

    def test_rejections_feed_autoscale_pressure(self):
        clock = _Clock()
        pol = AutoscalePolicy(min_replicas=2, max_replicas=4,
                              queue_high=1e9, shed_high=0.1,
                              cooldown_s=1.0, clock=clock)
        fleet, engines = sim_fleet(2, autoscale=pol)
        try:
            for eng in engines.values():
                eng.stats_override = {"queue_depth": 0, "submitted": 100,
                                      "shed": 0, "rejected": 50}
                eng.stats = lambda o=eng.stats_override: o
            clock.t += 2.0
            fleet.maintain()
            assert len(fleet.replica_ids(ACTIVE)) == 3
        finally:
            fleet.close()

    def test_router_policy_classification(self):
        pol = default_router_policy()
        assert pol.is_transient(ServingUnavailableError("shed"))
        assert pol.is_transient(ServingTimeoutError("lapsed"))
        assert pol.is_transient(EngineClosedError("closed"))
        assert pol.is_transient(TransientInjectedFault("chaos"))
        assert not pol.is_transient(ServingError("forward failed"))
        assert not pol.is_transient(ValueError("shape"))
        assert not pol.is_transient(RuntimeError("unknown"))

    def test_stats_sum_the_replicas(self):
        fleet, engines = sim_fleet(3)
        try:
            for i in range(6):
                fleet.submit(f"p{i}").result(5)
            s = fleet.stats()
            assert s["engines"]["submitted"] == 6 and s["routed_total"] == 6
            assert fleet.health()["status"] == "ok"
        finally:
            fleet.close()


class TestHashRing:
    def test_walk_deterministic_and_complete(self):
        ring = _HashRing(vnodes=16)
        for rid in ("a", "b", "c"):
            ring.add(rid)
        assert sorted(ring.walk("key")) == ["a", "b", "c"]
        assert list(ring.walk("key")) == list(ring.walk("key"))
        ring.remove("b")
        assert sorted(ring.walk("key")) == ["a", "c"]


# --------------------------------------------------------------------------
# real engines on the CPU
# --------------------------------------------------------------------------
def _mlp():
    return (nn.Sequential().add(nn.Linear(8, 16, device="cpu"))
            .add(nn.Tanh()).add(nn.Linear(16, 4, device="cpu")))


class TestRealEngineFleet:
    def test_crash_under_load_zero_lost_zero_duplicates(self):
        model = _mlp()
        rs = np.random.RandomState(0)
        n_req = 64
        feats = [rs.rand(8).astype(np.float32) for _ in range(n_req)]
        # each request's own expected row: a duplicate or crosstalk would
        # pair a future with another request's row
        expected = np.stack(LocalPredictor(model, batch_size=4,
                                           device="cpu").predict(
            np.stack(feats)))
        sink = InMemorySink()
        tel = _telemetry(sink)
        fleet = ServingFleet(
            model, n_replicas=3, warmup_sample=Sample(feats[0]),
            telemetry=tel, drain_grace_s=0.5, lease_s=60.0,
            engine_kwargs={"max_batch_size": 4, "max_wait_ms": 1.0,
                           "buckets": [2, 4], "device": "cpu"})
        outcomes = {"ok": 0, "timeout": 0, "rerouted": 0, "other": 0}
        mism = []
        lock = threading.Lock()
        start = threading.Barrier(5)

        def client(k):
            start.wait()
            for i in range(k, n_req, 4):
                try:
                    out = fleet.submit(Sample(feats[i]),
                                       deadline_ms=20_000.0,
                                       session=f"c{k}").result(30)
                    with lock:
                        outcomes["ok"] += 1
                        if not np.allclose(out, expected[i], atol=1e-5):
                            mism.append(i)
                except ServingReroutedError:
                    with lock:
                        outcomes["rerouted"] += 1
                except (ServingTimeoutError, FuturesTimeoutError):
                    with lock:
                        outcomes["timeout"] += 1
                except Exception:
                    with lock:
                        outcomes["other"] += 1

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        try:
            for t in threads:
                t.start()
            start.wait()
            time.sleep(0.05)  # traffic flowing, then the crash
            fleet.fail("replica1")
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads)
        finally:
            fleet.close()
        assert sum(outcomes.values()) == n_req
        assert outcomes["other"] == 0
        assert mism == []
        assert fleet.fleet_counters()["drains_total"] == 1
        events = [r.get("event") for r in sink.records
                  if r.get("type") == "event"]
        assert "worker_lost" in events and "replica_drained" in events
        rids = {r.get("replica_id") for r in sink.records
                if r.get("type") == "trace" and "replica_id" in r}
        assert rids & {"replica0", "replica1", "replica2"}
        for r in sink.records:
            validate_record(r)

    def test_per_replica_trace_lanes_merge_into_one_file(self, tmp_path):
        import json
        s = Sample(np.ones(8, np.float32))
        fleet = ServingFleet(
            _mlp(), n_replicas=2, warmup_sample=s, trace=True,
            engine_kwargs={"max_batch_size": 2, "max_wait_ms": 0.5,
                           "buckets": [2], "device": "cpu"})
        try:
            for i in range(8):
                fleet.predict(s, timeout=10, session=f"s{i}")
            path = str(tmp_path / "fleet.trace.json")
            fleet.export_trace(path)
        finally:
            fleet.close()
        doc = json.loads(open(path).read())
        names = {e["args"]["name"] for e in doc["traceEvents"]
                 if e.get("name") == "process_name"}
        assert {"serving:replica0", "serving:replica1"} <= names
        assert len({e["pid"] for e in doc["traceEvents"]}) >= 2

    def test_bench_serve_fleet_contract(self, tmp_path, monkeypatch):
        """The reference's contract over the port's drill (its served
        ResNet-50, at 32x32 on the CPU) with a crash: every request
        resolves, one drain, and the stream it writes under
        `$BIGDL_TPU_TELEMETRY` passes the gate a chaos run is held to,
        with the latency ceiling at the drill's deadline, as the
        reference's replay drill arms `default_slos(latency_p99_ms=
        deadline_ms)`. The default 100 ms ceiling is the one of the
        reference's fleet of a 784-64-10 MLP; at it the ResNet-50 drill
        fails on latency alone."""
        import io

        from bigdl_tpu_torch.tools import bench
        from bigdl_tpu_torch.tools.metrics_cli import slo
        stem = str(tmp_path / "serve_fleet")
        monkeypatch.setenv(bench.TELEMETRY_ENV, stem)
        deadline_ms = 15_000.0
        out = bench.bench_serve_fleet(replicas=3, clients=3,
                                      requests_per_client=20, crash=True,
                                      deadline_ms=deadline_ms,
                                      device="cpu", image_hw=32)
        assert out["metric"] == "serve_fleet"
        assert out["recovered"] is True
        assert out["ok"] + out["timed_out"] + out["rerouted"] \
            == out["requests"]
        assert out["drains"] == 1
        assert slo([stem + ".jsonl"], check=True, mttr_s=60.0,
                   latency_p99_ms=deadline_ms, out=io.StringIO()) == 0
        table = io.StringIO()
        assert slo([stem + ".jsonl"], check=True, mttr_s=60.0,
                   out=table) == 1
        assert "VIOLATED: serving_latency_p99\n" in table.getvalue()

    def test_a_replica_that_fails_to_build_closes_the_built_ones(self):
        built = []

        def factory(rid):
            if rid == "replica2":
                raise RuntimeError("no device for replica2")
            eng = SimEngine(rid)
            built.append(eng)
            return eng

        with pytest.raises(RuntimeError, match="replica2"):
            ServingFleet(engine_factory=factory, n_replicas=3)
        assert len(built) == 2 and all(e.closed for e in built)


class TestFleetSoak:
    def test_soak_randomized_kills_zero_lost(self):
        """The reference's 120-replica, 4000-request soak cut to 10
        replicas and 60 requests (a kill every 15)."""
        n_replicas, n_requests = 10, 60
        rng = np.random.RandomState(7)
        fleet, engines = sim_fleet(n_replicas, drain_grace_s=0.0,
                                   lease_s=1e9)
        futs = []
        try:
            killed = []
            marked = None
            for i in range(n_requests):
                futs.append(fleet.submit(
                    f"p{i}", session=f"s{i % 7}", deadline_ms=60_000.0))
                if i % 15 == 7:
                    active = fleet.replica_ids(ACTIVE)
                    if len(active) > n_replicas // 2:
                        marked = active[int(rng.randint(len(active)))]
                        engines[marked].mode = "hold"
                if i % 15 == 14:
                    if marked is not None:
                        fleet.fail(marked)
                        killed.append(marked)
                        marked = None
                    if killed and rng.rand() < 0.4:
                        fleet.restore(killed.pop(0))
                    fleet.maintain()
            if marked is not None:
                fleet.fail(marked)
                killed.append(marked)
            ok = rerouted = 0
            for i, f in enumerate(futs):
                try:
                    rid, payload = f.result(30)
                    assert payload == f"p{i}"  # tagged: never crosstalk
                    ok += 1
                except ServingReroutedError:
                    rerouted += 1
            assert ok + rerouted == n_requests
            assert ok > n_requests * 0.9
            assert len(killed) + len(fleet.replica_ids(LOST)) >= 4
        finally:
            fleet.close()


# --------------------------------------------------------------------------
# parity with the JAX package
# --------------------------------------------------------------------------
class TestParityWithJax:
    def test_hash_ring_walks_match(self):
        jr, tr = JHashRing(vnodes=64), _HashRing(vnodes=64)
        for rid in ("replica0", "replica1", "replica2", "replica3"):
            jr.add(rid)
            tr.add(rid)
        keys = [f"session-{i}" for i in range(200)]
        assert [list(tr.walk(k)) for k in keys] == \
            [list(jr.walk(k)) for k in keys]
        jr.remove("replica2")
        tr.remove("replica2")
        assert [list(tr.walk(k)) for k in keys] == \
            [list(jr.walk(k)) for k in keys]

    def test_autoscale_decisions_match(self):
        grid = [{"p99_ms": p, "queue_depth": q, "shed_rate": s}
                for p in (None, 1.0, 60.0, 200.0)
                for q in (None, 0.0, 1.0, 40.0)
                for s in (None, 0.0, 0.05)]
        for n in (1, 2, 4):
            jc, tc = _Clock(), _Clock()
            kw = dict(min_replicas=1, max_replicas=4, p99_high_ms=100.0,
                      queue_high=8.0, shed_high=0.01, queue_low=0.5,
                      cooldown_s=10.0)
            jp = JAutoscalePolicy(clock=jc, **kw)
            tp = AutoscalePolicy(clock=tc, **kw)
            for sig in grid:
                jc.t += 11.0
                tc.t += 11.0
                assert tp.decide(sig, n) == jp.decide(sig, n), (sig, n)
                jc.t += 1.0  # inside the cooldown: 0 from both
                tc.t += 1.0
                assert tp.decide(sig, n) == jp.decide(sig, n) == 0

    def test_scripted_scenario_matches_the_jax_fleet(self):
        """The same script through both fleets over the same weights:
        every decision is taken on a quiesced fleet (engines staged with
        start=False, maintain() by the owner, an injected clock)."""
        rs = np.random.RandomState(3)
        feats = [rs.rand(8).astype(np.float32) for _ in range(12)]
        tmodel = _mlp()
        jm = (jnn.Sequential().add(jnn.Linear(8, 16)).add(jnn.Tanh())
              .add(jnn.Linear(16, 4)))
        jm.set_params(jax.tree_util.tree_map(jnp.asarray,
                                             module_params_tree(tmodel)))

        def run(pkg):
            port = pkg == "port"
            clock = _Clock()
            sink = InMemorySink() if port else JInMemorySink()
            tel = _telemetry(sink) if port else \
                JTelemetry(sink, resources=False)
            kw = {"max_batch_size": 4, "max_wait_ms": 0.0,
                  "buckets": [2, 4], "start": False}
            if port:
                kw["device"] = "cpu"
            S = Sample if port else JSample
            fleet = (ServingFleet if port else JServingFleet)(
                tmodel if port else jm, n_replicas=3,
                warmup_sample=S(feats[0]), telemetry=tel, lease_s=1.0,
                clock=clock, drain_grace_s=0.0, engine_kwargs=kw, seed=5)
            try:
                futs = [fleet.submit(S(f), session=f"s{i % 5}"
                                     if i % 3 else None)
                        for i, f in enumerate(feats[:8])]
                fleet.maintain()
                fleet.fail("replica1")  # its queue reroutes exactly once
                fleet.suspend_heartbeat("replica2")
                clock.t += 2.0
                fleet.maintain()  # replica2's lease lapses: drained
                for rid in fleet.replica_ids(ACTIVE):
                    fleet._replicas[rid].engine.start()
                futs += [fleet.submit(S(f), session=f"s{i}")
                         for i, f in enumerate(feats[8:])]
                outcomes = []
                for f in futs:
                    try:
                        outcomes.append(np.asarray(f.result(30)))
                    except Exception as e:  # compared by type below
                        outcomes.append(type(e).__name__)
                counters = fleet.fleet_counters()
            finally:
                fleet.close()
            served = sorted((r.get("session_id", ""), r["replica_id"],
                             r["status"]) for r in sink.records
                            if r.get("type") == "trace"
                            and r.get("kind") == "serving_request"
                            and r["status"] == "ok")
            return outcomes, counters, served

        tout, tcount, tserved = run("port")
        jout, jcount, jserved = run("jax")
        assert [o if isinstance(o, str) else "ok" for o in tout] == \
            [o if isinstance(o, str) else "ok" for o in jout]
        ok = [i for i, o in enumerate(tout) if not isinstance(o, str)]
        np.testing.assert_allclose(np.stack([tout[i] for i in ok]),
                                   np.stack([jout[i] for i in ok]),
                                   rtol=0, atol=ROW_ATOL)
        assert tserved == jserved and len(tserved) == len(ok)
        keys = ("drains_total", "reroutes_total", "reroute_failed_total",
                "routed_total", "affinity_routes_total", "replicas_alive")
        assert {k: tcount[k] for k in keys} == {k: jcount[k] for k in keys}
        assert tcount["drains_total"] == 2 and tcount["reroutes_total"] > 0

    def test_token_stream_restart_matches_the_jax_decode(self):
        """A 1-layer LM on two `GenerationEngine` replicas: the stream's
        replica is failed mid-stream (its third decode step held until the
        fail is under way); the survivor restarts from the prompt and the
        spliced stream equals the JAX greedy decode of the same weights."""
        vocab, n_new = 48, 8
        jm = JaxLM(vocab, embed_dim=16, n_layer=1, n_head=2)
        params = jm.ensure_params(jax.random.PRNGKey(1))
        tm = TransformerLM(vocab, embed_dim=16, n_layer=1, n_head=2,
                           device="cpu")
        load_transformer_lm_params(tm, jax.tree_util.tree_map(np.asarray,
                                                              params))
        prompt = np.array([3, 17, 9, 40, 2], np.int32)
        want = jax_reference(jm, params, prompt, n_new)
        # token equality means something only clear of near ties
        seq = np.concatenate([prompt, want[:-1]])[None].astype(np.int32)
        logp = np.asarray(jm.apply(params, jnp.asarray(seq), None))[0]
        top2 = np.sort(logp[prompt.size - 1:], -1)
        assert (top2[:, -1] - top2[:, -2]).min() > 1e-4
        gate = threading.Event()
        steps = [0]

        def held(decode):
            def step(cache, tokens, positions, model=None):
                if model is None:  # a served step, not a FLOP count
                    steps[0] += 1
                    if steps[0] > 2:
                        gate.wait(30)
                return decode(cache, tokens, positions, model)
            return step

        def factory(rid):
            eng = GenerationEngine(tm, slots=2, max_len=32,
                                   max_new_tokens=n_new, device="cpu",
                                   replica_id=rid)
            eng._decode = held(eng._decode)
            return eng

        fleet = ServingFleet(engine_factory=factory, n_replicas=2,
                             drain_grace_s=0.0)
        try:
            stream = fleet.generate(prompt, session="user-3")
            first = stream.replica_id
            got = [stream.get(i, 30) for i in range(3)]
            releaser = threading.Timer(0.2, gate.set)
            releaser.start()
            fleet.fail(first)  # joins the held dispatcher
            releaser.join()
            got += [stream.get(i, 30) for i in range(3, n_new)]
            assert stream.get(n_new, 30) is None
            assert stream.replica_id != first and stream.reroutes == 1
            assert fleet.fleet_counters()["stream_reroutes_total"] == 1
        finally:
            gate.set()
            fleet.close()
        assert got == want
