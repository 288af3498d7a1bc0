"""Port parity: the serving engines' resilience tier
(`bigdl_tpu_torch/resilience/breaker.py`, the breaker, health, fault
sites, replica and session identity and costs of
`bigdl_tpu_torch/serving/engine.py` and `generation.py`, and
`optim.predictor.PredictionService`), after the reference's
`tests/test_resilience.py` breaker cases and `tests/test_generation.py`.

- `CircuitBreaker`: the same scripted clock and outcomes through both
  packages' breakers give the same states, transitions and snapshots.
- `InferenceEngine(breaker=...)`: a poisoned bucket trips, sheds and
  recovers with `health()`, `stats()["shed"]` and the circuit events equal
  to the JAX engine's on the same fault plan; a poisoned shape leaves the
  other domains serving.
- `replica_id` and `session` reach the trace records of both engines.
- `stats()["flops_per_step"]` is `costs.count_flops` of the bucket's
  forward.
- `GenerationEngine`: the prefill breaker sheds after persistent
  failures, a `serve.decode` fault fails each active stream once, and
  `max_wait_ms` holds an underfull prefill open.
- `PredictionService` rows against the JAX `PredictionService` within
  1e-6 (the same f32 arithmetic, ~1e-7 apart).
- `tools/bench.py bench_serve_fleet` at a CPU size: every request
  resolves, the crash drains once and MTTR is measured.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset.sample import Sample as JSample
from bigdl_tpu.observability import InMemorySink as JInMemorySink
from bigdl_tpu.observability import Telemetry as JTelemetry
from bigdl_tpu.optim.predictor import PredictionService as JPrediction
from bigdl_tpu.resilience import FaultInjector as JFaultInjector
from bigdl_tpu.resilience import FaultSpec as JFaultSpec
from bigdl_tpu.resilience.breaker import CircuitBreaker as JBreaker
from bigdl_tpu.serving import InferenceEngine as JInferenceEngine
import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.interop import module_params_tree
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.observability import (InMemorySink, Telemetry, costs,
                                           validate_record)
from bigdl_tpu_torch.optim import PredictionService
from bigdl_tpu_torch.resilience import (CircuitBreaker, FaultInjector,
                                        FaultSpec, known_sites)
from bigdl_tpu_torch.serving import (GenerationEngine, InferenceEngine,
                                     ServingError, ServingUnavailableError)

#: PredictionService rows, port against the JAX package
ROW_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _flight_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_FLIGHT_DIR", str(tmp_path / "flight"))


def _telemetry(sink):
    return Telemetry(sink, resources=False, flight=False)


def _traces(sink):
    return [r for r in sink.records if r.get("type") == "trace"]


def _events(sink):
    return [r["event"] for r in sink.records if r.get("type") == "event"
            and r["event"].startswith("circuit")]


def _pair():
    """A port MLP and its JAX twin with the same weights."""
    t = nn.Sequential().add(nn.Linear(4, 2, device="cpu")) \
        .add(nn.LogSoftMax())
    j = jnn.Sequential().add(jnn.Linear(4, 2)).add(jnn.LogSoftMax())
    j.set_params(jax.tree_util.tree_map(jnp.asarray, module_params_tree(t)))
    return t, j


# ------------------------------------------------------------------ #
# CircuitBreaker
# ------------------------------------------------------------------ #
#: (op, arg) scripts: "fail"/"ok" record an outcome (arg: probe), "allow"
#: asks, "t" sets the clock
SCRIPTS = {
    "trip_shed_probe_close": [("fail", None)] * 3 + [
        ("allow", None), ("allow", None), ("t", 11.0), ("allow", None),
        ("allow", None), ("ok", None), ("allow", None)],
    "streak_reset": [("fail", None), ("fail", None), ("ok", None),
                     ("fail", None), ("fail", None), ("fail", None)],
    "failed_probe_reopens": [("fail", None)] * 3 + [
        ("t", 11.0), ("allow", None), ("fail", None), ("allow", None),
        ("t", 22.0), ("allow", None), ("ok", None)],
    "stale_outcomes": [("fail", None)] * 3 + [
        ("t", 11.0), ("allow", None), ("ok", False), ("fail", False),
        ("allow", None), ("ok", True)],
    "two_probes": [("fail", None)] * 3 + [
        ("t", 11.0), ("allow", None), ("ok", None), ("allow", None),
        ("ok", None), ("allow", None)],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_breaker_matches_the_reference(script):
    runs = []
    for cls in (JBreaker, CircuitBreaker):
        clock, transitions, trail = [0.0], [], []
        br = cls(failure_threshold=3, reset_timeout_s=10.0,
                 probe_successes=2 if script == "two_probes" else 1,
                 clock=lambda: clock[0], name="b2[4:float32]",
                 on_transition=lambda o, n, b: transitions.append((o, n)))
        for op, arg in SCRIPTS[script]:
            if op == "t":
                clock[0] = arg
            elif op == "allow":
                trail.append(br.allow())
            elif op == "ok":
                br.record_success(probe=arg)
            else:
                br.record_failure(probe=arg)
            trail.append((br.state, br.snapshot()))
        runs.append((trail, transitions))
    assert runs[0] == runs[1]
    assert runs[1][1]  # every script moves the state machine


def test_breaker_rejects_bad_thresholds():
    for kw in ({"failure_threshold": 0}, {"probe_successes": 0}):
        with pytest.raises(ValueError):
            CircuitBreaker(**kw)


# ------------------------------------------------------------------ #
# InferenceEngine
# ------------------------------------------------------------------ #
def _breaker(clock):
    return {"failure_threshold": 3, "reset_timeout_s": 5.0,
            "probe_successes": 1, "clock": lambda: clock[0]}


def test_poisoned_bucket_trips_sheds_and_recovers_as_the_reference():
    t, j = _pair()
    good = np.ones(4, np.float32)
    runs = {}
    for pkg in ("jax", "port"):
        port = pkg == "port"
        clock = [0.0]
        sink = InMemorySink() if port else JInMemorySink()
        kw = dict(max_batch_size=4, max_wait_ms=0.5, emit_every=10 ** 6,
                  breaker=_breaker(clock))
        if port:
            eng = InferenceEngine(t, telemetry=_telemetry(sink),
                                  device="cpu", **kw)
            plan = FaultInjector(FaultSpec("serve.forward", times=3,
                                           exc=RuntimeError))
            sample = good
        else:
            eng = JInferenceEngine(j, telemetry=JTelemetry(
                sink, resources=False), **kw)
            plan = JFaultInjector(JFaultSpec("serve.forward", times=3,
                                             exc=RuntimeError))
            sample = JSample(good)
        seen = []
        try:
            with plan:
                for _ in range(3):
                    with pytest.raises(ServingError if port else
                                       Exception):
                        eng.predict(sample, timeout=30)
                with pytest.raises(Exception) as shed:
                    eng.predict(sample, timeout=30)
                seen.append(type(shed.value).__name__)
                health = eng.health()
                for snap in health["breakers"].values():
                    snap.pop("open_for_s")
                seen.append(health)
                seen.append(eng.stats()["shed"])
                clock[0] = 6.0
                seen.append(np.asarray(eng.predict(sample, timeout=30)))
            seen.append(plan.hits("serve.forward"))
            seen.append(eng.health()["status"])
        finally:
            eng.close()
        seen.append(_events(sink))
        runs[pkg] = seen
    want, got = runs["jax"], runs["port"]
    assert got[0] == want[0] == "ServingUnavailableError"
    assert got[1] == want[1] and got[1]["status"] == "degraded"
    assert got[1]["open_buckets"] == ["b2[4:float32]"]
    assert got[2] == want[2] == 1
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=ROW_ATOL)
    assert got[4:] == want[4:] == [
        4, "ok", ["circuit_open", "circuit_half_open", "circuit_close"]]


def test_degraded_bucket_leaves_other_buckets_serving():
    clock = [0.0]
    t, _ = _pair()
    good = np.ones(4, np.float32)
    bad = np.ones(7, np.float32)  # the wrong feature width: forward fails
    eng = InferenceEngine(t, max_batch_size=4, max_wait_ms=0.5,
                          breaker=_breaker(clock), device="cpu")
    try:
        assert eng.predict(good, timeout=30).shape == (2,)
        for _ in range(3):
            with pytest.raises(ServingError):
                eng.predict(bad, timeout=30)
        with pytest.raises(ServingUnavailableError):
            eng.predict(bad, timeout=30)
        assert eng.predict(good, timeout=30).shape == (2,)
        health = eng.health()
        assert health["status"] == "degraded"
        assert health["open_buckets"] == ["b2[7:float32]"]
        assert health["breakers"]["b2[4:float32]"]["state"] == "closed"
    finally:
        eng.close()
    assert eng.health()["status"] == "closed"


def test_serve_forward_site_carries_its_context():
    assert "serve.forward" in known_sites()
    t, _ = _pair()
    seen = []
    plan = FaultInjector(FaultSpec(
        "serve.forward", exc=RuntimeError,
        when=lambda ctx: seen.append(ctx) or ctx["bucket"] == 4))
    with InferenceEngine(t, max_batch_size=4, max_wait_ms=0.0,
                         device="cpu", start=False) as eng:
        futs = [eng.submit(np.ones(4, np.float32)) for _ in range(3)]
        with plan:
            eng.start()
            with pytest.raises(ServingError):
                futs[0].result(30)
    assert seen[0]["n"] == 3 and seen[0]["bucket"] == 4
    assert seen[0]["sig"] == (((4,), "float32"),)


def test_replica_and_session_reach_the_trace_records():
    t, _ = _pair()
    sink = InMemorySink()
    with InferenceEngine(t, max_batch_size=4, max_wait_ms=0.0,
                         telemetry=_telemetry(sink), replica_id="replica3",
                         device="cpu") as eng:
        eng.submit(np.ones(4, np.float32), session="user-1").result(30)
        eng.submit(np.ones(4, np.float32)).result(30)
    recs = _traces(sink)
    assert [r["replica_id"] for r in recs] == ["replica3"] * 2
    assert recs[0]["session_id"] == "user-1" and "session_id" not in recs[1]
    lm = TransformerLM(32, embed_dim=16, n_layer=1, n_head=2, device="cpu")
    sink = InMemorySink()
    with GenerationEngine(lm, slots=2, max_len=16, max_new_tokens=2,
                          telemetry=_telemetry(sink), replica_id="replica5",
                          device="cpu") as eng:
        eng.generate(np.array([1, 2, 3]), session=42).result(30)
    (rec,) = _traces(sink)
    assert rec["replica_id"] == "replica5" and rec["session_id"] == "42"
    for r in sink.records:
        validate_record(r)


def test_flops_per_step_is_the_bucket_forward():
    t = nn.Sequential().add(nn.Linear(6, 5, device="cpu")).add(nn.Tanh()) \
        .add(nn.Linear(5, 3, device="cpu"))
    with InferenceEngine(t, max_batch_size=4, max_wait_ms=0.0,
                         device="cpu") as eng:
        eng.predict(np.ones(6, np.float32), timeout=30)  # bucket 2
        stats = eng.stats()
        want = costs.count_flops(eng.model, torch.ones(2, 6))
    assert stats["flops_per_step"] == want == 2 * 2 * (6 * 5 + 5 * 3)
    assert stats["bytes_accessed"] is None and stats["mfu"] is None


# ------------------------------------------------------------------ #
# GenerationEngine
# ------------------------------------------------------------------ #
def _lm():
    return TransformerLM(32, embed_dim=16, n_layer=1, n_head=2, device="cpu",
                         generator=torch.Generator().manual_seed(0))


def test_prefill_breaker_sheds_after_persistent_failures():
    with GenerationEngine(_lm(), slots=2, max_len=32, device="cpu",
                          breaker={"failure_threshold": 2,
                                   "reset_timeout_s": 3600.0}) as eng:
        prompt = np.array([1, 2, 3], np.int32)
        with FaultInjector(FaultSpec("serve.forward", times=10)):
            for _ in range(2):
                with pytest.raises(ServingError):
                    eng.generate(prompt, max_new_tokens=2).result(60.0)
            st = eng.generate(prompt, max_new_tokens=2)
            with pytest.raises(ServingUnavailableError):
                st.result(60.0)
            assert st.status == "shed"
        health = eng.health()
        assert health["status"] == "degraded"
        assert health["open_buckets"] == ["b2[8:int32]"]
        assert eng.stats()["shed"] == 1


def test_decode_fault_fails_each_active_stream_once():
    prompt = np.array([2, 7, 4], np.int32)
    with GenerationEngine(_lm(), slots=2, max_len=32, device="cpu",
                          start=False) as eng:
        streams = [eng.generate(prompt, max_new_tokens=6),
                   eng.generate(np.array([5, 6], np.int32),
                                max_new_tokens=6)]
        with FaultInjector(FaultSpec("serve.decode", at_hit=1)):
            eng.start()
            for st in streams:
                with pytest.raises(ServingError):
                    st.result(60.0)
                assert st.status == "error"
        assert eng.stats()["failed"] == 2
        out = eng.generate(prompt, max_new_tokens=6).result(60.0)
    assert len(out) == 6


def test_max_wait_ms_holds_an_underfull_prefill_open():
    batches = {}
    for wait in (0.0, 300.0):
        with GenerationEngine(_lm(), slots=4, max_len=32, prefill_batch=2,
                              max_new_tokens=2, max_wait_ms=wait,
                              device="cpu") as eng:
            if wait:
                eng.generate(np.array([1, 2]))
                time.sleep(0.1)  # inside the window: one prefill of two
                eng.generate(np.array([3, 4])).result(60)
            else:
                eng.generate(np.array([1, 2])).result(60)
                eng.generate(np.array([3, 4])).result(60)
            batches[wait] = eng.generation_stats()["prefill_batches"]
    assert batches == {0.0: 2, 300.0: 1}


# ------------------------------------------------------------------ #
# PredictionService and the fleet drill
# ------------------------------------------------------------------ #
def test_prediction_service_matches_the_reference():
    t, j = _pair()
    rs = np.random.RandomState(0)
    xs = rs.rand(10, 4).astype(np.float32)
    got = [None] * len(xs)
    with PredictionService(t, batch_size=4, device="cpu") as svc:
        assert svc.engine.max_wait_s == 0.0 and svc.model is not t

        def client(i):
            got[i] = svc.predict(xs[i], timeout=30)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(xs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        batches = svc.engine.stats()["batches"]
    with JPrediction(j, batch_size=4) as jsvc:
        want = [jsvc.predict(JSample(x), timeout=30) for x in xs]
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=0,
                               atol=ROW_ATOL)
    assert batches <= len(xs)


def test_bench_serve_fleet_contract():
    from bigdl_tpu_torch.tools.bench import bench_serve_fleet
    out = bench_serve_fleet(replicas=3, clients=3, requests_per_client=8,
                            crash=True, device="cpu", image_hw=32)
    assert out["metric"] == "serve_fleet" and out["device"] == "cpu"
    assert out["ok"] + out["timed_out"] + out["rerouted"] == \
        out["requests"] == 24
    assert out["other"] == 0 and out["recovered"] is True
    assert out["drains"] == 1 and out["mttr_s"] is not None
    assert out["requests_per_sec"] > 0 and out["latency_ms_p99"] > 0
