"""Port parity: request tracing in the serving engines and the span
tracer's identity and lanes, after `tests/test_tracing_slo.py` (its SLO
cases aside: `slo` is not ported).

- `TraceContext` propagation through nested spans, `begin_trace` /
  `end_trace` (idempotent, joining an enclosing trace, superseding a
  crashed run's root), process lanes and `merge_traces`.
- `InferenceEngine` and `GenerationEngine` with a `Telemetry` and a
  `SpanTracer`: one `trace` record per request, whose phases add up to
  its latency, with the same fields as the reference engine's record of
  the same request; a queue timeout, a drainless close's cancellations
  and a failed batch trace too; `trace_sample` sheds records and spans;
  `serving_stats`, `serving_summary` and `generation` records validate;
  a failing sink (or a `telemetry.sink` fault) never stops serving; an
  engine with neither attached mints no trace identity.
"""

import threading
import time

import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset.sample import Sample as JSample
from bigdl_tpu.observability import InMemorySink as JInMemorySink
from bigdl_tpu.observability import Telemetry as JTelemetry
from bigdl_tpu.serving import InferenceEngine as JInferenceEngine
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.observability import (InMemorySink, SpanTracer,
                                           Telemetry, TraceContext,
                                           merge_traces, validate_record)
from bigdl_tpu_torch.resilience import FaultInjector, FaultSpec
from bigdl_tpu_torch.serving import GenerationEngine, InferenceEngine


@pytest.fixture(autouse=True)
def _flight_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_FLIGHT_DIR", str(tmp_path / "flight"))


def _model():
    return tnn.Sequential().add(tnn.Linear(4, 2, device="cpu")) \
        .add(tnn.LogSoftMax())


def _spans(tracer, name=None):
    evs = [e for e in tracer.events if e["ph"] == "X"]
    return evs if name is None else [e for e in evs if e["name"] == name]


def _telemetry(sink):
    return Telemetry(sink, resources=False, flight=False)


def _traces(sink):
    return [r for r in sink.records if r["type"] == "trace"]


# ------------------------------------------------------------------ #
# TraceContext and span identity
# ------------------------------------------------------------------ #
def test_new_trace_and_child_ids():
    root = TraceContext.new_trace()
    assert root.parent_id is None
    kid = root.child()
    assert kid.trace_id == root.trace_id
    assert kid.parent_id == root.span_id and kid.span_id != root.span_id
    assert kid.ids() == {"trace_id": root.trace_id, "span_id": kid.span_id,
                         "parent_id": root.span_id}


def test_spans_without_context_stay_identity_free():
    tr = SpanTracer(process_name="ctx-free", annotate=False)
    with tr.span("plain", kind="phase"):
        pass
    (ev,) = _spans(tr)
    assert ev["args"] == {"kind": "phase"}


def test_trace_propagates_to_nested_spans():
    tr = SpanTracer(process_name="ctx-prop", annotate=False)
    with tr.trace("root") as ctx:
        with tr.span("child"):
            with tr.span("grandchild"):
                pass
    by_name = {e["name"]: e for e in _spans(tr)}
    assert by_name["root"]["args"]["trace_id"] == ctx.trace_id
    assert by_name["child"]["args"]["trace_id"] == ctx.trace_id
    assert by_name["child"]["args"]["parent_id"] == ctx.span_id
    assert by_name["grandchild"]["args"]["parent_id"] == \
        by_name["child"]["args"]["span_id"]
    assert tr.current_context() is None


def test_begin_end_trace_is_non_lexical_and_idempotent():
    tr = SpanTracer(process_name="ctx-begin", annotate=False)
    ctx = tr.begin_trace("run", loop="local")
    with tr.span("inside"):
        pass
    tr.end_trace()
    tr.end_trace()
    by_name = {e["name"]: e for e in _spans(tr)}
    assert by_name["inside"]["args"]["trace_id"] == ctx.trace_id
    assert by_name["run"]["args"]["span_id"] == ctx.span_id
    assert tr.current_context() is None


def test_begin_trace_joins_and_restores_an_enclosing_trace():
    tr = SpanTracer(process_name="ctx-nested", annotate=False)
    with tr.trace("experiment") as outer:
        run_ctx = tr.begin_trace("optimize/local")
        assert run_ctx.trace_id == outer.trace_id
        assert run_ctx.parent_id == outer.span_id
        tr.end_trace()
        assert tr.current_context() is outer
        with tr.span("eval"):
            pass
    by_name = {e["name"]: e for e in _spans(tr)}
    assert by_name["eval"]["args"]["parent_id"] == outer.span_id
    assert tr.current_context() is None


def test_a_crashed_runs_root_is_superseded():
    tr = SpanTracer(process_name="ctx-stale", annotate=False)
    stale = tr.begin_trace("optimize/attempt1")  # no end: it crashed
    fresh = tr.begin_trace("optimize/attempt2")
    assert fresh.trace_id != stale.trace_id
    with tr.span("step"):
        pass
    tr.end_trace()
    assert tr.current_context() is None
    assert _spans(tr, "step")[0]["args"]["trace_id"] == fresh.trace_id


# ------------------------------------------------------------------ #
# process lanes
# ------------------------------------------------------------------ #
def test_distinct_names_get_distinct_pids():
    a = SpanTracer(process_name="lane-test-a", annotate=False)
    b = SpanTracer(process_name="lane-test-b", annotate=False)
    assert a.pid != b.pid
    assert SpanTracer(process_name="lane-test-a", annotate=False).pid == a.pid


def test_merge_keeps_lanes_apart(tmp_path):
    from bigdl_tpu_torch.observability import export_merged
    a = SpanTracer(process_name="merge-w0", annotate=False)
    b = SpanTracer(process_name="merge-w1", annotate=False)
    for tr in (a, b):
        with tr.span("work"):
            pass
    doc = merge_traces([a, b])
    assert doc["displayTimeUnit"] == "ms"
    spans = [e for e in doc["traceEvents"]
             if e["ph"] == "X" and e["name"] == "work"]
    assert len(spans) == 2 and spans[0]["pid"] != spans[1]["pid"]
    procs = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e.get("name") == "process_name"}
    assert procs[a.pid] == "merge-w0" and procs[b.pid] == "merge-w1"
    import json
    with open(export_merged(str(tmp_path / "m.json"), [a, b])) as f:
        assert json.load(f) == json.loads(json.dumps(doc))


def test_thread_lanes_carry_thread_names():
    tr = SpanTracer(process_name="lane-threads", annotate=False)

    def work():
        with tr.span("threaded"):
            pass

    t = threading.Thread(target=work, name="my-worker")
    t.start()
    t.join()
    names = {e["args"]["name"] for e in tr.to_chrome_trace()["traceEvents"]
             if e.get("name") == "thread_name"}
    assert "my-worker" in names


# ------------------------------------------------------------------ #
# InferenceEngine
# ------------------------------------------------------------------ #
def test_predict_yields_one_trace_covering_the_lifecycle():
    sink = InMemorySink()
    tr = SpanTracer(process_name="serve-acc", annotate=False)
    eng = InferenceEngine(_model(), max_batch_size=8, max_wait_ms=0.5,
                          telemetry=_telemetry(sink), tracer=tr,
                          device="cpu")
    try:
        eng.warmup(np.ones(4, np.float32))
        eng.predict(np.ones(4, np.float32))
    finally:
        eng.close()
    (rec,) = _traces(sink)
    validate_record(rec)
    assert rec["kind"] == "serving_request" and rec["status"] == "ok"
    path = {p["name"]: p for p in rec["critical_path"]}
    assert set(path) == {"queue", "batch form", "dispatch", "forward",
                         "fetch"}
    assert sum(p["ms"] for p in path.values()) == \
        pytest.approx(rec["latency_ms"], abs=0.01)
    tid = rec["trace_id"]
    mine = [e for e in _spans(tr) if e.get("args", {}).get("trace_id") == tid]
    assert {"request", "queue", "batch form", "dispatch", "forward",
            "fetch"} <= {e["name"] for e in mine}
    root = [e for e in mine if e["name"] == "request"][0]
    for e in mine:
        assert e["ts"] >= root["ts"] - 1
        assert e["ts"] + e["dur"] <= root["ts"] + root["dur"] + 1
    assert {"serve dispatch", "serve fetch"} <= {e["name"]
                                                 for e in _spans(tr)}
    flows = [e for e in tr.events if e["ph"] in ("s", "f")]
    assert {e["ph"] for e in flows} == {"s", "f"}
    assert all(len([e for e in flows if e["id"] == i]) == 2
               for i in {e["id"] for e in flows})
    assert sink.records[-1]["type"] == "serving_summary"
    validate_record(sink.records[-1])


def test_trace_record_has_the_reference_fields():
    """The same request through the reference's engine and the port's:
    the trace records carry the same fields."""
    jsink, sink = JInMemorySink(), InMemorySink()
    jm = jnn.Sequential().add(jnn.Linear(4, 2)).add(jnn.LogSoftMax())
    jeng = JInferenceEngine(jm, max_batch_size=4, max_wait_ms=0.0,
                            telemetry=JTelemetry(jsink, resources=False))
    eng = InferenceEngine(_model(), max_batch_size=4, max_wait_ms=0.0,
                          telemetry=_telemetry(sink), device="cpu")
    try:
        jeng.predict(JSample(np.ones(4, np.float32)), deadline_ms=5e3)
        eng.predict(np.ones(4, np.float32), deadline_ms=5e3)
    finally:
        jeng.close()
        eng.close()
    (want,), (got,) = _traces(jsink), _traces(sink)
    assert set(got) == set(want)
    assert got["deadline_budget_ms"] == want["deadline_budget_ms"] == 5e3
    assert got["shape"] == want["shape"] == [4]
    assert {k for r in sink.records if r["type"] == "serving_summary"
            for k in r} == {k for r in jsink.records
                            if r["type"] == "serving_summary" for k in r}


def test_queue_timeout_emits_timeout_trace():
    sink = InMemorySink()
    eng = InferenceEngine(_model(), max_batch_size=4, max_wait_ms=0.0,
                          telemetry=_telemetry(sink), device="cpu",
                          start=False)
    try:
        fut = eng.submit(np.ones(4, np.float32), deadline_ms=0.001)
        time.sleep(0.01)
        eng.start()
        with pytest.raises(Exception):
            fut.result(timeout=5)
    finally:
        eng.close()
    (rec,) = [r for r in _traces(sink) if r["status"] == "timeout"]
    validate_record(rec)
    assert rec["queue_wait_ms"] >= 0
    assert [p["name"] for p in rec["critical_path"]] == ["queue"]


def test_a_failed_batch_traces_its_error():
    sink = InMemorySink()
    eng = InferenceEngine(_model(), max_batch_size=4, max_wait_ms=0.0,
                          telemetry=_telemetry(sink), device="cpu")
    try:
        with pytest.raises(Exception):
            eng.predict(np.ones(5, np.float32), timeout=5)
    finally:
        eng.close()
    (rec,) = _traces(sink)
    validate_record(rec)
    assert rec["status"] == "error" and "error" in rec


def test_trace_sample_sheds_records_and_spans():
    sink = InMemorySink()
    tr = SpanTracer(process_name="serve-sampled", annotate=False)
    eng = InferenceEngine(_model(), max_batch_size=2, max_wait_ms=0.0,
                          telemetry=_telemetry(sink), tracer=tr,
                          trace_sample=4, device="cpu")
    try:
        eng.warmup(np.ones(4, np.float32))
        for _ in range(8):
            eng.predict(np.ones(4, np.float32))
    finally:
        eng.close()
    traces = _traces(sink)
    assert len(traces) == 2  # requests 0 and 4 of 0..7
    assert len(_spans(tr, "request")) == len(traces)
    assert all(r["sample_weight"] == 4 for r in traces)
    for r in traces:
        validate_record(r)
    with pytest.raises(ValueError):
        InferenceEngine(_model(), trace_sample=0, device="cpu", start=False)


def test_drainless_close_traces_cancelled_requests():
    sink = InMemorySink()
    eng = InferenceEngine(_model(), max_batch_size=4, max_wait_ms=0.0,
                          telemetry=_telemetry(sink), device="cpu",
                          start=False)
    futs = [eng.submit(np.ones(4, np.float32)) for _ in range(3)]
    eng.close(drain=False)
    for f in futs:
        with pytest.raises(Exception):
            f.result(timeout=1)
    traces = _traces(sink)
    assert len(traces) == 3 and all(r["status"] == "cancelled"
                                    for r in traces)
    for r in traces:
        validate_record(r)
    summary = sink.records[-1]
    assert summary["type"] == "serving_summary"
    assert summary["cancelled"] == 3 and summary["shed"] == 0


def test_untelemetered_engine_pays_nothing():
    eng = InferenceEngine(_model(), max_batch_size=4, max_wait_ms=0.0,
                          device="cpu")
    try:
        fut = eng.submit(np.ones(4, np.float32))
        assert fut.result(timeout=5).shape == (2,)
        assert eng._new_context() is None
    finally:
        eng.close()


def test_stats_and_the_serving_stream_validate():
    sink = InMemorySink()
    eng = InferenceEngine(_model(), max_batch_size=4, max_wait_ms=0.0,
                          telemetry=_telemetry(sink), emit_every=2,
                          device="cpu")
    try:
        for _ in range(4):
            eng.predict(np.ones(4, np.float32))
        validate_record({"type": "serving_stats", "time": 0.0,
                         **eng.stats()})
    finally:
        eng.close()
    kinds = [r["type"] for r in sink.records]
    assert kinds.count("serving_stats") == 2
    assert kinds.count("trace") == 4 and kinds[-1] == "serving_summary"
    for r in sink.records:
        validate_record(r)


def test_a_failing_sink_never_stops_serving():
    class Broken(InMemorySink):
        def emit(self, record):
            raise OSError("disk full")

    eng = InferenceEngine(_model(), max_batch_size=4, max_wait_ms=0.0,
                          telemetry=_telemetry(Broken()), emit_every=1,
                          device="cpu")
    try:
        for _ in range(3):
            assert eng.predict(np.ones(4, np.float32),
                               timeout=5).shape == (2,)
    finally:
        eng.close()
    # a telemetry.sink fault: the same
    sink = InMemorySink()
    eng = InferenceEngine(_model(), max_batch_size=4, max_wait_ms=0.0,
                          telemetry=_telemetry(sink), device="cpu")
    plan = FaultInjector(FaultSpec("telemetry.sink", times=None))
    try:
        with plan:
            for _ in range(3):
                assert eng.predict(np.ones(4, np.float32),
                                   timeout=5).shape == (2,)
    finally:
        eng.close()
    assert plan.hits("telemetry.sink") >= 3 and not _traces(sink)


def test_breaker_and_replica_id_reach_the_engine():
    sink = InMemorySink()
    with InferenceEngine(_model(), max_batch_size=4, max_wait_ms=0.0,
                         breaker={"failure_threshold": 2},
                         replica_id="r0", telemetry=_telemetry(sink),
                         device="cpu") as eng:
        eng.submit(np.ones(4, np.float32), session="user-7").result(5)
        health = eng.health()
    assert eng.replica_id == "r0"
    assert health["status"] == "ok" and list(health["breakers"]) == \
        ["b2[4:float32]"]
    assert health["breakers"]["b2[4:float32]"]["state"] == "closed"
    (rec,) = _traces(sink)
    assert rec["replica_id"] == "r0" and rec["session_id"] == "user-7"


# ------------------------------------------------------------------ #
# GenerationEngine
# ------------------------------------------------------------------ #
def _lm():
    return TransformerLM(32, embed_dim=16, n_layer=1, n_head=2, device="cpu",
                         generator=torch.Generator().manual_seed(0))


def test_generation_traces_each_request_and_keeps_its_tokens():
    model = _lm()
    prompts = [np.array([1, 2, 3]), np.array([4, 5, 6, 7, 8, 9]),
               np.array([10, 11])]
    with GenerationEngine(model, slots=2, max_len=16, max_new_tokens=4,
                          device="cpu") as eng:
        plain = [eng.generate(p).result(timeout=30) for p in prompts]
    sink = InMemorySink()
    tr = SpanTracer(process_name="gen", annotate=False)
    with GenerationEngine(model, slots=2, max_len=16, max_new_tokens=4,
                          telemetry=_telemetry(sink), tracer=tr,
                          emit_every=2, device="cpu") as eng:
        streams = [eng.generate(p) for p in prompts]
        got = [s.result(timeout=30) for s in streams]
    assert got == plain
    traces = _traces(sink)
    assert len(traces) == 3
    for r in sink.records:
        validate_record(r)
    for r in traces:
        assert r["kind"] == "generate" and r["status"] == "ok"
        assert r["tokens"] == 4 and r["prefill_ms"] >= 0
        assert [p["name"] for p in r["critical_path"]] == \
            ["queue", "prefill", "decode"]
        assert sum(p["ms"] for p in r["critical_path"]) == \
            pytest.approx(r["latency_ms"], abs=0.01)
    assert sorted(r["prompt_tokens"] for r in traces) == [2, 3, 6]
    kinds = [r["type"] for r in sink.records]
    assert "generation" in kinds and kinds[-1] == "serving_summary"
    assert kinds[-2] == "generation"  # the last, as the dispatcher stops
    assert {"generate prefill", "generate decode", "generate", "prefill",
            "decode"} <= {e["name"] for e in _spans(tr)}


def test_generation_sampling_and_cancellation_trace():
    sink = InMemorySink()
    eng = GenerationEngine(_lm(), slots=2, max_len=16, max_new_tokens=2,
                           telemetry=_telemetry(sink), trace_sample=2,
                           device="cpu")
    try:
        for p in ([1, 2], [3, 4], [5, 6], [7, 8]):
            eng.generate(np.array(p)).result(timeout=30)
    finally:
        eng.close()
    assert [r["sample_weight"] for r in _traces(sink)] == [2, 2]
    sink = InMemorySink()
    eng = GenerationEngine(_lm(), slots=2, max_len=16, max_new_tokens=2,
                           telemetry=_telemetry(sink), device="cpu",
                           start=False)
    eng.generate(np.array([1, 2]))
    eng.close(drain=False)
    (rec,) = _traces(sink)
    validate_record(rec)
    assert rec["status"] == "cancelled" and rec["tokens"] == 0
