"""Port parity: `bigdl_tpu_torch/observability/export.py`
(`PrometheusTextSink`, `MetricsServer`) against
`bigdl_tpu/observability/export.py`.

The same records go into both packages' sinks, each tracking an engine
stand-in with the same `health()`; `render()` must give the same text,
byte for byte (the `bigdl_tpu_` namespace, every family and help
string). A real port `InferenceEngine` with breakers, tracked under a
hostile name, renders text that reparses under the exposition grammar
(the reference's `TestPrometheusConformance`, ported). `MetricsServer`
on port 0 serves the render at `GET /metrics`, 404 elsewhere, and joins
its thread on close.
"""

import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from bigdl_tpu.observability.export import \
    PrometheusTextSink as JPrometheusTextSink
import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.observability import (InMemorySink, MetricsServer,
                                           PrometheusTextSink, SloEngine,
                                           Telemetry, default_slos)
from bigdl_tpu_torch.observability.export import _escape_label
from bigdl_tpu_torch.serving import InferenceEngine

NASTY = 'we"ird\\bucket\nname{x="1"}'


class _Health:
    """An engine stand-in: `health()` returns a fixed snapshot."""

    def __init__(self, snap):
        self.snap = snap

    def health(self):
        return self.snap


def _records():
    """One record of every kind the sink folds, some twice."""
    serving = {"type": "serving_stats", "queue_depth": 1, "submitted": 10,
               "completed": 9, "failed": 1, "timed_out": 0, "rejected": 0,
               "cancelled": 0, "shed": 0, "batches": 5, "bucket_hits": 4,
               "rows": 10, "padded_rows": 1, "bucket_hit_rate": 0.8,
               "pad_fraction": 0.1, "latency_ms_p50": 1.5,
               "latency_ms_p95": 2.5, "latency_ms_p99": 3.25,
               "queue_wait_ms_p50": 0.5, "batch_size_p50": 2.0,
               "latency_ms_count": 9, "queue_wait_ms_count": 9,
               "batch_size_count": 5, "flops_per_step": 1.5e9,
               "bytes_accessed": None, "mfu": 0.25, "time": 2.0}
    return [
        {"type": "run_start", "loop": "local", "time": 0.5},
        {"type": "step", "step": 3, "epoch": 1, "loss": 0.5, "lr": 0.01,
         "throughput": 1234.5, "step_time_s": 0.02, "flops_per_step": 7e9,
         "bytes_accessed": None, "mfu": float("nan"), "grad_norm": 1.25,
         "param_norm": 33.0, "host_rss_mb": 512.0,
         "prefetch_queue_depth": 3, "prefetch_fetch_wait_s": 0.125,
         "time": 1.0},
        serving,
        {**serving, "type": "serving_summary", "completed": 10,
         "time": 2.5},
        {"type": "generation", "slots": 8, "active_slots": 3,
         "tokens_total": 400, "decode_steps": 50, "prefill_requests": 12,
         "slot_joins": 12, "slot_leaves": 9, "tokens_per_sec": 123.5,
         "decode_occupancy": 0.375, "time": 3.0},
        {"type": "serving_fleet", "replicas_alive": 2, "replicas_total": 3,
         "replicas_draining": 1, "reroutes_total": 4, "routed_total": 100,
         "reroute_failed_total": 0, "drains_total": 1,
         "scale_ups_total": 0, "scale_downs_total": 1,
         "generations_total": 2, "stream_reroutes_total": 1,
         "replica_queue_depth": {"replica0": 2, "replica2": 0},
         "time": 3.5},
        {"type": "event", "event": "worker_lost", "worker": "w1",
         "devices": 1, "alive": 1, "total": 2, "degraded_capacity": 0.5,
         "time": 4.0},
        {"type": "event", "event": "elastic_shrink", "step": 7,
         "n_active_before": 2, "n_active": 1, "alive_workers": 1,
         "degraded_capacity": 0.5, "time": 4.5},
        {"type": "slo_status", "slo": "lat", "kind": "latency",
         "objective": 0.99, "alerting": True, "burn_rate": 2.5,
         "error_budget_remaining": -0.5, "compliance": 0.9, "good": 9,
         "bad": 1, "window_s": 60.0, "alerts_fired": 1, "time": 5.0},
        {"type": "slo_status", "slo": "err", "kind": "error_rate",
         "alerting": False, "burn_rate": None, "time": 5.0},
        {"type": "alert", "slo": "lat", "message": "m", "time": 5.5},
        {"type": "alert", "slo": "lat", "message": "m", "time": 5.6},
        {"type": "workload_replay", "workload": "steady", "entries_total": 47,
         "entries_done": 20, "chaos_fired": 0, "ok": 19, "errors": 1,
         "timeouts": 0, "shed": 0, "offset_ms": 812.5, "time": 6.0},
        {"type": "replay_summary", "workload": "steady", "entries_total": 47,
         "ok": 46, "errors": 1, "timeouts": 0, "shed": 0, "chaos_fired": 0,
         "seed": 3, "divergent": False, "time": 7.0},
    ]


_HEALTH = {"status": "degraded", "open_buckets": ["b4[4:float32]"],
           "breakers": {"b4[4:float32]": {"state": "open"},
                        "b2[4:float32]": {"state": "closed"},
                        "b1[4:float32]": {"state": "half_open"}},
           "queue_depth": 0, "queue_capacity": 8}


@pytest.mark.parametrize("upto", [0, 2, 6, len(_records())])
def test_render_equals_the_reference(upto):
    """The stream's first `upto` records into both sinks (plus two
    tracked engines, one named, one defaulted): the same text."""
    sinks = [PrometheusTextSink(), JPrometheusTextSink()]
    stand_ins = [_Health(_HEALTH), _Health({**_HEALTH, "status": "ok",
                                            "breakers": {}})]
    for s in sinks:
        for r in _records()[:upto]:
            s.emit(dict(r))
        s.track_engine(stand_ins[0], name=NASTY)
        s.track_engine(stand_ins[1])
    got, want = (s.render() for s in sinks)
    assert got == want
    assert got.endswith("\n")
    if upto == len(_records()):
        for family in ("bigdl_tpu_serving_fleet_replicas_alive 2",
                       "bigdl_tpu_degraded_capacity 0.5",
                       "bigdl_tpu_workers_alive 1",
                       "bigdl_tpu_workers_total 2",
                       'bigdl_tpu_slo_burn_rate{slo="lat"} 2.5',
                       'bigdl_tpu_slo_error_budget_remaining{slo="lat"}',
                       "bigdl_tpu_serving_breaker_state{bucket="):
            assert family in got, family


def test_an_slo_engine_feeds_both_sinks_alike():
    """The same SLO stream through each package's own engine and sink."""
    from bigdl_tpu.observability import SloEngine as JSloEngine
    from bigdl_tpu.observability import Telemetry as JTelemetry
    from bigdl_tpu.observability import default_slos as jdefault_slos
    texts = []
    for tel_cls, eng_cls, slos, prom in (
            (Telemetry, SloEngine, default_slos, PrometheusTextSink()),
            (JTelemetry, JSloEngine, jdefault_slos, JPrometheusTextSink())):
        tel = tel_cls(prom, resources=False, flight=False)
        eng_cls(slos(windows=((1.0, 5.0, 1.5),)),
                emit_every_s=0.5).attach(tel)
        for i in range(40):
            tel.emit({"type": "trace", "trace_id": f"t{i}",
                      "kind": "serving_request",
                      "status": "ok" if i % 7 else "error",
                      "latency_ms": 50.0 + 10 * (i % 13),
                      "time": 1000.0 + i * 0.1})
        texts.append("\n".join(line for line in prom.render().splitlines()
                               if "telemetry_records_total" not in line))
    assert texts[0] == texts[1]
    assert 'slo_burn_rate{slo="serving_errors"}' in texts[0]


# ------------------------------------------------------------ conformance
_LABEL_VALUE = r'"(?:\\[\\n"]|[^"\\\n])*"'
_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r"(?:\{[a-zA-Z_][a-zA-Z0-9_]*=" + _LABEL_VALUE +
    r"(?:,[a-zA-Z_][a-zA-Z0-9_]*=" + _LABEL_VALUE + r")*\})?"
    r" (?:[+-]?(?:\d+\.?\d*(?:[eE][+-]?\d+)?|Inf)|NaN)$")
_COMMENT_RE = re.compile(
    r"^# (?:HELP [a-zA-Z_:][a-zA-Z0-9_:]* .*"
    r"|TYPE [a-zA-Z_:][a-zA-Z0-9_:]* "
    r"(?:counter|gauge|histogram|summary|untyped))$")


def _unescape_label(s):
    out, i = [], 0
    while i < len(s):
        if s[i] == "\\" and i + 1 < len(s):
            out.append({"\\": "\\", "n": "\n", '"': '"'}
                       .get(s[i + 1], "\\" + s[i + 1]))
            i += 2
        else:
            out.append(s[i])
            i += 1
    return "".join(out)


def _mlp():
    return (nn.Sequential().add(nn.Linear(4, 2, device="cpu"))
            .add(nn.LogSoftMax()))


def test_escape_label_round_trips():
    for s in (NASTY, "\\", '"', "\n", "a\\nb", "plain", '\\"', "t\\"):
        assert _unescape_label(_escape_label(s)) == s


def test_a_tracked_port_engine_renders_parseable_text():
    sink = PrometheusTextSink()
    for r in _records():
        sink.emit(dict(r, slo=NASTY) if r["type"] in ("slo_status", "alert")
                  else dict(r))
    eng = InferenceEngine(_mlp(), max_batch_size=4, max_wait_ms=0.0,
                          breaker={"failure_threshold": 2}, device="cpu")
    try:
        eng.predict(Sample(np.ones(4, np.float32)))
        sink.track_engine(eng, name=NASTY)
        render = sink.render()
    finally:
        eng.close()
    for line in render.splitlines():
        assert _SAMPLE_RE.match(line) or _COMMENT_RE.match(line), line
    m = re.search(r'serving_engine_up\{engine=(' + _LABEL_VALUE + r'),',
                  render)
    assert m and _unescape_label(m.group(1)[1:-1]) == NASTY
    assert re.search(r'serving_breaker_state\{bucket="b\d+\[4:float32\]",'
                     r'engine=' + _LABEL_VALUE + r'\} 0', render)
    del eng  # weakly held: a dropped engine leaves the exposition
    import gc
    gc.collect()
    assert "serving_engine_up" not in sink.render()


def test_metrics_server_serves_the_render_and_joins():
    sink = PrometheusTextSink()
    tel = Telemetry(sink, InMemorySink(), resources=False, flight=False)
    tel.step(step=1, loss=0.25)
    before = threading.active_count()
    with MetricsServer(sink, port=0) as server:
        assert server.port > 0
        assert server.url.endswith(f":{server.port}/metrics")
        with urllib.request.urlopen(server.url, timeout=10) as resp:
            body = resp.read().decode()
            ctype = resp.headers["Content-Type"]
        assert body == sink.render() and "bigdl_tpu_step_loss 0.25" in body
        assert ctype.startswith("text/plain; version=0.0.4")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(server.url.replace("/metrics", "/x"),
                                   timeout=10)
        assert e.value.code == 404
    assert threading.active_count() <= before
    server.close()  # idempotent
