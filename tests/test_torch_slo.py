"""Port parity: `bigdl_tpu_torch/observability/slo.py` against
`bigdl_tpu/observability/slo.py`.

The same record streams go through both packages' `SloEngine`, each
attached to a `Telemetry` over an in-memory sink; the `slo_status` and
`alert` records each emits must be equal field by field (the wall-clock
`time` the telemetry stamps on them aside), burn rates to 1e-12 relative,
and so must `status()`, `violated()` and `finalize()`'s outcome. The
streams are the scenarios of `tests/test_tracing_slo.py` and
`tests/test_fleet.py` (burn-rate math, a short spike, MTTR recovered and
not, one bad sample, the lazy prune, the MFU floor, fleet-transient
records) and the three workloads of `tests/workloads/` replayed as
records: each entry a `trace` record at its arrival offset, with a seeded
latency and status, each chaos action a `worker_lost` / `worker_joined`
event of the serving role.
"""

import json
import os

import numpy as np
import pytest

from bigdl_tpu.observability import InMemorySink as JInMemorySink
from bigdl_tpu.observability import SLO as JSLO
from bigdl_tpu.observability import SloEngine as JSloEngine
from bigdl_tpu.observability import Telemetry as JTelemetry
from bigdl_tpu.observability import default_slos as jdefault_slos
from bigdl_tpu_torch.observability import (DEFAULT_WINDOWS, SLO,
                                           InMemorySink, SloEngine,
                                           Telemetry, default_slos,
                                           validate_record)

#: burn rates and compliances, port against the reference
RTOL = 1e-12
WORKLOADS = os.path.join(os.path.dirname(__file__), "workloads")


def _trace(i, t, ok=True, latency=5.0, **kw):
    return {"type": "trace", "trace_id": f"t{i:06d}",
            "kind": "serving_request", "status": "ok" if ok else "error",
            "latency_ms": latency, "time": t, **kw}


def _engines(spec, emit_every_s):
    """(port engine, port sink, reference engine, reference sink) for the
    same objectives: `spec` is a list of (name, kind, kwargs)."""
    out = []
    for slo_cls, eng_cls, tel_cls, sink_cls in (
            (SLO, SloEngine, Telemetry, InMemorySink),
            (JSLO, JSloEngine, JTelemetry, JInMemorySink)):
        sink = sink_cls()
        tel = tel_cls(sink, resources=False, flight=False)
        eng = eng_cls([slo_cls(n, k, **kw) for n, k, kw in spec],
                      emit_every_s=emit_every_s).attach(tel)
        out += [eng, sink]
    return out


def _own(records):
    return [{k: v for k, v in r.items() if k != "time"} for r in records
            if r["type"] in ("slo_status", "alert")]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w), (g, w)
        for k, v in w.items():
            if isinstance(v, float) and not isinstance(v, bool):
                assert g[k] == pytest.approx(v, rel=RTOL), (k, g, w)
            else:
                assert g[k] == v, (k, g, w)


def _drive(spec, records, emit_every_s=10.0, finalize=True):
    """Feed `records` to both engines; compare what they emitted, their
    status and violations. Returns the port engine and its sink."""
    eng, sink, jeng, jsink = _engines(spec, emit_every_s)
    for r in records:
        eng.emit(dict(r))
        jeng.emit(dict(r))
    if finalize:
        eng.finalize()
        jeng.finalize()
    for r in sink.records:
        validate_record(r)
    _assert_same(_own(sink.records), _own(jsink.records))
    _assert_same(eng.status(), jeng.status())
    assert eng.violated() == jeng.violated()
    return eng, sink


def test_defaults_are_the_reference():
    from bigdl_tpu.observability import DEFAULT_WINDOWS as JW
    assert DEFAULT_WINDOWS == JW
    for kw in ({}, {"mfu_floor": 0.3, "mttr_s": 5.0, "latency_p99_ms": 20.0},
               {"windows": ((1.0, 5.0, 2.0),)}):
        got = [(s.name, s.kind, s.objective, s.threshold_ms, s.floor,
                s.max_s, s.windows, s.min_samples, s.budget)
               for s in default_slos(**kw)]
        want = [(s.name, s.kind, s.objective, s.threshold_ms, s.floor,
                 s.max_s, s.windows, s.min_samples, s.budget)
                for s in jdefault_slos(**kw)]
        assert got == want


@pytest.mark.parametrize("args", [("x", "nope"), ("x", "latency"),
                                  ("x", "mfu"), ("x", "mttr")])
def test_declarations_refused_as_the_reference(args):
    with pytest.raises(ValueError):
        JSLO(*args)
    with pytest.raises(ValueError):
        SLO(*args)
    with pytest.raises(ValueError):
        SLO("x", "latency", objective=1.5, threshold_ms=1)
    with pytest.raises(ValueError):
        SloEngine([SLO("d", "error_rate"), SLO("d", "error_rate")])


def _burn_math():
    recs = [_trace(i, i * 0.1, latency=5.0) for i in range(50)]
    recs += [_trace(100 + i, 5 + i * 0.1, latency=500.0) for i in range(50)]
    return ([("lat", "latency", {"objective": 0.99, "threshold_ms": 50.0,
                                 "windows": ((10.0, 100.0, 14.4),)})], recs)


def _short_spike():
    recs = [_trace(i, i * 0.5, latency=1.0) for i in range(200)]
    recs += [_trace(500 + i, 99.5 + i * 0.1, latency=999.0)
             for i in range(3)]
    return ([("lat", "latency", {"objective": 0.9, "threshold_ms": 50.0,
                                 "windows": ((1.0, 100.0, 5.0),)})], recs)


def _mttr():
    ev = {"type": "event", "event": "worker_lost"}
    recs = [{**ev, "time": 100.0}, {"type": "step", "step": 1, "time": 103.0},
            {**ev, "time": 200.0}]
    return ([("mttr", "mttr", {"objective": 0.99, "max_s": 10.0,
                               "windows": ((60.0, 600.0, 2.0),)})], recs)


def _single_bad():
    recs = [_trace(0, 100.0), _trace(1, 100.1, ok=False)]
    recs += [_trace(i, 100.0 + i * 0.1, ok=False) for i in range(2, 22)]
    return ([("err", "error_rate", {"objective": 0.999,
                                    "windows": ((300.0, 3600.0, 14.4),)})],
            recs)


def _lazy_prune():
    recs = [_trace(i, i * 0.1, ok=(i % 2 == 0)) for i in range(3000)]
    return ([("err", "error_rate", {"objective": 0.9,
                                    "windows": ((5.0, 10.0, 100.0),)})],
            recs)


def _mfu():
    recs = [{"type": "step", "step": 1, "time": 1.0},
            {"type": "step", "step": 2, "mfu": 0.31, "time": 2.0},
            {"type": "step", "step": 3, "mfu": 0.10, "time": 3.0}]
    return ([("mfu", "mfu", {"objective": 0.9, "floor": 0.25,
                             "windows": ((60.0, 600.0, 2.0),)})], recs)


def _fleet_transients():
    recs = [_trace(1, 1.0)]
    recs += [{**_trace(2 + i, 2.0 + i), "status": s,
              "replica_id": "replica0"}
             for i, s in enumerate(("cancelled", "shed", "timeout"))]
    recs += [{**_trace(5, 5.0, ok=False), "replica_id": "replica0"},
             {**_trace(6, 6.0), "status": "timeout", "kind": "fleet_request",
              "replica_id": "replica0"},
             {**_trace(7, 7.0), "status": "cancelled"},
             {**_trace(8, 8.0), "sample_weight": 5}]
    spec = [(s.name, s.kind, {"objective": s.objective,
                              "threshold_ms": s.threshold_ms,
                              "max_s": s.max_s, "windows": s.windows})
            for s in default_slos()]
    return spec, recs


def _serving_mttr():
    t0 = 1000.0
    lost = {"type": "event", "event": "worker_lost", "worker": "replica1",
            "role": "serving", "time": t0}
    recs = [lost, {"type": "step", "step": 5, "time": t0 + 1.0},
            _trace(1, t0 + 3.0), {**lost, "time": t0 + 10.0,
                                  "role": None},
            _trace(2, t0 + 11.0)]
    spec = [(s.name, s.kind, {"objective": s.objective,
                              "threshold_ms": s.threshold_ms,
                              "max_s": s.max_s, "windows": s.windows})
            for s in default_slos(mttr_s=60.0)]
    return spec, recs


SCENARIOS = {"burn_rate_math": _burn_math, "short_spike": _short_spike,
             "mttr": _mttr, "single_bad_sample": _single_bad,
             "lazy_prune": _lazy_prune, "mfu_floor": _mfu,
             "fleet_transients": _fleet_transients,
             "serving_mttr_domains": _serving_mttr}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("emit_every_s", [0.0, 10.0])
def test_scenarios_match_the_reference(name, emit_every_s):
    spec, recs = SCENARIOS[name]()
    _drive(spec, recs, emit_every_s)


def test_scenarios_read_as_the_reference_tests_say():
    """Spot checks of the scenarios' own outcomes (the reference's
    assertions), on the port."""
    eng, _ = _drive(*_burn_math(), finalize=False)
    (s,) = eng.status()
    assert s["compliance"] == pytest.approx(0.5)
    assert s["burn_rate"] == pytest.approx(50.0, rel=0.15)
    eng, _ = _drive(*_short_spike(), finalize=False)
    assert not eng.status()[0]["alerting"]
    eng, _ = _drive(*_mttr())
    assert eng.status()[0]["bad"] == 1 and eng.violated() == ["mttr"]
    eng, _ = _drive(*_lazy_prune())
    assert sum(eng.status()[0][k] for k in ("good", "bad")) == 101
    eng, _ = _drive(*_fleet_transients())
    err = next(s for s in eng.status() if s["slo"] == "serving_errors")
    assert (err["good"], err["bad"]) == (6, 3)


def _workload_records(path, seed=0):
    """A workload file as the stream its replay would leave: a trace
    record per entry (time = 1000 s + its offset; latency log-normal
    around 20 ms, every 23rd an error), a serving `worker_lost` at each
    chaos kill and a `worker_joined` at each restore, in time order."""
    with open(path) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    head, entries = lines[0], lines[1:]
    rs = np.random.RandomState(seed)
    recs = []
    for i, e in enumerate(entries):
        t = 1000.0 + e["arrival_offset_ms"] / 1e3
        recs.append({"type": "trace", "trace_id": f"w{i:05d}",
                     "kind": e["kind"],
                     "status": "error" if i % 23 == 22 else "ok",
                     "latency_ms": float(np.exp(rs.normal(3.0, 0.8))),
                     "session_id": e.get("session_id"), "time": t})
    for action in head["chaos"]:
        k = min(action["after_entries"], len(recs) - 1)
        ev = "worker_lost" if action["action"] == "kill" else "worker_joined"
        recs.append({"type": "event", "event": ev, "worker": "replica1",
                     "role": "serving", "time": recs[k]["time"] + 1e-4})
    return sorted(recs, key=lambda r: r["time"])


@pytest.mark.parametrize("workload", ["steady", "double_rate",
                                      "kill_at_peak"])
def test_workloads_replayed_as_records_match_the_reference(workload):
    recs = _workload_records(os.path.join(WORKLOADS, f"{workload}.jsonl"))
    windows = ((0.5, 2.0, 2.0), (1.0, 5.0, 1.5))
    spec = [(s.name, s.kind, {"objective": s.objective,
                              "threshold_ms": s.threshold_ms,
                              "max_s": s.max_s, "floor": s.floor,
                              "windows": windows, "min_samples": 5})
            for s in default_slos(latency_p99_ms=40.0, mttr_s=0.05,
                                  mfu_floor=0.1)]
    eng, sink = _drive(spec, recs, emit_every_s=0.25)
    emitted = _own(sink.records)
    assert sum(r["type"] == "slo_status" for r in emitted) > 10
    if workload == "kill_at_peak":
        assert any(r["type"] == "alert" for r in emitted)


def test_attached_engine_ignores_its_own_records_and_validates():
    """The live wiring: an attached engine emits through the telemetry,
    ignores its own records fanned back, and every record validates (the
    reference's `test_slo_records_validate_against_schema`)."""
    sink = InMemorySink()
    tel = Telemetry(sink, resources=False, flight=False)
    eng = SloEngine(default_slos(windows=((1.0, 5.0, 1.5),)),
                    emit_every_s=0.5).attach(tel)
    for i in range(30):
        tel.emit(_trace(i, 1000.0 + i * 0.1, latency=500.0))
    types = {r["type"] for r in sink.records}
    assert {"slo_status", "alert"} <= types
    for r in sink.records:
        validate_record(r)
    assert eng.violated() == ["serving_latency_p99"]
    eng.close()
