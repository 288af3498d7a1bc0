"""Port parity: the observability core (`bigdl_tpu_torch.observability`:
spans, telemetry and its sinks, the health monitors, the flight recorder)
and its wiring into both training loops, against `bigdl_tpu`.

- The units follow `tests/test_observability.py`'s; the port's
  `RECORD_SCHEMAS` is held equal to the reference's (the same record
  types and fields, types compared by name).
- The same toy model (Linear(6, 8) -> ReLU -> Linear(8, 2) ->
  LogSoftMax, or with a BatchNormalization after a bias-free first
  Linear, the JAX model's weights carried in) and the same seeded batches, fed in order, through the JAX
  `LocalOptimizer` / `DistriOptimizer` and the port's: the same record
  types in the same order (the JAX stream's `compile` records set aside:
  the port compiles nothing), the same step numbers, and loss,
  `grad_norm` and `param_norm` within a relative 1e-5 (f32, the same
  math summed in other orders). Every record the port emits passes
  `validate_record`.
- `NanGuard("skip")`: a NaN batch at step 3; the port's poisoned run
  matches the JAX poisoned run within the same tolerance, and its
  parameters and optimizer slots after [clean, clean, poisoned] equal,
  bit for bit, the port's own after [clean, clean] (SGD with momentum,
  Adam with its step count, a BN model with its running statistics).
- `raise` ends the stream with `run_abort` and a flight dump; with a
  checkpoint, `DistriOptimizer`'s retry reloads it and finishes the run.
"""

import doctest
import importlib
import json
import math
import os

import numpy as np
import pytest
import torch

import jax

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.dataset import LocalDataSet as JLocalDataSet
from bigdl_tpu.dataset.sample import MiniBatch as JMiniBatch
from bigdl_tpu.observability import InMemorySink as JInMemorySink
from bigdl_tpu.observability import NanGuard as JNanGuard
from bigdl_tpu.observability import Telemetry as JTelemetry
from bigdl_tpu.observability.telemetry import \
    RECORD_SCHEMAS as JRECORD_SCHEMAS
from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri
from bigdl_tpu.optim.local_optimizer import LocalOptimizer as JLocal
from bigdl_tpu.parallel.mesh import build_mesh as jbuild_mesh
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import MiniBatch
from bigdl_tpu_torch.interop import load_module_params, module_params_tree
from bigdl_tpu_torch.observability import (FlightRecorder, InMemorySink,
                                           JsonlSink, NanGuard,
                                           RECORD_SCHEMAS, SpanTracer,
                                           StragglerDetector, SummarySink,
                                           Telemetry, ThroughputMonitor,
                                           TrainingHealthError,
                                           device_memory_stats,
                                           sanitize_nonfinite,
                                           validate_record)
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.resilience import (FaultInjector, FaultSpec,
                                        known_sites)

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _flight_dir(tmp_path, monkeypatch):
    """Flight dumps of this file's runs land in its temporary folder."""
    monkeypatch.setenv("BIGDL_TPU_FLIGHT_DIR", str(tmp_path / "flight"))


# ------------------------------------------------------------------ #
# spans
# ------------------------------------------------------------------ #
def test_span_nesting_and_export(tmp_path):
    tr = SpanTracer(process_name="test-proc")
    with tr.span("outer", kind="phase"):
        with tr.span("inner"):
            pass
        with tr.span("inner2"):
            pass
    events = tr.events
    assert [e["name"] for e in events] == ["inner", "inner2", "outer"]
    outer = events[-1]
    for inner in events[:2]:
        assert inner["ts"] >= outer["ts"] - 1
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1
    assert outer["args"] == {"kind": "phase"}
    path = str(tmp_path / "trace.json")
    tr.export(path)
    with open(path) as f:
        doc = json.load(f)
    assert doc["displayTimeUnit"] == "ms"
    metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert any(m["name"] == "process_name"
               and m["args"]["name"] == "test-proc" for m in metas)
    assert len(spans) == 3
    for e in spans:
        assert set(e) >= {"name", "cat", "ph", "ts", "dur", "pid", "tid"}
        assert e["dur"] >= 0


def test_span_reset_and_max_events():
    tr = SpanTracer(max_events=2)
    for name in ("a", "b", "c"):
        with tr.span(name):
            pass
    assert [e["name"] for e in tr.events] == ["b", "c"]
    assert tr.dropped_events == 1
    meta = [e for e in tr.to_chrome_trace()["traceEvents"]
            if e["ph"] == "M" and e["name"] == "process_name"][0]
    assert meta["args"]["dropped_events"] == 1
    tr.reset()
    assert tr.events == [] and tr.dropped_events == 0


def test_annotated_spans_reach_the_torch_profiler():
    """`annotate=True`: each span is a `record_function` of its name, so
    the torch profiler's trace has it too."""
    tr = SpanTracer(process_name="annotated")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("step dispatch"):
            torch.ones(4).sum()
    assert "step dispatch" in {e.key for e in prof.key_averages()}


# ------------------------------------------------------------------ #
# telemetry and its sinks
# ------------------------------------------------------------------ #
def test_jsonl_round_trip_and_strict_json(tmp_path):
    path = str(tmp_path / "run.jsonl")
    tel = Telemetry(JsonlSink(path), resources=False, flight=False)
    tel.run_start(model="M")
    tel.step(step=1, loss=0.5, lr=0.1, throughput=100.0, step_time_s=0.01,
             records=32)
    tel.step(step=2, loss=float("nan"))
    tel.event("nan_guard", step=2, action="warn")
    tel.run_end(step=2, metrics={})
    tel.close()
    with open(path) as f:
        lines = f.read().splitlines()
    assert all("NaN" not in line for line in lines)
    recs = [json.loads(line) for line in lines]
    assert [r["type"] for r in recs] == ["run_start", "step", "step",
                                         "event", "run_end"]
    assert all("time" in r for r in recs)
    assert recs[1]["loss"] == 0.5 and recs[1]["throughput"] == 100.0
    assert recs[2]["loss"] is None and recs[2]["loss_nonfinite"] is True
    for r in recs:
        validate_record(r)


def test_jsonl_append_vs_truncate(tmp_path):
    path = str(tmp_path / "s.jsonl")
    for _ in range(2):
        s = JsonlSink(path, append=True)
        s.emit({"a": 1})
        s.close()
    with open(path) as f:
        assert len(f.readlines()) == 2
    s = JsonlSink(path, append=False)
    s.emit({"a": 2})
    s.close()
    with open(path) as f:
        assert len(f.readlines()) == 1


def test_resource_sampling_and_device_memory():
    tel = Telemetry(sink := InMemorySink(), resources=True, flight=False)
    tel.step(step=1, loss=0.0)
    rec = sink.steps()[0]
    assert rec["host_rss_mb"] > 0
    validate_record(rec)
    if not torch.cuda.is_available():
        assert device_memory_stats() == [] and "device_mem" not in rec


def test_summary_sink_bridges_scalars():
    class Writer:
        def __init__(self):
            self.scalars, self.closed = [], False

        def add_scalar(self, tag, value, step):
            self.scalars.append((tag, value, step))

        def close(self):
            self.closed = True

    w = Writer()
    tel = Telemetry(SummarySink(w), resources=False, flight=False)
    tel.step(step=1, loss=0.25, throughput=10.0)
    tel.step(step=2, loss=0.125, throughput=20.0)
    tel.event("straggler", step=2)
    tel.close()
    assert [(s, v) for t, v, s in w.scalars if t == "telemetry/loss"] == \
        [(1, 0.25), (2, 0.125)]
    assert w.closed


def test_strict_telemetry_refuses_an_undeclared_type(monkeypatch):
    tel = Telemetry(InMemorySink(), resources=False, flight=False)
    monkeypatch.delenv("BIGDL_TPU_STRICT_TELEMETRY", raising=False)
    tel.emit({"type": "made_up"})
    monkeypatch.setenv("BIGDL_TPU_STRICT_TELEMETRY", "1")
    with pytest.raises(ValueError, match="made_up"):
        tel.emit({"type": "made_up"})


def test_validate_record_violations():
    validate_record({"type": "step", "step": 1, "time": 0.0})
    for bad in ({"type": "nope", "time": 0.0},
                {"type": "step", "time": 0.0},
                {"type": "step", "step": True, "time": 0.0},
                {"type": "step", "step": 1, "time": 0.0, "rank": 0},
                {"type": "step", "step": 1}):
        with pytest.raises(ValueError):
            validate_record(bad)
    validate_record({"type": "event", "event": "x", "anything": 1,
                     "time": 0.0})


def test_sanitize_nonfinite_nests():
    got = sanitize_nonfinite({"a": float("inf"), "b": [1.0, float("nan")],
                              "c": {"d": float("-inf")}})
    assert got == {"a": None, "a_nonfinite": True, "b": [1.0, None],
                   "c": {"d": None, "d_nonfinite": True}}


def _type_names(spec):
    types = spec if isinstance(spec, tuple) else (spec,)
    return sorted(t.__name__ for t in types)


def test_record_schemas_equal_the_reference():
    assert sorted(RECORD_SCHEMAS) == sorted(JRECORD_SCHEMAS)
    for rtype, want in JRECORD_SCHEMAS.items():
        got = RECORD_SCHEMAS[rtype]
        assert got.get("open", False) == want.get("open", False), rtype
        for part in ("required", "optional"):
            assert sorted(got[part]) == sorted(want[part]), (rtype, part)
            for name, spec in want[part].items():
                assert _type_names(got[part][name]) == _type_names(spec), \
                    (rtype, part, name)


def test_metrics_table():
    m = Metrics()
    m.add("phase a", 2e9)
    m.add("phase a", 4e9)
    m.set("phase b", 1e9)
    d = m.as_dict()
    assert d["phase a"] == {"mean": pytest.approx(3.0), "count": 2,
                            "total": pytest.approx(6.0)}
    assert d["phase b"]["count"] == 1
    assert "phase a : 3.0 s" in m.summary()


@pytest.mark.parametrize("name", ["telemetry", "spans", "health", "flight"])
def test_module_doctests(name):
    mod = importlib.import_module(f"bigdl_tpu_torch.observability.{name}")
    res = doctest.testmod(mod, optionflags=doctest.NORMALIZE_WHITESPACE)
    assert res.attempted > 0 and res.failed == 0


# ------------------------------------------------------------------ #
# health monitors
# ------------------------------------------------------------------ #
def test_nan_guard_actions():
    with pytest.raises(ValueError):
        NanGuard(action="explode")
    g = NanGuard(action="warn")
    sink = InMemorySink()
    tel = Telemetry(sink, resources=False, flight=False)
    g.observe({"step": 1, "loss": 1.0}, tel)
    g.observe({"step": 2, "loss": float("nan")}, tel)
    g.observe({"step": 3, "loss": 1.0, "nonfinite_steps": 2}, tel)
    assert g.nonfinite_steps == 3
    assert [r["event"] for r in sink.records] == ["nan_guard", "nan_guard"]
    with pytest.raises(TrainingHealthError):
        NanGuard(action="raise").observe({"step": 5, "loss": float("inf")})


def test_straggler_detector_skips_its_warmup():
    d = StragglerDetector(factor=3.0, window=16, min_history=4)
    sink = InMemorySink()
    tel = Telemetry(sink, resources=False, flight=False)
    d.observe({"step": 0, "step_time_s": 5.0}, tel)  # the warm-up window
    for i in range(1, 9):
        d.observe({"step": i, "step_time_s": 0.01}, tel)
    assert d.stragglers == 0
    d.observe({"step": 9, "step_time_s": 0.2}, tel)
    assert d.stragglers == 1
    ev = sink.records[0]
    assert ev["event"] == "straggler"
    assert ev["p50_step_time_s"] == pytest.approx(0.01)


def test_throughput_monitor():
    m = ThroughputMonitor(tolerance=0.3, window=10, min_history=3)
    sink = InMemorySink()
    tel = Telemetry(sink, resources=False, flight=False)
    for i in range(6):
        m.observe({"step": i, "throughput": 100.0}, tel)
    assert m.regressions == 0
    m.observe({"step": 6, "throughput": 60.0}, tel)
    assert m.regressions == 1
    assert sink.records[0]["event"] == "throughput_regression"


# ------------------------------------------------------------------ #
# the flight recorder
# ------------------------------------------------------------------ #
def test_flight_recorder_dumps_on_its_triggers(tmp_path):
    tr = SpanTracer(process_name="flight", annotate=False)
    with tr.span("before"):
        pass
    fr = FlightRecorder(capacity=3, dump_dir=str(tmp_path / "d"))
    fr.attach_tracer(tr)
    tel = Telemetry(InMemorySink(), resources=False, flight=fr)
    for i in range(4):
        tel.step(step=i, loss=float("nan") if i == 3 else 1.0)
    assert fr.dumps == 0
    tel.event("nan_guard", step=3, action="warn")  # not a trigger
    assert fr.dumps == 0
    tel.event("nan_guard", step=3, action="raise")
    assert fr.dumps == 1
    with open(fr.last_dump_path) as f:
        doc = json.load(f)
    assert doc["trigger"] == "nan_guard_raise"
    assert [r["type"] for r in doc["records"]] == ["step", "event", "event"]
    assert [r.get("step") for r in doc["records"]] == [3, 3, 3]
    assert doc["records"][0]["loss_nonfinite"] is True
    assert [s["name"] for s in doc["spans"]] == ["before"]
    tel.event("run_abort", error="x")
    assert os.path.basename(fr.last_dump_path).endswith("_run_abort.json")


def test_flight_recorder_default_dir_and_manual_dump(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_FLIGHT_DIR", str(tmp_path / "env"))
    fr = FlightRecorder(triggers=())
    fr.emit({"type": "event", "event": "run_abort"})
    assert fr.dumps == 0
    path = fr.dump()
    assert os.path.dirname(path) == str(tmp_path / "env")
    with pytest.raises(ValueError):
        FlightRecorder(capacity=0)


def test_a_failing_sink_does_not_starve_the_flight_ring():
    class Broken(InMemorySink):
        def emit(self, record):
            raise OSError("disk full")

    fr = FlightRecorder(triggers=())
    tel = Telemetry(Broken(), resources=False, flight=fr)
    with pytest.raises(OSError):
        tel.step(step=1)
    assert fr.records()[0]["step"] == 1


def test_telemetry_sink_fault_site():
    """`telemetry.sink` is a known site; a plan on it raises from `emit`,
    and the injector's own `fault_injected` emission does not fire it
    again."""
    assert "telemetry.sink" in known_sites()
    sink = InMemorySink()
    tel = Telemetry(sink, resources=False, flight=False)
    plan = FaultInjector(FaultSpec("telemetry.sink", times=None),
                         telemetry=tel)
    with plan:
        with pytest.raises(Exception, match="telemetry.sink"):
            tel.step(step=1)
    assert plan.fired == [("telemetry.sink", 1)]
    assert [r["event"] for r in sink.records] == ["fault_injected"]


# ------------------------------------------------------------------ #
# the loops, against the reference
# ------------------------------------------------------------------ #
def _toy_batches(n=8, batch=32, poison=None):
    """Seeded classification batches; batch `poison` (0-based) is NaN."""
    rs = np.random.RandomState(0)
    out = []
    for i in range(n):
        x = rs.randn(batch, 6).astype(np.float32)
        if i == poison:
            x[:] = np.nan
        y = (rs.randint(0, 2, size=batch) + 1).astype(np.int32)
        out.append((x, y))
    return out


class _Ordered:
    """The port's batches in order, looping, each pull a fresh copy (what
    the loop places never aliases the arrays)."""

    def __init__(self, batches):
        self.batches = batches

    def data(self, train):
        def looped():
            while True:
                for x, y in self.batches:
                    yield MiniBatch(x.copy(), y.copy())
        return looped() if train else iter(
            [MiniBatch(x, y) for x, y in self.batches])

    def size(self):
        return sum(len(x) for x, _ in self.batches)

    def shuffle(self):
        pass


class _JOrdered(JLocalDataSet):
    """The reference's batches in order, looping, no shuffles."""

    def data(self, train):
        if not train:
            return iter(self.items)

        def looped():
            while True:
                yield from self.items
        return looped()

    def shuffle(self):
        pass


def _jmodel(bn=False):
    # before a BN the bias's gradient is noise (BN takes it out), and
    # Adam would amplify it: no bias there
    m = jnn.Sequential().add(jnn.Linear(6, 8, not bn))
    if bn:
        m.add(jnn.BatchNormalization(8))
    return m.add(jnn.ReLU()).add(jnn.Linear(8, 2)).add(jnn.LogSoftMax())


def _tmodel(bn=False):
    m = tnn.Sequential().add(tnn.Linear(6, 8, not bn, device="cpu"))
    if bn:
        m.add(tnn.BatchNormalization(8, device="cpu"))
    return m.add(tnn.ReLU()).add(tnn.Linear(8, 2, device="cpu")) \
        .add(tnn.LogSoftMax())


@pytest.fixture(scope="module")
def carried():
    """Each toy model's JAX weights (and BN state), as numpy."""
    out = {}
    for bn in (False, True):
        jm = _jmodel(bn)
        params = jm.ensure_params()
        out[bn] = (jax.tree_util.tree_map(np.asarray, params),
                   jax.tree_util.tree_map(np.asarray, jm._state))
    return out


def _method(pkg, name):
    if name == "adam":
        return pkg.Adam(learning_rate=0.02)
    return pkg.SGD(learning_rate=0.05, momentum=0.9)


def _jax_run(carried, loop, batches, iters, monitors=(), sync=1, bn=False,
             method="sgd", grad_norms=True):
    jm = _jmodel(bn)
    params, state = carried[bn]
    jm.set_params(jax.tree_util.tree_map(np.array, params))
    jm._state = jax.tree_util.tree_map(np.array, state)
    ds = _JOrdered([JMiniBatch(x, y) for x, y in batches])
    if loop == "local":
        opt = JLocal(jm, ds, jnn.ClassNLLCriterion())
    else:
        opt = JDistri(jm, ds, jnn.ClassNLLCriterion(),
                      mesh=jbuild_mesh(devices=jax.devices()[:1]))
    opt.set_optim_method(_method(joptim, method))
    opt.set_end_when(joptim.max_iteration(iters))
    opt.set_sync_interval(sync)
    sink = JInMemorySink()
    opt.set_telemetry(JTelemetry(sink, grad_norms=grad_norms,
                                 resources=False))
    opt.set_health_monitors(*monitors)
    opt.optimize()
    return sink.records, jm


def _port_opt(carried, loop, batches, iters, bn=False, method="sgd"):
    tm = _tmodel(bn)
    load_module_params(tm, *carried[bn])
    ds = _Ordered(batches)
    if loop == "local":
        opt = toptim.LocalOptimizer(tm, ds, tnn.ClassNLLCriterion(),
                                    device="cpu")
    else:
        opt = toptim.DistriOptimizer(tm, ds, tnn.ClassNLLCriterion(),
                                     devices=["cpu"],
                                     retry_interval_s=0.0)
    opt.set_optim_method(_method(toptim, method))
    opt.set_end_when(toptim.max_iteration(iters))
    return opt


def _port_run(carried, loop, batches, iters, monitors=(), sync=1, bn=False,
              method="sgd", grad_norms=True, tracer=None):
    opt = _port_opt(carried, loop, batches, iters, bn, method)
    opt.set_sync_interval(sync)
    sink = InMemorySink()
    opt.set_telemetry(Telemetry(sink, grad_norms=grad_norms,
                                resources=False))
    if tracer is not None:
        opt.set_tracer(tracer)
    opt.set_health_monitors(*monitors)
    opt.optimize()
    return sink.records, opt


def _compare_streams(got, want):
    """The same record types in order (compile records included: one a
    step signature in both), the same step numbers, and loss and norms
    within RTOL."""
    for r in got:
        validate_record(r)
    assert [r["type"] for r in got] == [r["type"] for r in want]
    assert [r.get("event") for r in got] == [r.get("event") for r in want]
    gs = [r for r in got if r["type"] == "step"]
    ws = [r for r in want if r["type"] == "step"]
    assert [r["step"] for r in gs] == [r["step"] for r in ws]
    for g, w in zip(gs, ws):
        assert g.get("nonfinite_steps") == w.get("nonfinite_steps")
        for key in ("loss", "grad_norm", "param_norm"):
            if key not in w:
                assert key not in g
            elif math.isfinite(w[key]):
                assert g[key] == pytest.approx(w[key], rel=RTOL), \
                    (g["step"], key)
            else:
                assert not math.isfinite(g[key]), (g["step"], key)


def _params_close(tm, jm):
    got = module_params_tree(tm)
    want = jax.tree_util.tree_map(np.asarray, jm.ensure_params())
    for k in want:
        for leaf in want[k]:
            a, b = np.asarray(got[k][leaf]), want[k][leaf]
            assert np.abs(a - b).max() <= RTOL * np.abs(b).max(), (k, leaf)


@pytest.mark.parametrize("loop", ["local", "distri"])
def test_stream_and_trace_match_the_reference(carried, loop, tmp_path):
    """A clean run of 5 steps: run_start, 5 step records, run_end, as the
    reference's; the loop's spans under one root trace."""
    want, _ = _jax_run(carried, loop, _toy_batches(), 5)
    tracer = SpanTracer(process_name=f"loop-{loop}")
    got, opt = _port_run(carried, loop, _toy_batches(), 5, tracer=tracer)
    _compare_streams(got, want)
    start, end = got[0], got[-1]
    assert start["loop"] == loop and start["backend"] == "cpu"
    assert start["n_devices"] == 1 and start["sync_interval"] == 1
    assert end["step"] == 5 and "computing time average" in end["metrics"]
    for r in got[2:-1]:
        assert r["lr"] == pytest.approx(0.05) and r["records"] == 32
        assert r["throughput"] > 0 and r["step_time_s"] > 0
        assert r["flops_per_step"] > 0 and r["bytes_accessed"] is None
        assert r["mfu"] is None  # no peak for the CPU
    path = opt.export_trace(str(tmp_path / "trace.json"))
    with open(path) as f:
        spans = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    names = {e["name"] for e in spans}
    assert {"data fetch", "step dispatch", "loss sync", "validation",
            f"optimize/{loop}"} <= names
    root = [e for e in spans if e["name"] == f"optimize/{loop}"][0]
    tid = root["args"]["trace_id"]
    assert all(e["args"]["trace_id"] == tid for e in spans
               if e["name"] == "step dispatch")


def test_step_flops_equal_the_counted_step(carried):
    """A step record's `flops_per_step` is `step_flops` of the batch."""
    from bigdl_tpu_torch.optim.local_optimizer import step_flops
    got, opt = _port_run(carried, "local", _toy_batches(), 2)
    steps = [r for r in got if r["type"] == "step"]
    (compile_,) = [r for r in got if r["type"] == "compile"]
    assert steps[0]["flops_per_step"] == step_flops(opt) > 0
    assert compile_["flops"] == steps[0]["flops_per_step"]


@pytest.mark.parametrize("loop,method,bn", [
    ("local", "sgd", False), ("distri", "sgd", False),
    ("local", "adam", False), ("distri", "adam", True)])
def test_skip_matches_the_reference_and_the_clean_run(carried, loop, method,
                                                      bn):
    """NaN inputs at step 3 of 6: one non-finite step, then finite
    losses; the stream and the final parameters as the reference's skip
    run; and the update a bitwise no-op: [clean, clean, poisoned] leaves
    the parameters, the slots (Adam's step count) and the BN statistics
    exactly as [clean, clean] does."""
    poisoned = _toy_batches(poison=2)
    want, jm = _jax_run(carried, loop, poisoned, 6, [JNanGuard("skip")],
                        bn=bn, method=method)
    got, opt = _port_run(carried, loop, poisoned, 6, [NanGuard("skip")],
                         bn=bn, method=method)
    _compare_streams(got, want)
    steps = [r for r in got if r["type"] == "step"]
    assert sum(r["nonfinite_steps"] for r in steps) == 1
    assert math.isnan(steps[2]["loss"]) and math.isfinite(steps[-1]["loss"])
    _params_close(opt.model, jm)

    def after(batches, iters):
        o = _port_opt(carried, loop, batches, iters, bn, method)
        o.set_health_monitors(NanGuard("skip"))
        held = {}

        def hook(s):
            if s["neval"] == iters:
                held["slots"] = o._slots_tree(o.opt_state)
        o.set_iteration_hook(hook)
        o.optimize()
        return o.model.state_dict(), held["slots"]

    skipped = after(_toy_batches(n=3, poison=2), 3)
    clean = after(_toy_batches(n=3), 2)
    for k, v in clean[0].items():
        assert torch.equal(skipped[0][k], v), k
    flat = jax.tree_util.tree_leaves
    assert all(np.array_equal(a, b)
               for a, b in zip(flat(skipped[1]), flat(clean[1])))
    if method == "adam":
        assert int(clean[1]["t"]) == int(skipped[1]["t"]) == 2


def test_skip_leaves_a_clean_run_bitwise_unchanged(carried):
    """With no non-finite step, a skipping guard changes nothing: the
    parameters equal, bit for bit, an unguarded run's."""
    plain = _port_opt(carried, "local", _toy_batches(n=3), 3)
    plain.optimize()
    guarded = _port_opt(carried, "local", _toy_batches(n=3), 3)
    guarded.set_health_monitors(NanGuard("skip"))
    guarded.optimize()
    for (k, a), b in zip(plain.model.state_dict().items(),
                         guarded.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_skip_with_loaded_bn_state(carried):
    """A BN model whose running statistics were loaded (the reference's
    partial-state case) reverts them without error."""
    opt = _port_opt(carried, "local", _toy_batches(poison=2), 6, bn=True)
    bn = opt.model.children_in_order()[1]
    with torch.no_grad():
        bn.mean.copy_(torch.linspace(-1, 1, 8))
        bn.var.copy_(torch.linspace(0.5, 2, 8))
    seen = {}
    opt.set_iteration_hook(lambda s: seen.setdefault(
        s["neval"], bn.mean.clone()))
    opt.set_health_monitors(NanGuard("skip"))
    opt.optimize()
    assert torch.equal(seen[2], seen[3])  # the poisoned step moved nothing
    for t in opt.model.state_dict().values():
        assert torch.isfinite(t).all()


@pytest.mark.parametrize("loop", ["local", "distri"])
def test_warn_continues_and_raise_aborts(carried, loop):
    got, opt = _port_run(carried, loop, _toy_batches(poison=2), 6,
                         [NanGuard("warn")])
    assert opt.health_monitors[0].nonfinite_steps >= 1
    assert opt.optim_method.state["neval"] == 6
    assert got[-1]["type"] == "run_end"
    with pytest.raises(TrainingHealthError):
        _port_run(carried, loop, _toy_batches(poison=2), 6,
                  [NanGuard("raise")])


def test_raise_stream_matches_the_reference(carried, tmp_path):
    """The aborted run's stream: run_start, 2 steps, the nan_guard event,
    run_abort, as the reference's; the flight recorder dumped on the
    raise and on the abort; the model put back as the run found it."""
    jm = _jmodel()
    jm.set_params(jax.tree_util.tree_map(np.array, carried[False][0]))
    jsink = JInMemorySink()
    jopt = JLocal(jm, _JOrdered([JMiniBatch(x, y) for x, y in
                                 _toy_batches(poison=2)]),
                  jnn.ClassNLLCriterion())
    jopt.set_optim_method(_method(joptim, "sgd"))
    jopt.set_end_when(joptim.max_iteration(6))
    jopt.set_telemetry(JTelemetry(jsink, grad_norms=True, resources=False))
    jopt.set_health_monitors(JNanGuard("raise"))
    with pytest.raises(Exception):
        jopt.optimize()

    opt = _port_opt(carried, "local", _toy_batches(poison=2), 6)
    sink = InMemorySink()
    fr = FlightRecorder(dump_dir=str(tmp_path / "dumps"))
    opt.set_telemetry(Telemetry(sink, grad_norms=True, resources=False,
                                flight=fr))
    opt.set_health_monitors(NanGuard("raise"))
    before = {k: v.clone() for k, v in opt.model.state_dict().items()}
    with pytest.raises(TrainingHealthError):
        opt.optimize()
    got = sink.records
    assert [r["type"] for r in got] == [r["type"] for r in jsink.records]
    assert got[-1]["event"] == "run_abort"
    assert "TrainingHealthError" in got[-1]["error"]
    assert sorted(p.rsplit("_", 1)[-1] for p in
                  os.listdir(tmp_path / "dumps")) == ["abort.json",
                                                      "raise.json"]
    # a failed run puts the model back as it found it
    for k, v in opt.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_raise_with_a_checkpoint_recovers_through_the_retry(carried,
                                                            tmp_path):
    """raise + checkpoint: the retry reloads iteration 4's checkpoint and
    finishes the run; the stream pairs the first run_start with
    run_retry and a retry event."""
    batches = _toy_batches(poison=4)
    opt = _port_opt(carried, "distri", batches, 8)
    opt.set_checkpoint(str(tmp_path / "ckpt"), toptim.several_iteration(2))
    sink = InMemorySink()
    opt.set_telemetry(Telemetry(sink, resources=False))
    opt.set_health_monitors(NanGuard("raise"))

    def unpoison(state):
        # the poisoned batch is already placed for step 5; its replay
        # after the reload is clean
        if state["neval"] >= 4:
            batches[4][0][:] = 0.0
    opt.set_iteration_hook(unpoison)
    opt.optimize()
    assert opt.optim_method.state["neval"] == 8
    kinds = [r.get("event", r["type"]) for r in sink.records]
    assert kinds.count("run_start") == 2
    i = kinds.index("run_retry")
    assert kinds[i - 1:i + 2] == ["nan_guard", "run_retry", "retry"]
    assert "checkpoint_verified" in kinds
    assert kinds[-1] == "run_end"
    for r in sink.records:
        validate_record(r)


def test_sync_interval_counts_the_windows_nonfinite_steps(carried):
    """sync_interval 3: the NaN at step 2 is counted in the first
    window's record, as the reference's."""
    want, _ = _jax_run(carried, "local", _toy_batches(poison=1), 6,
                       [JNanGuard("skip")], sync=3)
    got, _ = _port_run(carried, "local", _toy_batches(poison=1), 6,
                       [NanGuard("skip")], sync=3)
    _compare_streams(got, want)
    steps = [r for r in got if r["type"] == "step"]
    assert [r["step"] for r in steps] == [3, 6]
    assert [r["nonfinite_steps"] for r in steps] == [1, 0]


def test_a_tail_window_is_still_observed(carried):
    """An end trigger between sync points: the window's tail reaches the
    guard (a record with the steps' aux), as the reference's."""
    got, _ = _port_run(carried, "local", _toy_batches(poison=4), 5,
                       [NanGuard("skip")], sync=3)
    steps = [r for r in got if r["type"] == "step"]
    assert [r["step"] for r in steps] == [3, 5]
    assert steps[1]["nonfinite_steps"] == 1
    assert math.isnan(steps[1]["throughput"])


def test_bench_telemetry_writes_the_stream_and_the_trace(tmp_path,
                                                        monkeypatch):
    """`tools/bench.py --telemetry STEM` (the variable it sets): a
    training path writes STEM.jsonl (valid records, the grad norms) and
    STEM.trace.json (the loop's spans)."""
    from bigdl_tpu_torch.tools import bench
    stem = str(tmp_path / "lenet")
    monkeypatch.setenv(bench.TELEMETRY_ENV, stem)
    bench.bench_zoo("lenet", batch_size=4, warmup=2, iters=2, sync=2,
                    device="cpu")
    with open(stem + ".jsonl") as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        validate_record(r)
    assert [r["type"] for r in recs] == ["run_start", "compile", "step",
                                         "step", "run_end"]
    assert all(r["grad_norm"] > 0 for r in recs if r["type"] == "step")
    with open(stem + ".trace.json") as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"step dispatch", "loss sync", "optimize/distri"} <= names


def test_ab_observability_configurations(carried):
    """`tools/ab_observability.py`'s four configurations attach what they
    name."""
    from bigdl_tpu_torch.tools.ab_observability import CONFIGS, instrument
    for how in CONFIGS:
        opt = _port_opt(carried, "local", _toy_batches(), 2)
        instrument(opt, how)
        assert (opt.telemetry is not None) == (how in ("telemetry", "full"))
        assert (opt.tracer is not None) == (how in ("telemetry", "full"))
        assert opt._skips() == (how in ("skip", "full"))
        assert len(opt.health_monitors) == {"plain": 0, "telemetry": 0,
                                            "skip": 1, "full": 3}[how]


def test_flat_views_keep_each_tensors_layout():
    """The skip's buffers: a view a tensor, each of its shape and (dense)
    strides, in disjoint slices of the two rows."""
    from bigdl_tpu_torch.optim.local_optimizer import _flat_views
    ts = [torch.randn(2, 3, 4, 5).contiguous(
              memory_format=torch.channels_last),
          torch.randn(6, 4)[:, ::2], torch.tensor(3.0), torch.randn(7)]
    flat, kept, scratch = _flat_views(ts)
    assert flat.shape == (2, 120 + 12 + 1 + 7)
    assert kept[0].stride() == ts[0].stride()
    torch._foreach_copy_(kept, ts)
    torch._foreach_copy_(scratch, ts)
    assert all(torch.equal(a, b) for a, b in zip(kept, ts))
    assert torch.equal(flat[0], flat[1])
    assert sorted(flat[0].tolist()) == sorted(
        v for t in ts for v in t.reshape(-1).tolist())


def test_no_instrumentation_no_aux(carried):
    """Without telemetry and monitors the step computes nothing extra:
    no aux, no norms, the run as before."""
    opt = _port_opt(carried, "local", _toy_batches(), 3)
    step = opt._build_step()
    params = dict(opt.model.named_parameters())
    state = opt.optim_method.init_state_with_masters(params)
    x, y = _toy_batches(1)[0]
    _, aux = step(state, torch.from_numpy(x), torch.from_numpy(y), 0.05)
    assert aux is None and opt._aux_fields == []
    opt.optimize()
    assert opt.optim_method.state["neval"] == 3
    out = opt.model.eval()(torch.zeros(2, 6))
    assert torch.isfinite(out).all()
