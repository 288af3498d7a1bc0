"""Workload record/replay of the port (bigdl_tpu_torch/workload/) against
the reference's contracts and the reference itself.

Every case of `tests/test_workload.py` runs here on the port: the seeded
generators and `ChaosSchedule`; workload files and their malformed forms;
the recorder over a live fleet stream; the SLO-replay invariance contract
(same workload + same seed => a canonical stream `compare_streams` finds
identical; a perturbed seed or replica count diverges with a pointer);
time compression; `metrics_cli diff` and the Prometheus replay gauges; the
checked-in `tests/workloads/`. Replays run over the reference's no-thread
`SimEngine` double and, for the invariance cases, over the reference's
28x28 MLP (784-32-10) served by a port `ServingFleet` on the CPU.

Against the JAX package (the files are the reference's, byte for byte):
the synthesized workloads and the three arrival processes at the same
seeds, `ChaosSchedule.random`, the recorder fed the same trace records,
and the canonical stream of `kill_at_peak.jsonl` replayed at seed 4 over
each package's MLP fleet with the same weights.
"""

import json
import os
import threading
from collections import deque
from concurrent.futures import Future, InvalidStateError

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.dataset import Sample
from bigdl_tpu_torch.observability import InMemorySink, Telemetry
from bigdl_tpu_torch.observability.export import PrometheusTextSink
from bigdl_tpu_torch.observability.slo import SloEngine, default_slos
from bigdl_tpu_torch.observability.telemetry import validate_record
from bigdl_tpu_torch.serving import ServingFleet
from bigdl_tpu_torch.serving.engine import EngineClosedError
from bigdl_tpu_torch.tools.metrics_cli import diff as cli_diff
from bigdl_tpu_torch.workload import (ChaosAction, ChaosSchedule,
                                      VirtualClock, Workload, WorkloadEntry,
                                      WorkloadRecorder, WorkloadReplayer,
                                      bursty_arrivals, compare_streams,
                                      diurnal_arrivals, poisson_arrivals,
                                      synthesize)

WORKLOADS = os.path.join(os.path.dirname(__file__), "workloads")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # many small torch ops beside JAX in one process: one intra-op thread
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# SimEngine: the engine-protocol stand-in of the reference's test
# --------------------------------------------------------------------------
class SimEngine:
    """No-thread engine double: submits resolve immediately with
    `(replica_id, sample)`; the last deadline and session are kept."""

    def __init__(self, replica_id):
        self.replica_id = replica_id
        self.held = deque()
        self.closed = False
        self.warmups = 0
        self.submits = 0
        self.last_deadline_ms = None
        self.last_session = None
        self._lock = threading.Lock()

    def submit(self, sample, deadline_ms=None, session=None):
        with self._lock:
            if self.closed:
                raise EngineClosedError(f"{self.replica_id} closed")
            self.submits += 1
            self.last_deadline_ms = deadline_ms
            self.last_session = session
        fut = Future()
        try:
            fut.set_result((self.replica_id, sample))
        except InvalidStateError:
            pass
        return fut

    def warmup(self, sample):
        self.warmups += 1
        return 0

    def health(self):
        return {"status": "ok", "open_buckets": [], "breakers": {},
                "queue_depth": 0, "queue_capacity": 1024}

    def stats(self):
        return {"queue_depth": 0, "submitted": self.submits,
                "completed": self.submits, "shed": 0}

    def close(self, drain=True):
        with self._lock:
            self.closed = True


def sim_fleet(n=3, telemetry=None, **kw):
    """A fleet of SimEngines; returns (fleet, engines dict)."""
    engines = {}

    def factory(rid):
        eng = SimEngine(rid)
        engines[rid] = eng
        return eng

    kw.setdefault("warmup_sample", "w")
    kw.setdefault("drain_grace_s", 0.2)
    kw.setdefault("seed", 0)
    fleet = ServingFleet(engine_factory=factory, n_replicas=n,
                         telemetry=telemetry, **kw)
    return fleet, engines


def mlp(device="cpu"):
    """The reference drill's MLP, seed-0 weights (`tools/bench.py`)."""
    from bigdl_tpu_torch.tools.bench import _replay_mlp
    return _replay_mlp(torch.device(device))


_MLP = None


def mlp_fleet(n=3, telemetry=None):
    """The MLP served by `n` port `InferenceEngine`s on the CPU (the
    drill's engine settings)."""
    global _MLP
    if _MLP is None:
        _MLP = mlp()
    return ServingFleet(_MLP, n_replicas=n,
                        warmup_sample=Sample(np.zeros((28, 28), np.float32)),
                        telemetry=telemetry, drain_grace_s=0.2, seed=0,
                        engine_kwargs={"max_batch_size": 8,
                                       "max_wait_ms": 1.0,
                                       "queue_capacity": 256,
                                       "device": "cpu"})


TARGETS = ["sim", "mlp"]


def steady_workload(n=40, sessions=4, deadline_ms=60_000.0, seed=3,
                    chaos=None, name="steady", shape=(4,)):
    return synthesize(name, poisson_arrivals(20.0, n / 20.0, seed=seed),
                      seed=seed, shape=list(shape), deadline_ms=deadline_ms,
                      sessions=sessions, chaos=chaos)


def replay_once(workload, n_replicas=3, seed=1, chaos=None, slo=True,
                target="sim", **replayer_kw):
    """One replay against a fresh fleet; returns (records, summary)."""
    sink = InMemorySink()
    tel = Telemetry(sink, resources=False)
    if slo:
        SloEngine(default_slos(latency_p99_ms=60_000.0),
                  emit_every_s=0.25).attach(tel)
    fleet = sim_fleet(n=n_replicas)[0] if target == "sim" \
        else mlp_fleet(n=n_replicas)
    try:
        summary = WorkloadReplayer(
            fleet, workload,
            chaos=chaos if chaos is not None
            else (ChaosSchedule.from_dicts(workload.chaos, seed=seed)
                  if workload.chaos else None),
            seed=seed, clock=VirtualClock(), telemetry=tel,
            progress_every=10, **replayer_kw).run()
    finally:
        fleet.close()
        tel.close()
    return sink.records, summary


def _shape(target):
    return (28, 28) if target == "mlp" else (4,)


# --------------------------------------------------------------------------
# clocks and synthetic generators
# --------------------------------------------------------------------------
def test_virtual_clock_jumps_instead_of_waiting():
    clk = VirtualClock(start=5.0)
    assert clk.now() == 5.0
    clk.sleep(2.5)
    assert clk.now() == 7.5
    clk.sleep(-3.0)  # the replayer computes negative waits when behind
    assert clk.now() == 7.5


@pytest.mark.parametrize("gen,kw", [
    (poisson_arrivals, {"rate_per_s": 50.0, "duration_s": 1.0}),
    (bursty_arrivals, {"rate_per_s": 50.0, "duration_s": 1.0}),
    (diurnal_arrivals, {"rate_per_s": 50.0, "duration_s": 1.0}),
])
def test_generators_are_seeded_and_monotonic(gen, kw):
    a = gen(seed=11, **kw)
    b = gen(seed=11, **kw)
    c = gen(seed=12, **kw)
    assert a == b  # same seed => identical arrival list
    assert a != c
    assert a, "generator produced no arrivals"
    assert all(x <= y for x, y in zip(a, a[1:]))
    assert all(0 <= x <= kw["duration_s"] * 1e3 for x in a)


def test_synthesize_deals_sessions_and_sorts():
    wl = steady_workload(sessions=3)
    assert len(wl) > 0
    offs = [e.arrival_offset_ms for e in wl.entries]
    assert offs == sorted(offs)
    assert {e.session_id for e in wl.entries} == {"s0", "s1", "s2"}
    assert all(e.deadline_ms == 60_000.0 for e in wl.entries)


# --------------------------------------------------------------------------
# workload files
# --------------------------------------------------------------------------
def test_workload_save_load_roundtrip(tmp_path):
    chaos = [ChaosAction("kill", after_entries=5).to_dict(),
             ChaosAction("restore", after_entries=10).to_dict()]
    wl = steady_workload(chaos=chaos)
    path = str(tmp_path / "wl.jsonl")
    wl.save(path)
    back = Workload.load(path)
    assert back.name == wl.name
    assert back.seed == wl.seed
    assert back.chaos == chaos
    assert [e.to_dict() for e in back.entries] == \
        [e.to_dict() for e in wl.entries]
    assert back.sha256() == wl.sha256()


def test_workload_load_rejects_malformed(tmp_path):
    # missing header
    p = tmp_path / "headerless.jsonl"
    p.write_text(json.dumps({"type": "workload_entry",
                             "arrival_offset_ms": 0.0}) + "\n")
    with pytest.raises(ValueError, match=r"headerless\.jsonl:1"):
        Workload.load(str(p))
    # non-monotonic offsets (hand-built file; save() cannot produce one)
    p = tmp_path / "unsorted.jsonl"
    p.write_text("\n".join([
        json.dumps({"type": "workload", "version": 1, "name": "x",
                    "seed": 0}),
        json.dumps({"type": "workload_entry", "arrival_offset_ms": 10.0}),
        json.dumps({"type": "workload_entry", "arrival_offset_ms": 5.0}),
    ]) + "\n")
    with pytest.raises(ValueError, match=r"unsorted\.jsonl:3"):
        Workload.load(str(p))
    # non-strict JSON constants must not parse
    p = tmp_path / "nan.jsonl"
    p.write_text(json.dumps({"type": "workload", "version": 1,
                             "name": "x", "seed": 0})
                 + '\n{"type": "workload_entry", '
                 '"arrival_offset_ms": NaN}\n')
    with pytest.raises(ValueError, match=r"nan\.jsonl:2"):
        Workload.load(str(p))
    # empty file
    p = tmp_path / "empty.jsonl"
    p.write_text("")
    with pytest.raises(ValueError, match="empty workload"):
        Workload.load(str(p))


def test_scale_rate_compresses_offsets():
    wl = steady_workload()
    fast = wl.scale_rate(2.0)
    assert len(fast) == len(wl)
    for a, b in zip(fast.entries, wl.entries):
        assert a.arrival_offset_ms == pytest.approx(
            b.arrival_offset_ms / 2.0)


# --------------------------------------------------------------------------
# chaos schedules
# --------------------------------------------------------------------------
def test_chaos_schedule_random_is_seeded():
    kw = dict(duration_ms=10_000.0, kills=2, restore_after_ms=500.0,
              scale_events=1)
    a = ChaosSchedule.random(5, **kw).to_dicts()
    b = ChaosSchedule.random(5, **kw).to_dicts()
    c = ChaosSchedule.random(6, **kw).to_dicts()
    assert a == b
    assert a != c


def test_chaos_target_choice_is_seeded_per_fleet():
    # an unpinned kill target is drawn from the schedule's rng over the
    # SORTED active pool: same seed, same fleet shape => same victim
    victims = []
    for _ in range(2):
        fleet, _ = sim_fleet(n=3)
        try:
            sched = ChaosSchedule([ChaosAction("kill", after_entries=1)],
                                  seed=9)
            events = sched.fire_due(fleet, offset_ms=0.0, entries_done=1)
            assert len(events) == 1 and events[0]["ok"]
            victims.append(events[0]["target"])
        finally:
            fleet.close()
    assert victims[0] == victims[1]


def test_chaos_kill_then_restore_round_trips_membership():
    fleet, _ = sim_fleet(n=3)
    try:
        sched = ChaosSchedule([
            ChaosAction("kill", after_entries=2, target="replica1"),
            ChaosAction("restore", after_entries=4, target="replica1"),
        ])
        assert sched.fire_due(fleet, 0.0, entries_done=1) == []
        ev = sched.fire_due(fleet, 0.0, entries_done=2)
        assert [e["action"] for e in ev] == ["kill"]
        assert "replica1" in fleet.replica_ids("lost")
        ev = sched.fire_due(fleet, 0.0, entries_done=4)
        assert [e["action"] for e in ev] == ["restore"]
        assert ev[0]["ok"] is True
        assert "replica1" in fleet.replica_ids("active")
        # every action fires exactly once
        assert sched.fire_due(fleet, 0.0, entries_done=99) == []
    finally:
        fleet.close()


def test_chaos_route_fault_arms_and_disarms_the_route_site():
    fleet, _ = sim_fleet(n=2)
    try:
        sched = ChaosSchedule([ChaosAction("route_fault", after_entries=0,
                                           times=1)], seed=3)
        ev = sched.fire_due(fleet, 0.0, entries_done=0)
        assert ev[0]["action"] == "route_fault" and ev[0]["ok"] is True
        assert len(sched._injectors) == 1
        sched.close()
        assert sched._injectors == []
    finally:
        fleet.close()


def test_chaos_action_validation():
    with pytest.raises(ValueError):
        ChaosAction("explode", after_entries=1)  # unknown action
    with pytest.raises(ValueError):
        ChaosAction("kill")  # no trigger
    with pytest.raises(ValueError):
        ChaosAction("kill", at_offset_ms=1.0, after_entries=1)  # both


# --------------------------------------------------------------------------
# recorder
# --------------------------------------------------------------------------
def test_recorder_roundtrip_from_live_fleet_stream():
    # success traces come from the replica ENGINES (the fleet's own trace
    # covers router-decided failures only), so the double emits the
    # engine-contract ok trace per submit
    rec = WorkloadRecorder(name="live", seed=2)
    tel = Telemetry(rec, resources=False)

    class TracingSimEngine(SimEngine):
        def submit(self, sample, deadline_ms=None, session=None):
            fut = super().submit(sample, deadline_ms=deadline_ms,
                                 session=session)
            r = {"type": "trace", "trace_id": f"t{self.submits}",
                 "kind": "serving_request", "status": "ok",
                 "latency_ms": 0.1, "replica_id": self.replica_id,
                 "deadline_budget_ms": deadline_ms}
            if session is not None:
                r["session_id"] = str(session)
            tel.emit(r)
            return fut

    engines = {}

    def factory(rid):
        engines[rid] = TracingSimEngine(rid)
        return engines[rid]

    fleet = ServingFleet(engine_factory=factory, n_replicas=2,
                         warmup_sample="w", drain_grace_s=0.2, seed=0,
                         telemetry=tel)
    try:
        futs = [fleet.submit(f"x{i}", deadline_ms=60_000.0,
                             session=f"s{i % 3}") for i in range(12)]
        for f in futs:
            f.result(timeout=10.0)
    finally:
        fleet.close()
        tel.close()
    wl = rec.workload()
    assert len(wl) == 12
    offs = [e.arrival_offset_ms for e in wl.entries]
    assert offs == sorted(offs) and offs[0] == 0.0  # normalized t0
    assert all(e.kind == "serving_request" for e in wl.entries)
    # the router hands the engine the REMAINING budget, so recorded
    # deadlines sit just under the caller's 60s
    assert all(e.deadline_ms == pytest.approx(60_000.0, abs=100.0)
               for e in wl.entries)
    assert {e.session_id for e in wl.entries} == {"s0", "s1", "s2"}
    # ...and the recorded workload replays clean
    _, summary = replay_once(wl, n_replicas=2, slo=False)
    assert summary["ok"] == 12 and summary["errors"] == 0


def test_recorder_from_a_real_mlp_fleet_carries_the_shape():
    # the port's InferenceEngine trace records carry the feature shape,
    # which the replay draws its samples at
    rec = WorkloadRecorder(name="mlp_live", seed=1)
    tel = Telemetry(rec, resources=False)
    fleet = mlp_fleet(n=2, telemetry=tel)
    try:
        rs = np.random.RandomState(0)
        futs = [fleet.submit(Sample(rs.rand(28, 28).astype(np.float32)),
                             deadline_ms=60_000.0, session=f"s{i % 2}",
                             idempotent=True) for i in range(10)]
        for f in futs:
            f.result(timeout=30.0)
    finally:
        fleet.close()
        tel.close()
    wl = rec.workload()
    assert len(wl) == 10
    assert all(e.shape == [28, 28] and e.kind == "serving_request"
               for e in wl.entries)
    _, summary = replay_once(wl, n_replicas=2, slo=False, target="mlp")
    assert summary["ok"] == 10


def test_recorder_expands_sample_weight_and_skips_fleet_noise():
    rec = WorkloadRecorder(name="sampled")
    # a 1-in-3 sampled ok record stands for 3 arrivals
    rec.emit({"type": "trace", "time": 100.0, "trace_id": "t1",
              "kind": "serving_request", "status": "ok",
              "latency_ms": 5.0, "sample_weight": 3})
    # fleet-managed replica casualty: the fleet re-routed this one and
    # emitted its own fleet_request outcome
    rec.emit({"type": "trace", "time": 100.1, "trace_id": "t2",
              "kind": "serving_request", "status": "cancelled",
              "replica_id": "replica0", "latency_ms": 1.0})
    # non-trace records pass through silently
    rec.emit({"type": "step", "time": 100.2, "step": 1})
    wl = rec.workload()
    assert len(wl) == 3
    assert all(e.kind == "serving_request" for e in wl.entries)


# --------------------------------------------------------------------------
# replay: the SLO-replay invariance contract
# --------------------------------------------------------------------------
def chaos_plan():
    return [ChaosAction("kill", after_entries=10).to_dict(),
            ChaosAction("restore", after_entries=25).to_dict()]


@pytest.mark.parametrize("target", TARGETS)
def test_same_workload_same_seed_is_invariant(target):
    wl = steady_workload(chaos=chaos_plan(), shape=_shape(target))
    a, summary = replay_once(wl, seed=1, target=target)
    b, _ = replay_once(wl, seed=1, target=target)
    result = compare_streams(a, b)
    assert not result.divergent, result.details
    assert summary["entries_total"] == len(wl)
    assert summary["ok"] == len(wl)
    assert summary["chaos_fired"] == 2
    assert summary["replicas"] == 3
    # the slo trajectory is part of the compared stream, not vacuous
    assert any(r["type"] == "slo_status" for r in a)
    assert any(r["type"] == "event" and r.get("event") == "chaos_action"
               for r in a)


@pytest.mark.parametrize("target", TARGETS)
def test_perturbed_seed_diverges_with_pointer(target):
    wl = steady_workload(chaos=chaos_plan(), shape=_shape(target))
    a, _ = replay_once(wl, seed=1, target=target)
    b, _ = replay_once(wl, seed=2, target=target)
    result = compare_streams(a, b)
    assert result.divergent
    assert result.first.startswith("config[0].seed")


@pytest.mark.parametrize("target", TARGETS)
def test_perturbed_replica_count_diverges_with_pointer(target):
    wl = steady_workload(chaos=chaos_plan(), shape=_shape(target))
    a, _ = replay_once(wl, n_replicas=3, seed=1, target=target)
    b, _ = replay_once(wl, n_replicas=2, seed=1, target=target)
    result = compare_streams(a, b)
    assert result.divergent
    assert result.first.startswith("config[0].replicas")


def test_outcome_divergence_is_caught_not_just_config():
    # same config fingerprint, different outcomes: doctor one stream's
    # tally; the diff must point at the outcome section
    wl = steady_workload()
    a, _ = replay_once(wl, seed=1)
    b = [dict(r) for r in a]
    for r in b:
        if r["type"] == "replay_summary":
            r["ok"] -= 1
            r["errors"] += 1
    for r in b:
        if r["type"] == "trace" and r["status"] == "ok":
            r["status"] = "error"
            break
    result = compare_streams(a, b)
    assert result.divergent
    assert "outcome" in result.first or "summary" in result.first


@pytest.mark.parametrize("target", TARGETS)
def test_replay_baseline_self_diff_stamps_summary(target):
    wl = steady_workload(shape=_shape(target))
    # baseline without an SloEngine: the second run emits no slo_status
    # records either, so the projected streams must match
    a, _ = replay_once(wl, seed=1, slo=False, target=target)
    sink = InMemorySink()
    tel = Telemetry(sink, resources=False)
    fleet = sim_fleet(n=3)[0] if target == "sim" else mlp_fleet(n=3)
    try:
        summary = WorkloadReplayer(fleet, wl, seed=1,
                                   clock=VirtualClock(), telemetry=tel,
                                   progress_every=10,  # heartbeat
                                   # cadence is part of the stream
                                   baseline=a).run()
    finally:
        fleet.close()
        tel.close()
    assert summary["divergent"] is False
    # a baseline of another seed is stamped divergent, with its pointer
    b, _ = replay_once(wl, seed=2, slo=False)
    sink = InMemorySink()
    fleet, _ = sim_fleet(n=3)
    try:
        summary = WorkloadReplayer(fleet, wl, seed=1, clock=VirtualClock(),
                                   progress_every=10, baseline=b).run()
    finally:
        fleet.close()
    assert summary["divergent"] is True
    assert summary["divergence"].startswith("config[0].seed")


# --------------------------------------------------------------------------
# replay: time compression and deadline semantics
# --------------------------------------------------------------------------
def test_time_compression_preserves_order_and_recorded_deadlines():
    wl = steady_workload(sessions=0)
    eng = SimEngine("solo")  # bare engine target: no fleet indirection
    summary = WorkloadReplayer(eng, wl, speed=100.0,
                               clock=VirtualClock()).run()
    assert summary["ok"] == len(wl)
    assert "replicas" not in summary  # not a fleet
    # deadlines honored AS RECORDED under compression
    assert eng.last_deadline_ms == 60_000.0
    assert eng.submits == len(wl)


def test_scale_deadlines_divides_budgets():
    wl = steady_workload(sessions=0)
    eng = SimEngine("solo")
    WorkloadReplayer(eng, wl, speed=100.0, scale_deadlines=True,
                     clock=VirtualClock()).run()
    assert eng.last_deadline_ms == pytest.approx(600.0)


def test_canonical_stream_is_ordered_and_virtual_timed():
    wl = steady_workload(chaos=chaos_plan())
    records, _ = replay_once(wl, seed=1, slo=False)
    traces = [r for r in records if r["type"] == "trace"]
    assert len(traces) == len(wl)
    offs = [r["arrival_offset_ms"] for r in traces]
    assert offs == sorted(offs)
    assert [r["trace_id"] for r in traces] == \
        [f"replay-{i:06d}" for i in range(len(wl))]
    for r in traces:  # virtual time = epoch + offset, not wall clock
        assert r["time"] == pytest.approx(r["arrival_offset_ms"] / 1e3,
                                          abs=1e-6)
        assert "latency_ms" in r
    # replay and summary records validate against the closed schemas
    for r in records:
        if r["type"] in ("trace", "workload_replay", "replay_summary"):
            validate_record(r)


def test_classify_maps_the_port_exceptions():
    from concurrent.futures import CancelledError

    from bigdl_tpu_torch.serving import (ServingReroutedError,
                                         ServingUnavailableError)
    from bigdl_tpu_torch.serving.engine import (QueueFullError,
                                                ServingTimeoutError)
    from bigdl_tpu_torch.workload.replay import _classify
    assert _classify(None) == "ok"
    assert _classify(ServingTimeoutError("t")) == "timeout"
    assert _classify(QueueFullError("q")) == "shed"
    assert _classify(CancelledError()) == "cancelled"
    assert _classify(ServingReroutedError("r")) == "error"
    assert _classify(ServingUnavailableError("u")) == "error"
    assert _classify(ValueError("v")) == "error"


# --------------------------------------------------------------------------
# diff CLI and Prometheus surfaces
# --------------------------------------------------------------------------
def _write_stream(path, records):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def test_metrics_cli_diff_exit_codes(tmp_path, capsys):
    wl = steady_workload()
    a, _ = replay_once(wl, seed=1)
    b, _ = replay_once(wl, seed=1)
    p, _ = replay_once(wl, seed=2)
    pa, pb, pp = (str(tmp_path / n) for n in ("a.jsonl", "b.jsonl",
                                              "p.jsonl"))
    _write_stream(pa, a)
    _write_stream(pb, b)
    _write_stream(pp, p)
    assert cli_diff(pa, pb) == 0
    assert "identical" in capsys.readouterr().out
    assert cli_diff(pa, pp) == 1
    out = capsys.readouterr().out
    assert "DIVERGENT" in out and "first divergence" in out
    # malformed / unreadable inputs are exit 2 (distinct from divergent)
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as f:
        f.write("not json\n")
    assert cli_diff(pa, bad) == 2
    assert cli_diff(pa, str(tmp_path / "missing.jsonl")) == 2
    capsys.readouterr()


def test_prometheus_renders_replay_gauges():
    sink = PrometheusTextSink()
    sink.emit({"type": "workload_replay", "time": 1.0, "workload": "wl",
               "entries_total": 40, "entries_done": 20, "chaos_fired": 1,
               "ok": 19, "errors": 1, "timeouts": 0, "shed": 0,
               "offset_ms": 500.0})
    sink.emit({"type": "replay_summary", "time": 2.0, "workload": "wl",
               "entries_total": 40, "ok": 39, "errors": 1, "timeouts": 0,
               "shed": 0, "chaos_fired": 2, "seed": 7,
               "divergent": False})
    text = sink.render()
    assert 'bigdl_tpu_workload_replay_entries_done{workload="wl"} 20' \
        in text
    assert 'bigdl_tpu_workload_replay_ok_total{workload="wl"} 19' in text
    assert 'bigdl_tpu_workload_replay_chaos_fired{workload="wl"} 1' \
        in text
    assert ('bigdl_tpu_workload_replay_divergent'
            '{workload="wl",seed="7"} 0') in text
    assert ('bigdl_tpu_workload_replay_complete'
            '{workload="wl",seed="7"} 1') in text


def test_prometheus_reads_a_real_replay():
    # the gauges fed by the replayer's own records, with its self-diff
    wl = steady_workload(chaos=chaos_plan())
    a, _ = replay_once(wl, seed=1, slo=False)
    prom = PrometheusTextSink()
    tel = Telemetry(prom, resources=False)
    fleet, _ = sim_fleet(n=3)
    try:
        WorkloadReplayer(fleet, wl, seed=1, clock=VirtualClock(),
                         telemetry=tel, progress_every=10,
                         baseline=a).run()
    finally:
        fleet.close()
        tel.close()
    text = prom.render()
    assert (f'bigdl_tpu_workload_replay_entries_done{{workload="steady"}} '
            f'{len(wl)}') in text
    assert 'bigdl_tpu_workload_replay_chaos_fired{workload="steady"} 2' \
        in text
    assert ('bigdl_tpu_workload_replay_divergent'
            '{workload="steady",seed="1"} 0') in text


# --------------------------------------------------------------------------
# checked-in scenario files
# --------------------------------------------------------------------------
@pytest.mark.parametrize("target", TARGETS)
def test_checked_in_scenarios_load_and_replay(target):
    paths = sorted(p for p in os.listdir(WORKLOADS) if p.endswith(".jsonl"))
    assert paths, "tests/workloads/ scenario files missing"
    for p in paths:
        wl = Workload.load(os.path.join(WORKLOADS, p))
        assert len(wl) > 0
        offs = [e.arrival_offset_ms for e in wl.entries]
        assert offs == sorted(offs)
    # the chaos scenario holds the invariance contract end to end
    wl = Workload.load(os.path.join(WORKLOADS, "kill_at_peak.jsonl"))
    assert wl.chaos, "kill_at_peak.jsonl must embed a chaos plan"
    a, summary = replay_once(wl, seed=4, target=target)
    b, _ = replay_once(wl, seed=4, target=target)
    assert not compare_streams(a, b).divergent
    assert summary["chaos_fired"] == len(wl.chaos)
    assert summary["ok"] == len(wl)


# --------------------------------------------------------------------------
# generate traffic over a fleet of GenerationEngines
# --------------------------------------------------------------------------
def test_generate_replay_over_an_lm_fleet_is_invariant():
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.serving import GenerationEngine
    model = TransformerLM(64, 32, 2, 4, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    arrivals = poisson_arrivals(40.0, 0.6, seed=7)
    n = len(arrivals)
    wl = synthesize("lm_generate", arrivals, seed=7, kind="fleet_generate",
                    prompt_tokens=12, max_new_tokens=4, sessions=4,
                    deadline_ms=60_000.0,
                    chaos=[ChaosAction("kill", after_entries=n // 3)
                           .to_dict(),
                           ChaosAction("restore",
                                       after_entries=2 * n // 3).to_dict()])
    assert all(e.prompt_tokens == 12 and e.is_generate() for e in wl)
    engines = []

    def factory(rid):
        eng = GenerationEngine(model, slots=4, max_len=32, prefill_batch=4,
                               max_new_tokens=4, replica_id=rid,
                               device="cpu")
        engines.append(eng)
        return eng

    def replay():
        sink = InMemorySink()
        tel = Telemetry(sink, resources=False)
        SloEngine(default_slos(latency_p99_ms=60_000.0),
                  emit_every_s=0.25).attach(tel)
        fleet = ServingFleet(engine_factory=factory, n_replicas=2,
                             warmup_sample=np.ones(12, np.int32),
                             drain_grace_s=0.0, seed=0)
        try:
            summary = WorkloadReplayer(
                fleet, wl, chaos=ChaosSchedule.from_dicts(wl.chaos, seed=7),
                seed=7, clock=VirtualClock(), telemetry=tel,
                progress_every=5).run()
        finally:
            fleet.close()
            tel.close()
        return sink.records, summary

    a, summary = replay()
    b, _ = replay()
    assert not compare_streams(a, b).divergent
    assert summary["ok"] == n and summary["chaos_fired"] == 2
    assert len(engines) == 2 * 3  # two fleets of 2, one restore each
    traces = [r for r in a if r["type"] == "trace"]
    assert {r["kind"] for r in traces} == {"fleet_generate"}
    assert all(r["prompt_tokens"] == 12 for r in traces)


# --------------------------------------------------------------------------
# the drill (tools/bench.py --model replay_invariance) on the CPU
# --------------------------------------------------------------------------
def test_bench_replay_invariance_mlp(tmp_path, monkeypatch, capsys):
    from bigdl_tpu_torch.tools import bench, metrics_cli
    monkeypatch.setenv("BIGDL_TPU_TELEMETRY", str(tmp_path))
    out = bench.bench_replay_invariance(device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert out["invariant"] and out["invariance_break"] is None
    assert out["perturbation_detected"]
    assert out["perturbation_pointer"].startswith("config[0].seed")
    assert out["chaos_fired"] == 2 and out["workload_entries"] == 90
    assert out["outcomes"] == {"ok": 90, "errors": 0, "timeouts": 0,
                               "shed": 0}
    assert [r["seed"] for r in out["replays"]] == [7, 7, 8]
    # four fleets of 3 (the recorded run and three replays), each with
    # one restored replica
    assert out["engines_built"] == 4 * (3 + 1)
    assert out["batches"] > 0 and out["warmup_buckets"] > 0
    a, b, p = out["streams"]
    wl = Workload.load(out["workload_file"])
    assert all(e.shape == [28, 28] for e in wl.entries)
    assert [c["action"] for c in wl.chaos] == ["kill", "restore"]
    assert metrics_cli.diff(a, b) == 0
    assert metrics_cli.diff(a, p) == 1
    assert metrics_cli.slo([a], check=True, latency_p99_ms=60_000.0) == 0
    capsys.readouterr()


def test_bench_replay_invariance_refuses_an_unknown_model():
    from bigdl_tpu_torch.tools import bench
    with pytest.raises(ValueError, match="mlp"):
        bench.bench_replay_invariance(model="vgg", device="cpu")


# --------------------------------------------------------------------------
# against the JAX package
# --------------------------------------------------------------------------
import bigdl_tpu.workload as jwl  # noqa: E402


@pytest.mark.parametrize("gen", ["poisson_arrivals", "bursty_arrivals",
                                 "diurnal_arrivals"])
@pytest.mark.parametrize("seed", [0, 11])
def test_arrivals_and_synthesized_files_equal_the_reference(gen, seed,
                                                            tmp_path):
    import bigdl_tpu_torch.workload as twl
    a = getattr(twl, gen)(40.0, 0.6, seed=seed)
    b = getattr(jwl, gen)(40.0, 0.6, seed=seed)
    assert a == b
    kw = dict(seed=seed, kind="fleet_generate", prompt_tokens=256,
              max_new_tokens=16, sessions=4, deadline_ms=60_000.0,
              chaos=[{"action": "kill", "after_entries": len(a) // 3},
                     {"action": "restore",
                      "after_entries": 2 * len(a) // 3}])
    tw = twl.synthesize("gen", a, **kw)
    jw = jwl.synthesize("gen", b, **kw)
    assert tw.sha256() == jw.sha256()
    tw.save(str(tmp_path / "t.jsonl"))
    jw.save(str(tmp_path / "j.jsonl"))
    assert (tmp_path / "t.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()
    # ...and each package loads the other's file to the same workload
    assert twl.Workload.load(str(tmp_path / "j.jsonl")).sha256() == \
        jwl.Workload.load(str(tmp_path / "t.jsonl")).sha256()
    # the rate transform too
    assert tw.scale_rate(2.5).sha256() == jw.scale_rate(2.5).sha256()


@pytest.mark.parametrize("seed", [0, 5, 42])
def test_random_chaos_plans_equal_the_reference(seed):
    kw = dict(duration_ms=10_000.0, kills=2, restore_after_ms=500.0,
              scale_events=3)
    assert ChaosSchedule.random(seed, **kw).to_dicts() == \
        jwl.ChaosSchedule.random(seed, **kw).to_dicts()


def _trace_records():
    """A live fleet stream's shapes: ok replica records, a sampled one, a
    fleet casualty, fleet outcomes, generate records, and noise."""
    rs = np.random.RandomState(3)
    recs = []
    t = 1000.0
    for i in range(24):
        t += float(rs.exponential(0.01))
        kind = ["serving_request", "fleet_request", "generate",
                "fleet_generate"][i % 4]
        r = {"type": "trace", "time": t, "trace_id": f"t{i}", "kind": kind,
             "status": "ok", "latency_ms": float(rs.uniform(1, 9)),
             "session_id": f"s{i % 3}",
             "deadline_budget_ms": 60_000.0 - i}
        if kind.endswith("request"):
            r["shape"] = [28, 28]
        else:
            r["prompt_tokens"] = 5 + i
            r["tokens"] = 8
        if i % 5 == 0:
            r["sample_weight"] = 3
        if i % 7 == 0:
            r.update(replica_id="replica0", status="cancelled")
        if i % 11 == 0:
            r["idempotent"] = False
        recs.append(r)
    recs.append({"type": "event", "time": t, "event": "worker_lost"})
    recs.append({"type": "trace", "time": t, "trace_id": "x",
                 "kind": "generation", "status": "ok"})
    return recs


def test_recorder_equals_the_reference_recorder(tmp_path):
    port, ref = WorkloadRecorder("rec", seed=4), jwl.WorkloadRecorder(
        "rec", seed=4)
    for r in _trace_records():
        port.emit(dict(r))
        ref.emit(dict(r))
    chaos = [ChaosAction("kill", after_entries=3).to_dict()]
    tw, jw = port.workload(chaos=chaos), ref.workload(chaos=chaos)
    assert len(tw) == len(jw) > 0
    assert [e.to_dict() for e in tw] == [e.to_dict() for e in jw]
    assert tw.sha256() == jw.sha256()
    tw.save(str(tmp_path / "t.jsonl"))
    jw.save(str(tmp_path / "j.jsonl"))
    assert (tmp_path / "t.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()


def _jax_mlp_and_port_twin():
    """The reference drill's MLP (JAX, its own init) and the port's MLP
    carrying its weights."""
    import bigdl_tpu.nn as jnn
    from bigdl_tpu_torch.interop.jax_params import load_module_params
    jm = (jnn.Sequential().add(jnn.Reshape([784]))
          .add(jnn.Linear(784, 32)).add(jnn.Tanh())
          .add(jnn.Linear(32, 10)).add(jnn.LogSoftMax()))
    params = jm.ensure_params()
    tm = mlp()
    load_module_params(tm, {k: {n: np.asarray(v) for n, v in sub.items()}
                            for k, sub in params.items()})
    return jm, tm


def _replay_kill_at_peak(fleet_cls, model, wl, replayer_cls, schedule_cls,
                         clock_cls, sink, tel, slo, engine_kwargs):
    slo.attach(tel)
    fleet = fleet_cls(model, n_replicas=3,
                      warmup_sample=np.zeros((28, 28), np.float32),
                      drain_grace_s=0.2, seed=0,
                      engine_kwargs=engine_kwargs)
    try:
        summary = replayer_cls(
            fleet, wl, chaos=schedule_cls.from_dicts(wl.chaos, seed=4),
            seed=4, clock=clock_cls(), telemetry=tel,
            progress_every=10).run()
    finally:
        fleet.close()
        tel.close()
    return sink.records, summary


def test_kill_at_peak_canonical_stream_equals_the_reference():
    from bigdl_tpu.observability import InMemorySink as JSink
    from bigdl_tpu.observability import Telemetry as JTelemetry
    from bigdl_tpu.observability.slo import SloEngine as JSlo
    from bigdl_tpu.observability.slo import default_slos as jdefault
    from bigdl_tpu.serving import ServingFleet as JFleet
    jm, tm = _jax_mlp_and_port_twin()
    path = os.path.join(WORKLOADS, "kill_at_peak.jsonl")
    kw = {"max_batch_size": 8, "max_wait_ms": 1.0, "queue_capacity": 256}
    sink = InMemorySink()
    port, psum = _replay_kill_at_peak(
        ServingFleet, tm, Workload.load(path), WorkloadReplayer,
        ChaosSchedule, VirtualClock, sink, Telemetry(sink, resources=False),
        SloEngine(default_slos(latency_p99_ms=60_000.0), emit_every_s=0.25),
        {**kw, "device": "cpu"})
    jsink = JSink()
    ref, rsum = _replay_kill_at_peak(
        JFleet, jm, jwl.Workload.load(path), jwl.WorkloadReplayer,
        jwl.ChaosSchedule, jwl.VirtualClock, jsink,
        JTelemetry(jsink, resources=False),
        JSlo(jdefault(latency_p99_ms=60_000.0), emit_every_s=0.25), kw)
    result = compare_streams(ref, port)
    assert not result.divergent, result.details
    assert jwl.compare_streams(ref, port).divergent is False
    assert psum["ok"] == rsum["ok"] == 157
    assert psum["chaos_fired"] == rsum["chaos_fired"] == 2
    assert psum["workload_sha256"] == rsum["workload_sha256"]
    # the chaos trail (targets drawn from the seed) is the same too
    trail = [{k: r.get(k) for k in ("action", "target", "ok")}
             for r in port if r.get("event") == "chaos_action"]
    assert trail == [{k: r.get(k) for k in ("action", "target", "ok")}
                     for r in ref if r.get("event") == "chaos_action"]


def test_workload_entry_rejects_a_negative_offset():
    with pytest.raises(ValueError, match="arrival_offset_ms"):
        WorkloadEntry(-1.0)
