"""Port parity: `bigdl_tpu_torch/tools/metrics_cli.py` against
`bigdl_tpu/tools/metrics_cli.py`, and `workload/diff.py` against
`bigdl_tpu/workload/diff.py`.

Both CLIs run on the same streams and must give the same exit code; `slo`
and `diff` print the same tables. The streams: a port training run's
JSONL (compile records included), a port serving engine's, a synthetic
fleet stream with a worker loss (whole, and cut before its recovery),
and the reference's malformed cases (missing, empty, header-only, a
non-object line, non-strict constants). The reference's breach drill
runs on the port: an injected latency breach alerts, dumps the flight
recorder, moves the `/metrics` gauges and fails `slo --check`.
"""

import io
import json
import re
import subprocess
import sys

import numpy as np
import pytest

from bigdl_tpu.tools import metrics_cli as jcli
from bigdl_tpu.workload import diff as jdiff
import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.observability import (SLO, FlightRecorder,
                                           InMemorySink, JsonlSink,
                                           PrometheusTextSink, SloEngine,
                                           Telemetry)
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_iteration
from bigdl_tpu_torch.serving import InferenceEngine
from bigdl_tpu_torch.tools import metrics_cli
from bigdl_tpu_torch.workload import compare_streams, load_stream


def _mlp():
    return (nn.Sequential().add(nn.Linear(4, 2, device="cpu"))
            .add(nn.LogSoftMax()))


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """name -> path of each stream both CLIs read."""
    d = tmp_path_factory.mktemp("streams")
    out = {}
    # a training run
    rs = np.random.RandomState(0)
    batches = [MiniBatch(rs.rand(8, 4).astype(np.float32),
                         (rs.randint(0, 2, 8) + 1).astype(np.int64))
               for _ in range(3)]
    out["train"] = str(d / "train.jsonl")
    opt = LocalOptimizer(_mlp(), LocalDataSet(batches), nn.ClassNLLCriterion(),
                         device="cpu")
    opt.set_optim_method(SGD(learning_rate=0.1)).set_end_when(
        max_iteration(4))
    tel = Telemetry(JsonlSink(out["train"]), resources=False, flight=False)
    opt.set_telemetry(tel)
    opt.optimize()
    tel.close()
    # a serving engine's
    out["serve"] = str(d / "serve.jsonl")
    tel = Telemetry(JsonlSink(out["serve"]), resources=False, flight=False)
    with InferenceEngine(_mlp(), max_batch_size=4, max_wait_ms=0.0,
                         telemetry=tel, emit_every=1, device="cpu") as eng:
        eng.warmup(Sample(np.ones(4, np.float32)))
        for _ in range(6):
            eng.predict(Sample(np.ones(4, np.float32)))
    tel.close()
    # a fleet-shaped stream: traffic, a serving worker lost mid-way, the
    # first ok request after it; and the same cut before that recovery
    recs = []
    t = 1000.0
    for i in range(40):
        t += 0.05
        if i == 20:
            recs.append({"type": "event", "event": "worker_lost",
                         "worker": "replica1", "role": "serving",
                         "time": t})
            t += 0.2
        recs.append({"type": "trace", "trace_id": f"f{i:04d}",
                     "kind": "fleet_request", "status": "ok",
                     "latency_ms": 10.0 + i % 5, "time": t})
    out["fleet"] = str(d / "fleet.jsonl")
    out["fleet_cut"] = str(d / "fleet_cut.jsonl")
    out["fleet_changed"] = str(d / "fleet_changed.jsonl")
    lines = [json.dumps(r) + "\n" for r in recs]
    cut = next(i for i, r in enumerate(recs)
               if r.get("event") == "worker_lost")
    changed = list(recs)
    changed[3] = {**changed[3], "status": "error"}
    for key, rows in (("fleet", lines), ("fleet_cut", lines[:cut + 1]),
                      ("fleet_changed",
                       [json.dumps(r) + "\n" for r in changed])):
        with open(out[key], "w") as f:
            f.writelines(rows)
    # the malformed ones
    for key, text in (("empty", ""),
                      ("header", json.dumps({"type": "run_start",
                                             "time": 1.0}) + "\n"),
                      ("nonobject", "[1, 2]\n"),
                      ("nan", '{"type": "step", "step": 1, "loss": NaN, '
                              '"time": 1.0}\n')):
        out[key] = str(d / f"{key}.jsonl")
        with open(out[key], "w") as f:
            f.write(text)
    out["missing"] = str(d / "nope.jsonl")
    return out


def _both(argv, capsys):
    """(rc, stdout, one-line stderr) of each CLI's main on argv."""
    res = []
    for cli in (metrics_cli, jcli):
        rc = cli.main(list(argv))
        cap = capsys.readouterr()
        res.append((rc, cap.out, cap.err))
    return res


CASES = [
    ["report", "train"], ["report", "serve"], ["report", "fleet"],
    ["report", "missing"], ["report", "empty"], ["report", "header"],
    ["report", "nonobject"], ["report", "nan"],
    ["report", "--lint-stream", "train"], ["report", "--lint-stream", "serve"],
    ["report", "--lint-stream", "nonobject"],
    ["slo", "fleet"], ["slo", "--check", "--mttr-s", "60", "fleet"],
    ["slo", "--check", "--mttr-s", "60", "fleet_cut"],
    ["slo", "--check", "--mttr-s", "0.1", "fleet"],
    ["slo", "--check", "--latency-p99-ms", "11", "fleet"],
    ["slo", "--check", "serve"], ["slo", "--check", "header"],
    ["slo", "--check", "train", "serve"], ["slo", "--bogus", "fleet"],
    ["slo", "--mttr-s", "abc", "fleet"], ["slo", "--mttr-s"],
    ["diff", "fleet", "fleet"], ["diff", "fleet", "fleet_changed"],
    ["diff", "fleet", "fleet_cut"], ["diff", "train", "serve"],
    ["diff", "fleet", "missing"], ["diff", "fleet"],
    ["trace", "f000", "fleet"], ["trace", "zzzz", "fleet"], ["trace"],
    [], ["-h"], ["bogus"],
]


@pytest.mark.parametrize("case", CASES, ids=[" ".join(c) or "none"
                                             for c in CASES])
def test_exit_codes_and_tables_match_the_reference(case, streams, capsys):
    argv = [streams.get(a, a) for a in case]
    (rc, out, err), (jrc, jout, jerr) = _both(argv, capsys)
    assert rc == jrc, (rc, jrc, err, jerr)
    if rc == 2:  # the usage, or a one-line diagnostic; no traceback
        assert err.startswith("usage:") or (
            err.startswith("metrics_cli:")
            and len(err.strip().splitlines()) == 1), err
    if case[:1] in (["slo"], ["diff"], ["trace"]):
        assert out == jout
    if case[:1] == ["report"] and "--lint-stream" in case:
        assert out == jout


def test_the_gates_decide_as_stated(streams, capsys):
    """What the parity above holds both CLIs to: the whole fleet stream
    passes `slo --check --mttr-s 60`, the cut one fails it, `diff` of a
    stream with itself is 0 and with one outcome changed 1."""
    out = io.StringIO()
    assert metrics_cli.slo([streams["fleet"]], check=True, mttr_s=60.0,
                           out=out) == 0
    assert "training_mttr" in out.getvalue()
    assert metrics_cli.slo([streams["fleet_cut"]], check=True, mttr_s=60.0,
                           out=io.StringIO()) == 1
    assert metrics_cli.diff(streams["fleet"], streams["fleet"],
                            out=io.StringIO()) == 0
    out = io.StringIO()
    assert metrics_cli.diff(streams["fleet"], streams["fleet_changed"],
                            out=out) == 1
    assert "outcomes[kind=fleet_request status=error]" in out.getvalue()
    assert metrics_cli.report(streams["train"], out=io.StringIO()) == 0


@pytest.mark.parametrize("pair", [("fleet", "fleet"),
                                  ("fleet", "fleet_changed"),
                                  ("fleet", "fleet_cut"),
                                  ("train", "serve"), ("serve", "serve")])
def test_compare_streams_matches_the_reference(pair, streams):
    a, b = (load_stream(streams[k]) for k in pair)
    ja, jb = (jdiff.load_stream(streams[k]) for k in pair)
    assert a == ja and b == jb
    got, want = compare_streams(a, b), jdiff.compare_streams(ja, jb)
    assert (got.divergent, got.first, got.details) == \
        (want.divergent, want.first, want.details)
    assert bool(got) == (not got.divergent)


def test_load_stream_refuses_what_the_reference_refuses(streams):
    for key in ("nan", "nonobject"):
        with pytest.raises(ValueError, match=r"\.jsonl:1:"):
            load_stream(streams[key])


def test_the_module_runs_as_a_program(streams):
    """`python -m bigdl_tpu_torch.tools.metrics_cli` (its exit code)."""
    cut = subprocess.run(
        [sys.executable, "-m", "bigdl_tpu_torch.tools.metrics_cli", "slo",
         "--check", streams["fleet_cut"]], capture_output=True, text=True,
        timeout=120)
    assert cut.returncode == 1, cut.stderr
    assert "VIOLATED: training_mttr" in cut.stdout


def test_injected_breach_alerts_dumps_and_fails_the_gate(tmp_path):
    """The reference's `TestLatencyBreachEndToEnd` on the port engine."""
    jsonl = str(tmp_path / "run.jsonl")
    flight = FlightRecorder(dump_dir=str(tmp_path / "flight"))
    prom, sink = PrometheusTextSink(), InMemorySink()
    tel = Telemetry(JsonlSink(jsonl), prom, sink, resources=False,
                    flight=flight)
    SloEngine([SLO("serving_latency_p99", "latency", objective=0.99,
                   threshold_ms=1e-4, windows=((0.5, 2.0, 1.5),))],
              emit_every_s=0.1).attach(tel)
    eng = InferenceEngine(_mlp(), max_batch_size=4, max_wait_ms=0.0,
                          telemetry=tel, device="cpu")
    try:
        eng.warmup(Sample(np.ones(4, np.float32)))
        for _ in range(10):
            eng.predict(Sample(np.ones(4, np.float32)))
    finally:
        eng.close()
    tel.close()
    alerts = [r for r in sink.records if r["type"] == "alert"]
    assert alerts and alerts[0]["slo"] == "serving_latency_p99"
    assert flight.dumps >= 1
    with open(flight.last_dump_path) as f:
        dump = json.load(f)
    assert dump["trigger"] == "alert"
    render = prom.render()
    assert re.search(r'slo_burn_rate\{slo="serving_latency_p99"\} \d',
                     render)
    assert 'slo_alerting{slo="serving_latency_p99"} 1' in render
    assert metrics_cli.main(["slo", "--check", "--latency-p99-ms", "0.0001",
                             jsonl]) == 1
    assert metrics_cli.main(["slo", "--check", "--latency-p99-ms", "60000",
                             jsonl]) == 0
