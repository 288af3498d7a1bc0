"""`bigdl_tpu_torch/observability/compilation.py` (`CompiledFunction`), the
port's counterpart of `bigdl_tpu/observability/compilation.py`, and the
sites behind it.

- One `compile` record a new signature (shapes, dtypes and the device of
  the signature arguments), none for a known one; `cache_hit` set when an
  earlier wrapper in the process saw the same (label, signature, op
  count); `last_info` per thread; the record validates against the
  reference's schema and has the reference's fields.
- The counts are `costs.count_costs` on the meta device: FLOPs as
  `count_flops` counts them, the aten ops as `jaxpr_eqns`; a count that
  fails leaves None and the call runs.
- The loops: with telemetry the step runs behind a wrapper whose FLOPs
  are the step records' `flops_per_step` (`step_flops`), one record a
  batch signature, labelled as the reference's; without telemetry the
  step is the plain function. The engines: one `serving.forward` record a
  warmed bucket, `stats()`'s FLOPs the count of each dispatched bucket;
  the generation engine's prefill and decode records.
"""

import threading

import numpy as np
import pytest
import torch

from bigdl_tpu.observability.telemetry import \
    validate_record as jvalidate_record
import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.observability import (CompiledFunction, InMemorySink,
                                           Telemetry, validate_record)
from bigdl_tpu_torch.observability.compilation import (arg_signature,
                                                       signature_str)
from bigdl_tpu_torch.optim import (SGD, DistriOptimizer, LocalOptimizer,
                                   max_iteration)
from bigdl_tpu_torch.optim.local_optimizer import step_flops
from bigdl_tpu_torch.serving import InferenceEngine

#: the fields of the reference's compile records
FIELDS = {"type", "time", "label", "signature", "lower_s", "compile_s",
          "jaxpr_eqns", "cache_hit", "flops", "bytes_accessed"}


def _tel():
    sink = InMemorySink()
    return sink, Telemetry(sink, resources=False, flight=False)


def _matmul(a, b):
    return torch.relu(a @ b)


def test_one_record_a_signature_and_cache_hits_across_wrappers():
    sink, tel = _tel()
    f = CompiledFunction(_matmul, label="test.matmul", telemetry=tel)
    a, b = torch.ones(4, 5), torch.ones(5, 3)
    for _ in range(3):
        f(a, b)
    f(torch.ones(2, 5), b)
    g = CompiledFunction(_matmul, label="test.matmul", telemetry=tel)
    out = g(a, b)
    assert torch.equal(out, _matmul(a, b))
    recs = [r for r in sink.records if r["type"] == "compile"]
    assert [r["signature"] for r in recs] == [
        "4x5:float32|5x3:float32@cpu", "2x5:float32|5x3:float32@cpu",
        "4x5:float32|5x3:float32@cpu"]
    assert [r["cache_hit"] for r in recs] == [False, False, True]
    assert [r["flops"] for r in recs] == [2 * 4 * 5 * 3, 2 * 2 * 5 * 3,
                                          2 * 4 * 5 * 3]
    for r in recs:
        validate_record(r)
        jvalidate_record(r)
        assert set(r) == FIELDS and r["bytes_accessed"] is None
        assert r["jaxpr_eqns"] == 2 and r["compile_s"] >= 0
    assert f._cache_size() == 2 and g._cache_size() == 1
    assert f.cost_info(a, b)["flops"] == 120
    assert f.cost_info(torch.ones(3, 5), b) is None


def test_signature_args_devices_and_nested_leaves():
    sig = arg_signature(({"x": torch.ones(2, 3, dtype=torch.bfloat16)},
                         [np.zeros(4, np.int32), 3]))
    assert signature_str(sig) == "2x3:bfloat16|4:int32|py:int"
    sink, tel = _tel()
    f = CompiledFunction(lambda w, x: w * x, label="test.sig", telemetry=tel,
                         sig_argnums=(1,))
    w = torch.ones(3)
    f(w, torch.ones(3))
    f(torch.zeros(3), torch.ones(3))  # a non-signature argument changed
    f(w, torch.ones(3, dtype=torch.float64))
    assert [r["signature"] for r in sink.records] == ["3:float32@cpu",
                                                      "3:float64@cpu"]


def test_last_info_is_per_thread():
    f = CompiledFunction(_matmul, label="test.threads")
    f(torch.ones(4, 5), torch.ones(5, 3))
    seen = []
    t = threading.Thread(target=lambda: seen.append(
        (f.last_info, f(torch.ones(1, 5), torch.ones(5, 3)),
         f.last_info["flops"])))
    t.start()
    t.join()
    assert seen[0][0] is None and seen[0][2] == 30
    assert f.last_info["flops"] == 120


def test_a_failed_count_leaves_none_and_the_call_runs():
    def meta(*args):
        raise RuntimeError("no meta route")

    sink, tel = _tel()
    f = CompiledFunction(_matmul, label="test.fail", telemetry=tel, meta=meta)
    out = f(torch.ones(2, 2), torch.ones(2, 2))
    assert torch.equal(out, torch.full((2, 2), 2.0))
    (r,) = sink.records
    assert r["flops"] is None and r["jaxpr_eqns"] is None
    validate_record(r)


def _mlp():
    torch.manual_seed(0)
    return (nn.Sequential().add(nn.Linear(4, 8, device="cpu"))
            .add(nn.ReLU()).add(nn.Linear(8, 2, device="cpu"))
            .add(nn.LogSoftMax()))


def _batches(n=3, size=8):
    rs = np.random.RandomState(0)
    return [MiniBatch(rs.rand(size, 4).astype(np.float32),
                      (rs.randint(0, 2, size) + 1).astype(np.int64))
            for _ in range(n)]


@pytest.mark.parametrize("loop,label", [(LocalOptimizer, "local.step"),
                                        (DistriOptimizer, "distri.step")])
def test_the_loops_step_behind_a_wrapper(loop, label):
    kw = {"device": "cpu"} if loop is LocalOptimizer else {"devices": ["cpu"]}
    # a ragged last batch: a second signature, a second record
    batches = _batches() + _batches(1, 4)
    opt = loop(_mlp(), LocalDataSet(batches), nn.ClassNLLCriterion(), **kw)
    opt.set_optim_method(SGD(learning_rate=0.1)).set_end_when(
        max_iteration(6))
    sink, tel = _tel()
    opt.set_telemetry(tel)
    opt.optimize()
    recs = [r for r in sink.records if r["type"] == "compile"]
    steps = [r for r in sink.records if r["type"] == "step"]
    assert [r["label"] for r in recs] == [f"{label}/Sequential"] * 2
    assert [r["signature"] for r in recs] == [
        "8x4:float32|8:int64@cpu", "4x4:float32|4:int64@cpu"]
    assert recs[0]["flops"] == step_flops(opt, batches[0]) > 0
    assert recs[1]["flops"] == step_flops(opt, batches[3])
    by_size = {8: recs[0]["flops"], 4: recs[1]["flops"]}
    assert [r["flops_per_step"] for r in steps] == \
        [by_size[r["records"]] for r in steps]
    assert all(r["mfu"] is None for r in steps)  # no CPU peak
    # without telemetry: the plain step, no wrapper
    opt.set_telemetry(None)
    assert opt._compiled(len, None) is len


def test_the_engine_counts_each_bucket_once():
    sink, tel = _tel()
    with InferenceEngine(_mlp(), max_batch_size=4, max_wait_ms=0.0,
                         telemetry=tel, device="cpu") as eng:
        eng.warmup(Sample(np.ones(4, np.float32)))
        futs = [eng.submit(np.ones(4, np.float32)) for _ in range(3)]
        [f.result(10) for f in futs]
        stats = eng.stats()
    recs = [r for r in sink.records if r["type"] == "compile"]
    # the buckets are [2, 4]: one record each, at warm-up
    assert [r["label"] for r in recs] == ["serving.forward/Sequential"] * 2
    assert sorted(r["signature"] for r in recs) == [
        "2x4:float32@cpu", "4x4:float32@cpu"]
    per_row = 2 * (4 * 8 + 8 * 2)
    assert {r["signature"][0]: r["flops"] for r in recs} == {
        "2": 2 * per_row, "4": 4 * per_row}
    assert eng.compile_count() == 2
    # every dispatched batch (of 1 to 3 rows) ran one bucket's forward
    assert stats["flops_per_step"] in (2 * per_row, 3 * per_row,
                                       4 * per_row)


def test_the_generation_engine_records_prefill_and_decode():
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.serving import GenerationEngine
    model = TransformerLM(vocab_size=32, embed_dim=16, n_layer=1, n_head=2,
                          device="cpu",
                          generator=torch.Generator().manual_seed(0))
    sink, tel = _tel()
    with GenerationEngine(model, slots=2, max_len=16, prefill_batch=2,
                          max_new_tokens=3, seq_buckets=[8, 16],
                          telemetry=tel, device="cpu") as eng:
        eng.warmup()
        toks = list(eng.generate(np.array([1, 2, 3], np.int32)))
        stats = eng.stats()
    recs = [r for r in sink.records if r["type"] == "compile"]
    labels = [r["label"] for r in recs]
    assert labels.count("serving.decode/TransformerLM") == 1
    # seq buckets [8, 16] x batch buckets [2]: two prefill shapes
    assert labels.count("serving.prefill/TransformerLM") == 2
    assert len(toks) == 3 and stats["flops_per_step"] > 0
    for r in recs:
        validate_record(r)
        assert r["flops"] > 0
