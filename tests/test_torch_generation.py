"""Port parity: `bigdl_tpu_torch.serving.GenerationEngine` against the
JAX package's `greedy_decode_reference`.

The JAX `TransformerLM(vocab 64, embed 32, 2 layers, 4 heads)` weights are
carried into the port; the port's engine serves on the CPU
(`device="cpu"`) and its greedy tokens must equal the JAX full-recompute
reference. Token equality is meaningful only where the reference's top-2
log-prob margin is well above the two frameworks' f32 disagreement (~1e-5),
so the test asserts a margin of at least 1e-4 at every compared step.

Every engine is closed (context manager or `close()`): the suite fails on
a leaked non-daemon dispatcher thread.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.serving import default_buckets as jax_default_buckets
from bigdl_tpu.serving import default_seq_buckets as jax_default_seq_buckets
from bigdl_tpu.serving import greedy_decode_reference as jax_reference
from bigdl_tpu_torch.interop import load_transformer_lm_params
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.serving import (EngineClosedError, GenerationEngine,
                                     QueueFullError, ServingError,
                                     ServingTimeoutError, default_buckets,
                                     default_seq_buckets,
                                     greedy_decode_reference)

VOCAB, MAX_LEN = 64, 32
MIN_MARGIN = 1e-4


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(VOCAB, embed_dim=32, n_layer=2, n_head=4)
    params = jm.ensure_params(jax.random.PRNGKey(0))
    tm = TransformerLM(VOCAB, embed_dim=32, n_layer=2, n_head=4,
                       device="cpu")
    load_transformer_lm_params(tm, jax.tree_util.tree_map(np.asarray,
                                                          params))
    return jm, params, tm


def _engine(tm, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("max_new_tokens", 6)
    return GenerationEngine(tm, device="cpu", **kw)


def _prompts(n, seed=7, lo=2, hi=14):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, VOCAB + 1, size=rs.randint(lo, hi)).astype(
        np.int32) for _ in range(n)]


class TestParityWithJax:
    def test_concurrent_streams_match_jax_reference(self, models):
        """Nine requests over three seq buckets through four slots, so
        requests join and leave the decode batch mid-flight; budgets
        differ per request. Each stream equals the JAX reference."""
        jm, params, tm = models
        fwd = jax.jit(lambda p, t: jm.apply(p, t, None))
        prompts = _prompts(9)
        budgets = [3 + (i % 4) for i in range(len(prompts))]
        refs = [jax_reference(jm, params, p, n, pad_to=MAX_LEN, fwd=fwd)
                for p, n in zip(prompts, budgets)]
        for p, ref in zip(prompts, refs):
            seq = np.concatenate([p, ref[:-1]])[None].astype(np.int32)
            pad = np.ones((1, MAX_LEN), np.int32)
            pad[:, :seq.shape[1]] = seq
            logp = np.asarray(fwd(params, jnp.asarray(pad)))[0]
            top2 = np.sort(logp[p.size - 1:p.size - 1 + len(ref)], -1)
            assert (top2[:, -1] - top2[:, -2]).min() > MIN_MARGIN
        with _engine(tm) as eng:
            streams = [eng.generate(p, max_new_tokens=n)
                       for p, n in zip(prompts, budgets)]
            got = [s.result(timeout=120) for s in streams]
            stats = eng.generation_stats()
        assert got == refs
        assert stats["prefill_requests"] == len(prompts)
        assert stats["slot_joins"] == stats["slot_leaves"] == len(prompts)
        assert stats["tokens_total"] == sum(budgets)

    def test_port_reference_matches_jax_reference(self, models):
        jm, params, tm = models
        prompt = np.array([5, 9, 2, 33], np.int32)
        assert greedy_decode_reference(tm, prompt, 5) == \
            jax_reference(jm, params, prompt, 5)

    def test_stream_yields_the_result_tokens(self, models):
        _, _, tm = models
        with _engine(tm, max_new_tokens=5) as eng:
            prompt = np.array([2, 4], np.int32)
            toks = list(eng.stream(prompt))
            assert toks == eng.generate(prompt).result(60)
            assert len(toks) == 5

    def test_buckets_match_jax(self):
        for n in (1, 4, 24, 32):
            assert default_buckets(n) == jax_default_buckets(n)
        for n in (4, 8, 48, 64, 2048):
            assert default_seq_buckets(n) == jax_default_seq_buckets(n)
        with pytest.raises(ValueError):
            default_seq_buckets(0)


class TestAdmissionAndLifecycle:
    def test_inadmissible_requests_raise(self, models):
        _, _, tm = models
        with _engine(tm) as eng:
            for bad in ([], [0, 3], [3, VOCAB + 1], np.arange(1, 30)):
                with pytest.raises(ValueError):
                    eng.generate(np.asarray(bad, np.int32))
            with pytest.raises(ValueError):
                eng.generate([1, 2], max_new_tokens=0)

    def test_reject_admission_when_full(self, models):
        _, _, tm = models
        eng = _engine(tm, queue_capacity=1, admission="reject", start=False)
        try:
            first = eng.generate([1, 2, 3])
            with pytest.raises(QueueFullError):
                eng.generate([1, 2, 3])
            assert eng.stats()["rejected"] == 1
            eng.start()
            assert len(first.result(60)) == 6
        finally:
            eng.close()

    def test_block_admission_times_out(self, models):
        _, _, tm = models
        eng = _engine(tm, queue_capacity=1, start=False)
        try:
            eng.generate([1, 2])
            with pytest.raises(ServingTimeoutError):
                eng.generate([1, 2], deadline_ms=20)
        finally:
            eng.close(drain=False)

    def test_deadline_lapses_in_queue(self, models):
        _, _, tm = models
        eng = _engine(tm, start=False)
        try:
            s = eng.generate([3, 4], deadline_ms=1)
            time.sleep(0.02)
            eng.start()
            with pytest.raises(ServingTimeoutError):
                s.result(60)
            assert s.status == "timeout"
        finally:
            eng.close()

    def test_cancel_while_queued_and_mid_stream(self, models):
        _, _, tm = models

        class Slow:
            """Delegates to the model; a decode step takes >= 10 ms, so a
            20-token stream is still running when it is cancelled."""
            def __init__(self, model):
                self.model, self.device = model, model.device
                self.init_cache = model.init_cache
                self.apply_prefill = model.apply_prefill

            def apply_step(self, *a):
                time.sleep(0.01)
                return self.model.apply_step(*a)

        eng = _engine(Slow(tm), start=False, max_new_tokens=20)
        try:
            queued = eng.generate([5, 6])
            queued.cancel()
            eng.start()
            assert queued.result(60) == []
            assert queued.status == "cancelled"
            live = eng.generate([7, 8])
            assert live.get(0, timeout=60) is not None
            live.cancel()
            toks = live.result(60)
            assert live.status == "cancelled" and 1 <= len(toks) < 20
        finally:
            eng.close()

    def test_eos_stops_early_and_is_emitted(self, models):
        _, _, tm = models
        prompt = np.array([3, 5, 7], np.int32)
        ref = greedy_decode_reference(tm, prompt, 6)
        eos = ref[2]
        with _engine(tm, eos_id=eos) as eng:
            toks = eng.generate(prompt).result(60)
        assert toks == ref[:ref.index(eos) + 1]

    def test_close_without_drain_fails_queued_and_joins(self, models):
        _, _, tm = models
        eng = _engine(tm, start=False)
        s = eng.generate([1, 2, 3])
        eng.close(drain=False)
        with pytest.raises(EngineClosedError):
            s.result(10)
        with pytest.raises(EngineClosedError):
            eng.generate([1, 2])
        eng.close()  # idempotent
        assert not any(t.name == "bigdl-serving-dispatch" and t.is_alive()
                       for t in threading.enumerate())

    def test_close_drains_queued_work(self, models):
        _, _, tm = models
        eng = _engine(tm)
        streams = [eng.generate(p) for p in _prompts(6, seed=11)]
        eng.close()
        assert all(s.status == "ok" and len(s.result(0)) == 6
                   for s in streams)
        st = eng.stats()
        assert st["completed"] == 6 and st["queue_depth"] == 0

    def test_failed_prefill_is_contained(self, models):
        _, _, tm = models

        class FailOnce:
            """Delegates to the model; its first prefill raises."""
            def __init__(self, model):
                self.model, self.failed = model, False
                self.device = model.device
                self.init_cache = model.init_cache
                self.apply_step = model.apply_step

            def apply_prefill(self, *a):
                if not self.failed:
                    self.failed = True
                    raise RuntimeError("injected")
                return self.model.apply_prefill(*a)

        with _engine(FailOnce(tm)) as eng:
            bad = eng.generate([1, 2])
            with pytest.raises(ServingError, match="injected"):
                bad.result(60)
            assert len(eng.generate([1, 2]).result(60)) == 6
            assert eng.stats()["failed"] == 1

    def test_warmup_runs_every_shape(self, models):
        _, _, tm = models
        with _engine(tm, prefill_batch=4) as eng:
            assert eng.warmup() == len(eng.seq_buckets) * 2 + 1
            assert eng.stats()["batches"] == 0


class TestDevice:
    def test_default_device_without_cuda_raises(self, models):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        _, _, tm = models
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TransformerLM(VOCAB, embed_dim=32, n_layer=1, n_head=4)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GenerationEngine(tm, max_len=MAX_LEN)

    def test_engine_device_must_be_the_models(self, models):
        _, _, tm = models
        with pytest.raises(ValueError, match="lives on"):
            GenerationEngine(tm, max_len=MAX_LEN, device="meta")

    def test_dispatcher_runs_in_inference_mode(self, models):
        _, _, tm = models
        seen = []

        class Spy:
            def __init__(self, model):
                self.device = model.device
                self.init_cache = model.init_cache
                self.apply_prefill = model.apply_prefill
                self.model = model

            def apply_step(self, *a):
                seen.append(torch.is_inference_mode_enabled())
                return self.model.apply_step(*a)

        with _engine(Spy(tm)) as eng:
            eng.generate([1, 2, 3]).result(60)
        assert seen and all(seen)
