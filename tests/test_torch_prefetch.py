"""Port parity: `bigdl_tpu_torch/dataset/prefetch.py` and the loops'
`set_prefetch`, after the reference's `tests/test_prefetch.py`.

- `ThreadedPrefetcher`: with `deterministic=True` and jittered workers the
  output order is serial iteration's, the reference prefetcher's too;
  best-effort mode keeps the multiset; a worker's exception reaches the
  consumer; `close()` is idempotent and joins; `depth` bounds the
  lookahead; bad arguments and a `StopIteration` from the function are
  refused.
- `split_elementwise_prefix` splits a chain as the reference's does.
- `build_input_pipeline`: two stages give serial iteration's batches,
  byte for byte; the health gauges; `workers` defaults to
  `Engine.config["io_threads"]`.
- The loops: `LocalOptimizer` and `DistriOptimizer` train to the same
  losses bit for bit with and without prefetch within an epoch, the step
  records carry the gauges, the threads are joined after every
  `optimize()`, a failed one included, and a `prefetch.worker` fault
  under a `RetryPolicy` leaves the order intact. Across a real
  `LocalDataSet` epoch-boundary shuffle, which lands where the lookahead
  has the source, the batches are the source's stream with the shuffle
  at that place: no item lost, duplicated or moved.
"""

import random
import threading
import time

import numpy as np
import pytest

from bigdl_tpu.dataset import prefetch as jprefetch
from bigdl_tpu.dataset.transformer import FuncTransformer as JFunc
from bigdl_tpu.dataset.transformer import SampleToMiniBatch as JToBatch
import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.dataset import (FuncTransformer, InputPipeline,
                                     LocalDataSet, Sample, SampleToMiniBatch,
                                     ThreadedPrefetcher,
                                     build_input_pipeline,
                                     split_elementwise_prefix)
from bigdl_tpu_torch.observability import InMemorySink, Telemetry
from bigdl_tpu_torch.optim import (SGD, DistriOptimizer, LocalOptimizer,
                                   max_iteration)
from bigdl_tpu_torch.resilience import FaultInjector, FaultSpec, RetryPolicy
from bigdl_tpu_torch.utils.engine import Engine


def _jitter(x):
    time.sleep(random.random() * 0.002)
    return x * 2


def _threads():
    return {t for t in threading.enumerate() if not t.daemon}


class TestThreadedPrefetcher:
    def test_deterministic_order_with_jittered_workers(self):
        got = list(ThreadedPrefetcher(iter(range(200)), fn=_jitter, depth=8,
                                      workers=4))
        want = list(jprefetch.ThreadedPrefetcher(
            iter(range(200)), fn=_jitter, depth=8, workers=4))
        assert got == want == [2 * i for i in range(200)]

    def test_best_effort_same_multiset(self):
        p = ThreadedPrefetcher(iter(range(100)), fn=_jitter, depth=8,
                               workers=4, deterministic=False)
        assert sorted(p) == [2 * i for i in range(100)]
        p.close()

    def test_worker_exception_propagates(self):
        def boom(x):
            if x == 5:
                raise KeyError("bad item")
            return x

        p = ThreadedPrefetcher(iter(range(20)), fn=boom, depth=4, workers=2)
        with pytest.raises(KeyError):
            list(p)
        p.close()

    def test_close_is_idempotent_and_joins(self):
        before = _threads()
        p = ThreadedPrefetcher(iter(range(10 ** 6)), fn=_jitter, depth=4,
                               workers=3)
        next(p)
        p.close()
        p.close()
        assert _threads() <= before

    def test_depth_bounds_lookahead(self):
        pulled = []

        def source():
            for i in range(100):
                pulled.append(i)
                yield i

        p = ThreadedPrefetcher(source(), depth=5, workers=2)
        time.sleep(0.1)
        assert len(pulled) <= 5
        p.close()

    def test_validates_args(self):
        with pytest.raises(ValueError):
            ThreadedPrefetcher(iter([]), depth=0)
        with pytest.raises(ValueError):
            ThreadedPrefetcher(iter([]), workers=0)

    def test_fn_stopiteration_is_an_error_not_exhaustion(self):
        def stop(x):
            raise StopIteration

        p = ThreadedPrefetcher(iter(range(5)), fn=stop, depth=2, workers=1)
        with pytest.raises(RuntimeError, match="StopIteration"):
            list(p)
        p.close()


def _chain_names(t):
    if t is None:
        return None
    from bigdl_tpu_torch.dataset.prefetch import _flatten_chain
    return [type(s).__name__ for s in _flatten_chain(t)]


def test_chain_split_matches_the_reference():
    from bigdl_tpu.dataset.prefetch import _flatten_chain as jflat
    for port, ref in (
            ((FuncTransformer(abs), FuncTransformer(abs),
              SampleToMiniBatch(2)),
             (JFunc(abs), JFunc(abs), JToBatch(2))),
            ((FuncTransformer(abs),), (JFunc(abs),)),
            ((SampleToMiniBatch(2), FuncTransformer(abs)),
             (JToBatch(2), JFunc(abs)))):
        from bigdl_tpu.dataset.transformer import chain as jchain
        from bigdl_tpu_torch.dataset import chain
        got = split_elementwise_prefix(chain(*port))
        want = jprefetch.split_elementwise_prefix(jchain(*ref))
        assert [_chain_names(t) for t in got] == \
            [None if t is None else [type(s).__name__ for s in jflat(t)]
             for t in want]


def _samples(n=64, seed=0):
    rs = np.random.RandomState(seed)
    return [Sample(rs.rand(4).astype(np.float32),
                   np.int64(rs.randint(1, 3))) for _ in range(n)]


def _scale(s):
    return Sample(s.feature * 2.0, s.label)


def _dataset(samples, batch=8):
    return LocalDataSet(samples).transform(
        FuncTransformer(_scale) >> SampleToMiniBatch(batch))


class TestInputPipeline:
    def test_two_stage_pipeline_byte_identical(self):
        samples = _samples()
        serial = _dataset(samples).data(train=False)
        want = [(b.get_input().tobytes(), b.get_target().tobytes())
                for b in serial]
        pipe = build_input_pipeline(_dataset(samples), train=False,
                                    depth=4, workers=3)
        assert isinstance(pipe, InputPipeline) and len(pipe._stages) == 2
        got = [(b.get_input().tobytes(), b.get_target().tobytes())
               for b in pipe]
        pipe.close()
        assert got == want and len(got) == 8

    def test_health_gauges(self):
        pipe = build_input_pipeline(_dataset(_samples()), train=False,
                                    depth=4, workers=2)
        next(pipe)
        h = pipe.health()
        pipe.close()
        assert set(h) == {"prefetch_queue_depth", "prefetch_fetch_wait_s",
                          "prefetch_worker_busy"}
        assert h["prefetch_queue_depth"] >= 0
        assert 0.0 <= h["prefetch_worker_busy"] <= 1.0

    def test_workers_default_from_engine_io_threads(self, monkeypatch):
        monkeypatch.setitem(Engine.config, "io_threads", 3)
        pipe = build_input_pipeline(_dataset(_samples()), train=False)
        assert pipe._stages[0]._workers_n == 3
        pipe.close()
        with pytest.raises(ValueError):
            build_input_pipeline(_dataset(_samples()), workers=0)


def _mlp():
    import torch
    torch.manual_seed(0)
    return (nn.Sequential().add(nn.Linear(4, 8, device="cpu"))
            .add(nn.ReLU()).add(nn.Linear(8, 2, device="cpu"))
            .add(nn.LogSoftMax()))


def _train(loop, prefetch=None, iters=8, samples=None, telemetry=None,
           plan=None):
    ds = _dataset(samples or _samples())
    kw = {"device": "cpu"} if loop is LocalOptimizer else {"devices": ["cpu"]}
    opt = loop(_mlp(), ds, nn.ClassNLLCriterion(), **kw)
    opt.set_optim_method(SGD(learning_rate=0.1, momentum=0.9))
    opt.set_end_when(max_iteration(iters))
    if telemetry is not None:
        opt.set_telemetry(telemetry)
    if prefetch is not None:
        opt.set_prefetch(**prefetch)
    losses = []
    opt.set_iteration_hook(lambda s: losses.append(s["loss"]))
    if plan is not None:
        with plan:
            opt.optimize()
    else:
        opt.optimize()
    return losses, opt


class TestTrainLoopIntegration:
    @pytest.mark.parametrize("loop", [LocalOptimizer, DistriOptimizer])
    def test_losses_bitwise_serial_within_an_epoch(self, loop):
        before = _threads()
        serial, _ = _train(loop)
        pre, opt = _train(loop, {"workers": 3, "depth": 6})
        assert pre == serial and len(pre) == 8
        assert _threads() <= before and opt._active_pipeline is None

    def test_set_prefetch_validates_and_disables(self):
        opt = LocalOptimizer(_mlp(), _dataset(_samples()),
                             nn.ClassNLLCriterion(), device="cpu")
        with pytest.raises(ValueError):
            opt.set_prefetch(workers=0)
        with pytest.raises(ValueError):
            opt.set_prefetch(depth=-1, workers=2)
        assert opt.setPrefetch(workers=2)._prefetch["depth"] == 8
        assert opt.set_prefetch(depth=0)._prefetch is None

    def test_gauges_in_the_step_records(self):
        sink = InMemorySink()
        _train(DistriOptimizer, {"workers": 2},
               telemetry=Telemetry(sink, resources=False, flight=False))
        steps = [r for r in sink.records if r["type"] == "step"]
        assert len(steps) == 8
        for r in steps:
            assert {"prefetch_queue_depth", "prefetch_fetch_wait_s",
                    "prefetch_worker_busy"} <= set(r)

    @pytest.mark.parametrize("loop", [LocalOptimizer, DistriOptimizer])
    def test_threads_are_joined_after_a_failed_optimize(self, loop):
        before = _threads()

        def bad(s):
            if s.feature[0] > 0.95:
                raise KeyError("a broken record")
            return s

        samples = _samples()
        ds = LocalDataSet(samples).transform(
            FuncTransformer(bad) >> SampleToMiniBatch(8))
        kw = {"device": "cpu"} if loop is LocalOptimizer \
            else {"devices": ["cpu"]}
        opt = loop(_mlp(), ds, nn.ClassNLLCriterion(), **kw)
        opt.set_end_when(max_iteration(8)).set_prefetch(workers=3)
        with pytest.raises(KeyError):
            opt.optimize()
        assert _threads() <= before and opt._active_pipeline is None

    def test_worker_fault_under_retry_keeps_the_order(self):
        """A transient `prefetch.worker` fault at the 3rd and 9th items,
        retried in the worker, leaves the batches where serial iteration
        puts them: the same losses."""
        serial, _ = _train(LocalOptimizer)
        plan = FaultInjector(FaultSpec("prefetch.worker", at_hit=3),
                             FaultSpec("prefetch.worker", at_hit=9))
        policy = RetryPolicy(max_retries=2, base_delay_s=0.0)
        got, _ = _train(LocalOptimizer, {"workers": 3,
                                         "retry_policy": policy},
                        plan=plan)
        assert plan.hits("prefetch.worker") >= 9
        assert got == serial

    def test_a_fault_without_retry_fails_the_run_and_joins(self):
        before = _threads()
        plan = FaultInjector(FaultSpec("prefetch.worker", at_hit=2,
                                       exc=RuntimeError))
        with pytest.raises(RuntimeError):
            _train(LocalOptimizer, {"workers": 2}, plan=plan)
        assert _threads() <= before


class _ShuffleLog(LocalDataSet):
    """A `LocalDataSet` that notes the stream position of each
    `shuffle()`."""

    def __init__(self, items):
        super().__init__(items)
        self.log = []

    def shuffle(self):
        self.log.append(self.position())
        super().shuffle()


def _replayed(items, log, n):
    """The first `n` items of a fresh `LocalDataSet(items)`'s training
    stream, serial, with each logged shuffle made where it was logged."""
    ds, log, out = LocalDataSet(items), list(log), []
    it = ds.data(train=True)
    while len(out) < n:
        while log and log[0] == ds.position():
            log.pop(0)
            ds.shuffle()
        out.append(next(it))
    assert not log  # every shuffle was replayed
    return out


@pytest.mark.parametrize("loop", [LocalOptimizer, DistriOptimizer])
def test_an_epoch_boundary_shuffle_loses_and_duplicates_nothing(loop):
    """20 batches of 8 over 64 samples cross two epoch-boundary shuffles
    under `set_prefetch(workers=3, depth=6)`. Where each lands in the
    source (a pass's end, or some items into the next pass) depends on
    the lookahead, so the batches need not be serial iteration's, and a
    pass that a shuffle re-indexes midway need not hold each sample once.
    What the pipeline does keep: the batches it delivers are, item for
    item, the source's stream with each shuffle where it landed."""
    rs = np.random.RandomState(0)
    samples = [Sample(np.concatenate([[k], rs.rand(3)]).astype(np.float32),
                      np.int64(rs.randint(1, 3))) for k in range(64)]
    delivered = []

    def note(batch):
        delivered.extend(int(k) for k in batch.get_input()[:, 0])
        return batch

    ds = _ShuffleLog(samples)
    def jitter(s):
        return Sample(_jitter(s.feature), s.label)

    chain = (FuncTransformer(jitter) >> SampleToMiniBatch(8)
             >> FuncTransformer(note))
    kw = {"device": "cpu"} if loop is LocalOptimizer else {"devices": ["cpu"]}
    before = _threads()
    opt = loop(_mlp(), ds.transform(chain), nn.ClassNLLCriterion(), **kw)
    opt.set_optim_method(SGD(learning_rate=0.1))
    opt.set_end_when(max_iteration(20)).set_prefetch(workers=3, depth=6)
    opt.optimize()
    assert _threads() <= before and opt._active_pipeline is None
    assert len(ds.log) == 2 and len(delivered) >= 160
    # `_jitter` doubles the features: the ids come back doubled
    want = [int(s.feature[0]) * 2
            for s in _replayed(samples, ds.log, len(delivered))]
    assert delivered == want
