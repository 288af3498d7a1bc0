"""Pipelined host data plane: multi-worker prefetch into a bounded queue
(counterpart of `bigdl_tpu/dataset/prefetch.py`; pure Python threads, the
reference's code, plus an optional pinning stage for a card).

Parity: the original BigDL hides host-side input cost two ways — the data-fetch
Spark task runs CONCURRENTLY with the compute/sync jobs
(DistriOptimizer.scala:330-339, whitepaper "data loading"), and
`MTImageFeatureToBatch` builds batches with a thread pool. This module is
the port of both: background worker threads run the transformer chain
into a bounded queue so the loop's thread only ever pays a queue pop
before starting the next H2D transfer; any transformer chain slower than
one device step stops serializing the train loop. With `pin_memory` a
last stage copies each batch's arrays into pinned host tensors in its own
thread, so the loop's copy to the card can be `non_blocking=True`.

Two composable pieces:

- `ThreadedPrefetcher` — N worker threads pull `(seq, item)` tickets from a
  shared source under a lock, apply a per-item function in parallel, and
  deliver results through a bounded buffer. `deterministic=True` (default)
  reorders completions so the output order is byte-identical to serial
  iteration; `deterministic=False` yields in completion order (lower
  latency jitter, same multiset). Worker exceptions are captured and
  re-raised in the CONSUMER thread; `close()` is idempotent, joins every
  worker, and leaks no threads even after an exception.
- `InputPipeline` — the optimizer-facing assembly built by
  `build_input_pipeline`: it splits a dataset's transformer chain into the
  element-wise prefix (parallelized over `workers` threads) and the
  stateful remainder (batching — run in ONE ordered background stage), and
  exposes the health gauges (queue depth, fetch-wait, worker busy
  fraction) the observability telemetry exports per sync window.

Determinism contract: deterministic mode guarantees the output ORDER
equals serial iteration of the same stream. Transformers that draw from a
SHARED rng additionally see a different draw interleaving under
`workers > 1` (their per-item work races); chains like that get bitwise
identity only at `workers=1`, where the single background thread replays
the serial draw order exactly. Epoch-boundary `shuffle()` interleaving
likewise shifts with lookahead depth — the training loops prefetch
`depth` batches ahead instead of the serial loop's one.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Iterator, Optional

from bigdl_tpu_torch.resilience import faults

logger = logging.getLogger("bigdl_tpu_torch.dataset")


class ThreadedPrefetcher:
    """Run `fn` over `source` items in `workers` background threads,
    delivering results through a bounded buffer of `depth` items.

    `depth` bounds the TOTAL lookahead (buffered + in-processing), so a
    stalled consumer never accumulates unbounded host memory. With
    `fn=None` the workers are pure pullers — useful with `workers=1` to
    run an entire (stateful) iterator chain concurrently with the
    consumer. Iterate it like any iterator; `close()` when done (the
    training loops call it from a finally block). Worker threads are
    NON-daemon: a missed close() is a visible leak, not a silent one.
    """

    def __init__(self, source: Iterator, fn: Optional[Callable] = None,
                 depth: int = 2, workers: int = 1,
                 deterministic: bool = True, name: str = "prefetch",
                 retry_policy=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self._source = iter(source)
        self._fn = fn
        # bounded in-worker retry of TRANSIENT per-item failures (flaky
        # remote reads in a decode stage): the item keeps its seq ticket,
        # so a retried item lands in the same output position and the
        # deterministic-mode ordering contract is unchanged. Permanent
        # failures (and exhausted retries) still propagate to the
        # consumer. Only the per-item fn retries — a raw `next()` on the
        # source cannot re-run once its iterator has raised.
        self._retry = retry_policy
        self._depth = depth
        # wake workers once `hyst` slots are free (burst refill); the
        # remaining depth - hyst buffered items cover the refill latency,
        # which on a busy training loop is GIL-bounded, not fn-bounded
        self._hyst = max(1, depth // 4)
        self._deterministic = deterministic
        # one state lock, two wait-sets: workers block on _can_pull
        # (capacity), the single consumer blocks on _ready — split so a
        # consumer pop wakes exactly ONE worker instead of the whole pool
        # (the notify_all convoy cost ~0.5 ms/pop on a small host, which
        # is the entire overhead budget of the zero-cost A/B)
        self._lock = threading.Lock()
        self._can_pull = threading.Condition(self._lock)
        self._ready = threading.Condition(self._lock)
        self._src_lock = threading.Lock()
        self._buffer = {}          # seq -> result (deque semantics when
        self._next_put = 0         # best-effort: consumed in seq-key order
        self._next_get = 0         # of COMPLETION, tracked via _done_order)
        self._done_order = []      # completion order (best-effort mode)
        self._pulled = 0           # tickets issued
        self._reserved = 0         # capacity reservations (>= pulled)
        self._consumed = 0
        self._exhausted = False
        self._stopped = False
        self._error: Optional[BaseException] = None
        self._busy_s = 0.0
        self._wait_s = 0.0
        self._workers_n = workers
        self._t0 = time.perf_counter()
        self._threads = [
            threading.Thread(target=self._work, name=f"bigdl-{name}-{i}",
                             daemon=False)
            for i in range(workers)]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------ workers
    def _wake_all(self):
        """Wake every waiter (state change that ends waits). Callers hold
        self._lock."""
        self._can_pull.notify_all()
        self._ready.notify_all()

    def _work(self):
        try:
            while True:
                # reserve a capacity slot FIRST, under the state lock only
                # — a worker must never wait for capacity while holding
                # src_lock, or a loop-side source_guard() (epoch-boundary
                # shuffle) deadlocks against a full pipeline. The
                # reservation keeps the depth bound strict without holding
                # src_lock through the wait.
                with self._lock:
                    while (not self._stopped and self._error is None
                           and not self._exhausted
                           and self._reserved - self._consumed
                           >= self._depth):
                        self._can_pull.wait()
                    if self._stopped or self._error is not None \
                            or self._exhausted:
                        return
                    self._reserved += 1
                # ticket pull: seq number and raw item come out of the
                # source atomically (src_lock), so deterministic reorder
                # is exact; src_lock is held only for the pull itself
                with self._src_lock:
                    with self._lock:
                        if self._stopped or self._exhausted:
                            self._reserved -= 1
                            self._can_pull.notify()
                            return
                    t0 = time.perf_counter()
                    try:
                        item = next(self._source)
                    except StopIteration:
                        with self._lock:
                            self._reserved -= 1
                            self._exhausted = True
                            self._wake_all()
                        return
                    # pull time is real work in full-chain mode (the
                    # transformer chain runs inside next()); in ticketed
                    # multi-worker mode it is a cheap raw-item read
                    dt = time.perf_counter() - t0
                    with self._lock:
                        seq = self._next_put
                        self._next_put += 1
                        self._pulled += 1
                t0 = time.perf_counter()
                if self._fn is not None:
                    def apply(item=item, seq=seq):
                        # chaos site: no-op unless a FaultInjector is
                        # installed; inside the retried callable so an
                        # injected transient flake exercises the retry.
                        # A StopIteration from fn is converted to a
                        # SENTINEL here, not an exception: it is a
                        # deterministic logic error that must bypass the
                        # retry (re-running it replays identically) AND
                        # must not reach the policy as a StopIteration
                        # (an unknown exception type it would retry).
                        faults.fire("prefetch.worker", seq=seq)
                        try:
                            return True, self._fn(item)
                        except StopIteration as e:
                            return False, e
                    ok, item = apply() if self._retry is None \
                        else self._retry.call(apply)
                    if not ok:
                        # PEP-479 analogue: a StopIteration escaping the
                        # per-item fn would read as clean stream
                        # exhaustion in the consumer — surface it as a
                        # hard error (e.g. an elementwise-marked stage
                        # that yielded nothing for an item) instead of
                        # silent truncation
                        raise RuntimeError(
                            "prefetch fn raised StopIteration — an "
                            "elementwise transformer produced no "
                            "output for an item") from item
                dt += time.perf_counter() - t0
                with self._lock:
                    self._busy_s += dt
                    self._buffer[seq] = item
                    if not self._deterministic:
                        self._done_order.append(seq)
                    self._ready.notify()
        except BaseException as e:  # propagate to the consumer, never drop
            with self._lock:
                if self._error is None:
                    self._error = e
                self._wake_all()

    # ----------------------------------------------------------- consumer
    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        try:
            with self._lock:
                while True:
                    if self._deterministic:
                        ready = self._next_get in self._buffer
                        seq = self._next_get
                    else:
                        ready = bool(self._done_order)
                        seq = self._done_order[0] if ready else -1
                    if ready:
                        item = self._buffer.pop(seq)
                        if not self._deterministic:
                            self._done_order.pop(0)
                        self._next_get += 1
                        self._consumed += 1
                        # hysteresis: let `_hyst` (depth//4) slots free up
                        # before waking workers, so refills happen in
                        # amortized bursts instead of one thread wake per
                        # pop (per-pop wake cost is the entire overhead
                        # budget when the transform chain is cheap)
                        if (self._reserved - self._consumed
                                <= self._depth - self._hyst):
                            self._can_pull.notify(self._hyst)
                        return item
                    if self._error is not None:
                        err, self._error = self._error, None
                        self._stopped = True
                        self._wake_all()
                        raise err
                    if self._exhausted and self._consumed >= self._pulled:
                        raise StopIteration
                    if self._stopped:
                        raise StopIteration
                    self._ready.wait()
        finally:
            self._wait_s += time.perf_counter() - t0

    # ------------------------------------------------------------- control
    def close(self):
        """Stop the workers and join them. Idempotent; safe after an
        exception. A worker mid-transform finishes its current item (the
        per-item fn is finite work) and exits at the next check."""
        with self._lock:
            self._stopped = True
            self._wake_all()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join()
        self._threads = []

    def __del__(self):  # backstop; the loops close() in a finally
        try:
            self.close()
        except Exception:
            pass

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            queue_depth = len(self._buffer)
            busy = self._busy_s
            wait = self._wait_s
        elapsed = max(time.perf_counter() - self._t0, 1e-9)
        return {
            "queue_depth": queue_depth,
            "fetch_wait_s": wait,
            # busy fraction of the CONSTRUCTED pool since construction —
            # dividing by currently-alive threads would inflate the gauge
            # up to N-fold once workers exit on source exhaustion
            "worker_busy": busy / (self._workers_n * elapsed),
        }


def _flatten_chain(transformer):
    """Flatten a `>>`-composed transformer into its stage list."""
    from bigdl_tpu_torch.dataset.transformer import _Chained
    if isinstance(transformer, _Chained):
        return _flatten_chain(transformer.first) + \
            _flatten_chain(transformer.second)
    return [transformer]


def split_elementwise_prefix(transformer):
    """Split a transformer chain into (elementwise prefix, remainder).

    The prefix — the longest run of stages marked `elementwise = True`
    (1-in/1-out, e.g. decode/normalize/crop/augment) — is safe to apply
    per-item across worker threads; the remainder (stateful batching like
    `SampleToMiniBatch`) must run as one ordered stream. Either side is
    None when empty."""
    from bigdl_tpu_torch.dataset.transformer import chain
    stages = _flatten_chain(transformer)
    split = 0
    while split < len(stages) and getattr(stages[split], "elementwise",
                                          False):
        split += 1
    prefix = chain(*stages[:split]) if split else None
    rest = chain(*stages[split:]) if split < len(stages) else None
    return prefix, rest


class InputPipeline:
    """Optimizer-facing prefetching stream over a dataset.

    Built by `build_input_pipeline`; iterates MiniBatches. Owns one or two
    `ThreadedPrefetcher` stages and aggregates their health gauges for the
    telemetry step record (docs/observability.md "input pipeline")."""

    def __init__(self, stages):
        self._stages = list(stages)
        self._out = self._stages[-1]

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._out)

    def close(self):
        # close the OUTPUT stage first: its (single) worker consumes the
        # upstream stage, and joining upstream workers while the output
        # thread still pulls from them could wait a full item longer
        for stage in reversed(self._stages):
            stage.close()

    def source_guard(self):
        """Lock that makes a dataset mutation (epoch-boundary
        `shuffle()`) atomic against worker pulls: the first stage's
        source lock — every raw-item read happens under it. The training
        loops take this around `dataset.shuffle()` so a worker is never
        mid-pull while the item list reorders; WHICH pull the shuffle
        lands between still depends on lookahead depth (see the module
        docstring's determinism contract)."""
        return self._stages[0]._src_lock

    def health(self) -> dict:
        """Flat telemetry gauges, prefixed for the step record. Fetch-wait
        is CUMULATIVE consumer-blocked seconds (the last stage's — what
        the train loop actually waited); queue depth is the instantaneous
        ready-batch count; worker busy is the parallel stage's pool busy
        fraction since the run started."""
        last = self._out.stats()
        first = self._stages[0].stats()
        return {
            "prefetch_queue_depth": last["queue_depth"],
            "prefetch_fetch_wait_s": round(last["fetch_wait_s"], 6),
            "prefetch_worker_busy": round(first["worker_busy"], 4),
        }


def _pin_array(a):
    """A numeric host array as a pinned torch tensor; a tensor already
    pinned, or a string or bytes column, as it is."""
    import numpy as np
    import torch
    if isinstance(a, np.ndarray):
        if a.dtype.kind in "USO":
            return a
        a = torch.from_numpy(np.ascontiguousarray(a))
    if isinstance(a, torch.Tensor) and a.device.type == "cpu" \
            and not a.is_pinned():
        return a.pin_memory()
    return a


def pin_batch(batch):
    """A `MiniBatch` whose numeric arrays are pinned host tensors (the
    same values), for a `non_blocking` copy to the card."""
    from bigdl_tpu_torch.dataset.sample import MiniBatch
    out = MiniBatch.__new__(MiniBatch)
    out.inputs = [_pin_array(a) for a in batch.inputs]
    out.targets = [_pin_array(a) for a in batch.targets]
    return out


def build_input_pipeline(dataset, train: bool = True, depth: int = 2,
                         workers: Optional[int] = None,
                         deterministic: bool = True,
                         retry_policy=None, *,
                         pin_memory: bool = False) -> InputPipeline:
    """Build the prefetching input pipeline for a dataset.

    `workers=None` takes `Engine.io_threads` (the reference's data-plane
    thread-pool knob, Engine.scala thread pools / MTImageFeatureToBatch).
    When the dataset's transformer chain has an element-wise prefix, that
    prefix fans out over `workers` threads (ticketed pulls keep
    deterministic order exact); the stateful remainder (batching) runs in
    one ordered background stage. Chains with no parallel-safe prefix fall
    back to a single background puller — the whole chain still overlaps
    the consumer, which is the first-order win.

    `retry_policy` (a `resilience.RetryPolicy`) arms bounded in-worker
    retry of transient per-item failures in the parallel stage — one
    flaky remote read no longer kills the whole training run, and the
    deterministic-mode ordering contract is preserved (the retried item
    keeps its sequence ticket).

    `pin_memory` (the loops set it on a card) adds a last ordered stage
    that pins each batch (`pin_batch`) in its own thread."""
    pipeline = _build_input_pipeline(dataset, train, depth, workers,
                                     deterministic, retry_policy)
    if pin_memory:
        # a pure puller (no per-item fn): the `prefetch.worker` fault
        # site stays the element-wise stage's alone
        pipeline._stages.append(ThreadedPrefetcher(
            (pin_batch(b) for b in pipeline._out), depth=depth, workers=1,
            name="prefetch-pin"))
        pipeline._out = pipeline._stages[-1]
    return pipeline


def _build_input_pipeline(dataset, train, depth, workers, deterministic,
                          retry_policy) -> InputPipeline:
    from bigdl_tpu_torch.dataset.dataset import _TransformedDataSet
    if workers is None:
        from bigdl_tpu_torch.utils.engine import Engine
        workers = int(Engine.config["io_threads"])
    if workers < 1:
        raise ValueError(f"workers must be >= 1, got {workers}")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")

    # unwrap nested transforms into (base dataset, flat stage list)
    base, stages = dataset, []
    while isinstance(base, _TransformedDataSet):
        stages = _flatten_chain(base.transformer) + stages
        base = base.base

    if workers > 1 and stages:
        from bigdl_tpu_torch.dataset.transformer import chain
        prefix, rest = split_elementwise_prefix(chain(*stages))
        if prefix is not None:
            par = ThreadedPrefetcher(
                base.data(train), fn=prefix.apply_one, depth=depth,
                workers=workers, deterministic=deterministic,
                name="prefetch-map", retry_policy=retry_policy)
            if rest is None:
                return InputPipeline([par])
            # ordered tail stage: batching consumes the (reordered)
            # parallel stream off the loop's thread
            tail = ThreadedPrefetcher(rest(iter(par)), depth=depth,
                                      workers=1, name="prefetch-batch")
            return InputPipeline([par, tail])
        logger.warning(
            "prefetch: transformer chain has no element-wise prefix; "
            "falling back to a single background pipeline thread")
    # single puller over the full chain (or an untransformed dataset).
    # No per-item fn runs here, so there is nothing the retry policy can
    # safely re-run (a source iterator that raised cannot be re-pulled)
    # — say so instead of silently ignoring the knob.
    if retry_policy is not None:
        logger.warning(
            "prefetch: retry_policy is ignored on the single-puller "
            "fallback path — only the per-item element-wise stage can "
            "retry (workers > 1 with an element-wise chain prefix)")
    return InputPipeline([ThreadedPrefetcher(
        dataset.data(train), depth=depth, workers=1, name="prefetch")])
