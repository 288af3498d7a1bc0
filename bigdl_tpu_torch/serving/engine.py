"""Dynamic micro-batching serving (counterpart of
`bigdl_tpu/serving/engine.py`).

`ServingEngine` owns the bounded request queue with block-with-deadline
or reject-on-full admission, the non-daemon dispatcher thread with
`start` / `close(drain)` / context-manager lifetime, power-of-two batch
buckets, and the `stats()` snapshot. A subclass supplies the dispatcher
loop (`_run`): `GenerationEngine` (`serving/generation.py`) and the
one-shot forward engine `InferenceEngine` here.

`InferenceEngine`: concurrent clients `submit()` samples and get futures
back; the dispatcher thread gathers the queue into micro-batches under a
`(max_batch_size, max_wait_ms)` policy, drops requests whose deadline
lapsed, groups them by feature signature, pads each group with its last
row up to a bucket, runs one forward of a `LocalPredictor` (the converted
serving copy of the model), and keeps up to `inflight` batches dispatched
ahead of the blocking device-to-host fetch.

Not ported yet: the per-bucket circuit breaker (`breaker`,
`ServingUnavailableError`, `health()`), telemetry and the span tracer,
per-request trace records, the fault sites, `session` / `replica_id`, and
the MFU / FLOPs stats.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.optim.predictor import LocalPredictor, to_numpy_rows
from bigdl_tpu_torch.serving.stats import WindowedHistogram

# Engines still open at interpreter exit get a drain-less close, so their
# non-daemon dispatcher cannot hang shutdown. A regular atexit hook runs
# only after threading._shutdown has joined non-daemon threads (too late),
# so use threading._register_atexit, as concurrent.futures does.
_LIVE_ENGINES: "weakref.WeakSet" = weakref.WeakSet()


def _close_live_engines():
    for eng in list(_LIVE_ENGINES):
        try:
            eng.close(drain=False)
        except Exception:  # exit path: one engine must not block the rest
            pass


threading._register_atexit(_close_live_engines)


class ServingError(RuntimeError):
    """Base class for engine-side request failures."""


class QueueFullError(ServingError):
    """Raised at admission under `admission="reject"` when the queue is at
    capacity: the fail-fast backpressure signal for an upstream shedder."""


class ServingTimeoutError(ServingError, TimeoutError):
    """A request's deadline lapsed before it was served (or before it was
    admitted, under blocking admission)."""


class EngineClosedError(ServingError):
    """The engine is shut down (or shutting down) and not accepting work."""


def default_buckets(max_batch_size: int) -> List[int]:
    """Powers of two from 2 up to `max_batch_size` (which always caps the
    list): 32 -> [2, 4, 8, 16, 32], 24 -> [2, 4, 8, 16, 24], 1 -> [1]."""
    if max_batch_size < 1:
        raise ValueError(f"max_batch_size must be >= 1, got {max_batch_size}")
    if max_batch_size == 1:
        return [1]
    out, b = [], 2
    while b < max_batch_size:
        out.append(b)
        b *= 2
    out.append(max_batch_size)
    return out


class ServingEngine:
    """Queue, admission and lifetime shared by the serving engines.

    max_batch_size : largest batch; batches pad up to the next of
        `default_buckets(max_batch_size)`.
    queue_capacity : bound on queued requests.
    admission : "block" parks the caller until space (or the request's
        deadline); "reject" raises `QueueFullError` at once.
    start : spawn the dispatcher now; `False` lets a caller stage a queue
        first and `start()` later.
    """

    #: observations kept by each latency histogram
    HIST_WINDOW = 8192

    def __init__(self, max_batch_size: int = 32, queue_capacity: int = 256,
                 admission: str = "block", start: bool = True):
        if queue_capacity < 1:
            raise ValueError(
                f"queue_capacity must be >= 1, got {queue_capacity}")
        if admission not in ("block", "reject"):
            raise ValueError(
                f"admission must be 'block' or 'reject', got {admission!r}")
        self.buckets = default_buckets(max_batch_size)
        self.max_batch_size = self.buckets[-1]
        self.queue_capacity = queue_capacity
        self.admission = admission

        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._q: deque = deque()
        self._closing = False    # no new admissions
        self._drain = True       # finish queued work on close?
        self._joined = False
        self._thread: Optional[threading.Thread] = None

        # stats have their own lock: stats() must not contend with admission
        self._slock = threading.Lock()
        self.queue_wait = WindowedHistogram(self.HIST_WINDOW)   # seconds
        self.latency = WindowedHistogram(self.HIST_WINDOW)      # seconds
        self.batch_sizes = WindowedHistogram(self.HIST_WINDOW)  # per batch
        self._n = {"submitted": 0, "completed": 0, "failed": 0,
                   "timed_out": 0, "rejected": 0, "cancelled": 0,
                   "batches": 0, "bucket_hits": 0, "rows": 0,
                   "padded_rows": 0}
        self._compiled = set()  # (shape, bucket) pairs seen or warmed
        self._t0_mono = time.monotonic()

        _LIVE_ENGINES.add(self)
        if start:
            self.start()

    # ------------------------------------------------------------ lifecycle
    def start(self):
        """Spawn the (non-daemon) dispatcher thread. Idempotent."""
        with self._lock:
            if self._closing:
                raise EngineClosedError("engine is closed")
            if self._thread is not None:
                return self
            t = self._thread = threading.Thread(
                target=self._run, name="bigdl-serving-dispatch",
                daemon=False)
        t.start()
        return self

    def close(self, drain: bool = True):
        """Stop admission, optionally finish queued work, join the
        dispatcher. `drain=True` serves every queued request before
        returning; `drain=False` fails them with `EngineClosedError`.
        Idempotent."""
        with self._lock:
            self._closing = True
            self._drain = drain
            self._not_empty.notify_all()
            self._not_full.notify_all()
            t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join()
        with self._lock:
            if self._joined:
                return
            self._joined = True
        _LIVE_ENGINES.discard(self)
        # leftover requests (never-started engine, or drain=False)
        self._fail_queued(EngineClosedError("engine closed"))

    def _run(self):
        raise NotImplementedError

    def _fail_queued(self, exc: BaseException):
        raise NotImplementedError

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # backstop; callers close() explicitly
        try:
            self.close(drain=False)
        except Exception:  # interpreter teardown: nothing left to report to
            pass

    # ------------------------------------------------------------ admission
    def _admit(self, req):
        """Bounded-queue admission (block-with-deadline or reject-on-full),
        closed-engine refusal and the submitted counter. `req` needs only a
        `deadline` attribute (absolute perf_counter seconds or None)."""
        deadline = req.deadline
        with self._lock:
            if self._closing:
                raise EngineClosedError("engine is closed")
            if len(self._q) >= self.queue_capacity:
                if self.admission == "reject":
                    with self._slock:
                        self._n["rejected"] += 1
                    raise QueueFullError(
                        f"serving queue at capacity ({self.queue_capacity})")
                while len(self._q) >= self.queue_capacity \
                        and not self._closing:
                    timeout = None
                    if deadline is not None:
                        timeout = deadline - time.perf_counter()
                        if timeout <= 0:
                            with self._slock:
                                self._n["timed_out"] += 1
                            raise ServingTimeoutError(
                                "deadline lapsed waiting for queue space")
                    self._not_full.wait(timeout)
                if self._closing:
                    raise EngineClosedError("engine is closed")
            self._q.append(req)
            with self._slock:
                self._n["submitted"] += 1
            self._not_empty.notify()

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict:
        """Flat JSON-safe snapshot: counters, queue depth, bucket hit rate,
        pad fraction, and ms-scaled p50/p95/p99 of queue wait and
        end-to-end latency, plus batch-size quantiles."""
        with self._lock:
            depth = len(self._q)
        with self._slock:
            n = dict(self._n)
        out = {"queue_depth": depth, **n}
        out["bucket_hit_rate"] = round(n["bucket_hits"] / n["batches"], 4) \
            if n["batches"] else None
        out["pad_fraction"] = round(n["padded_rows"] / n["rows"], 4) \
            if n["rows"] else None
        out.update(self.queue_wait.snapshot("queue_wait_ms", scale=1e3))
        out.update(self.latency.snapshot("latency_ms", scale=1e3))
        out.update(self.batch_sizes.snapshot("batch_size", digits=1))
        return out


class _Request:
    __slots__ = ("features", "future", "t_submit", "deadline")

    def __init__(self, features: List[np.ndarray],
                 deadline: Optional[float]):
        self.features = features
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        self.deadline = deadline  # absolute perf_counter seconds, or None

    def signature(self):
        return _signature(self.features)


def _signature(features: List[np.ndarray]):
    """What must agree for requests to share a batch: each feature's shape
    and dtype."""
    return tuple((f.shape, str(f.dtype)) for f in features)


def _resolve(future: Future, value=None, exc: Optional[BaseException] = None):
    """Set a future's outcome, ignoring client-side cancellation races."""
    try:
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(value)
    except InvalidStateError:
        pass  # the client cancelled; the outcome is moot


def _features(sample) -> List[np.ndarray]:
    if isinstance(sample, Sample):
        return list(sample.features)
    return [np.asarray(sample)]


class InferenceEngine(ServingEngine):
    """In-process serving engine: futures in, micro-batched forwards out.

    Example (single-threaded; real clients submit concurrently):
        >>> import numpy as np
        >>> import bigdl_tpu_torch.nn as nn
        >>> from bigdl_tpu_torch.serving import InferenceEngine
        >>> m = (nn.Sequential().add(nn.Linear(4, 2, device="cpu"))
        ...      .add(nn.LogSoftMax()))
        >>> with InferenceEngine(m, max_batch_size=8, device="cpu") as eng:
        ...     eng.predict(np.ones(4, np.float32)).shape
        (2,)

    model : the trained module, served through a `LocalPredictor`: with
        `convert=True` (default) a converted copy (BN fold, noise elision,
        the space-to-depth stem), the caller's model untouched.
    max_batch_size : dispatch cap and largest default bucket.
    max_wait_ms : how long the dispatcher holds an underfull batch open for
        more arrivals (the latency / throughput knob).
    buckets : ascending pad targets; None = `default_buckets(...)`. The
        largest bucket is the dispatch cap.
    inflight : dispatched-but-unfetched batches kept in flight.
    device : where the engine runs; the model must live there. Default
        CUDA (see `resolve_device`).
    queue_capacity / admission / start : as `ServingEngine`.
    """

    def __init__(self, model, max_batch_size: int = 32,
                 max_wait_ms: float = 2.0, queue_capacity: int = 256,
                 admission: str = "block",
                 buckets: Optional[Sequence[int]] = None,
                 inflight: int = 2, convert: bool = True, *, device=None,
                 start: bool = True):
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        if inflight < 1:
            raise ValueError(f"inflight must be >= 1, got {inflight}")
        if buckets is not None:
            buckets = sorted(int(b) for b in buckets)
            if not buckets or buckets[0] < 1:
                raise ValueError(f"buckets must be positive, got {buckets}")
            if len(set(buckets)) != len(buckets):
                raise ValueError(f"buckets must be distinct, got {buckets}")
            max_batch_size = buckets[-1]
        self._pred = LocalPredictor(model, batch_size=max_batch_size,
                                    convert=convert, device=device)
        super().__init__(max_batch_size=max_batch_size,
                         queue_capacity=queue_capacity, admission=admission,
                         start=False)
        if buckets is not None:
            self.buckets = buckets
        self.model = self._pred.model  # the converted serving copy
        self.device = self._pred.device
        self.max_wait_s = max_wait_ms / 1e3
        self.inflight = inflight
        if start:
            self.start()

    # ------------------------------------------------------------ admission
    def submit(self, sample, deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one request; returns a `concurrent.futures.Future` that
        resolves to the per-sample output row (a numpy array) or raises
        `ServingTimeoutError` / `ServingError`. `sample` is a `Sample` or
        a feature array. `deadline_ms` bounds the request's whole queued
        life: admission (block mode) and batching both observe it."""
        deadline = time.perf_counter() + deadline_ms / 1e3 \
            if deadline_ms is not None else None
        req = _Request(_features(sample), deadline)
        self._admit(req)
        return req.future

    def predict(self, sample, timeout: Optional[float] = None,
                deadline_ms: Optional[float] = None) -> np.ndarray:
        """Blocking `submit` + wait. `timeout` (seconds) bounds the
        client-side wait and raises `ServingTimeoutError` (after a
        best-effort cancel); `deadline_ms` is the engine-side deadline."""
        fut = self.submit(sample, deadline_ms=deadline_ms)
        try:
            return fut.result(timeout)
        except FuturesTimeoutError:
            fut.cancel()  # best effort: the outcome is moot now
            raise ServingTimeoutError(
                f"result not ready within {timeout}s") from None

    # ------------------------------------------------------------ warmup
    def warmup(self, sample) -> int:
        """Run the forward once at every bucket with `sample`'s features
        (replicated), blocking until each has finished, so that the first
        request pays no kernel build or library initialisation. Returns
        `compile_count()`."""
        feats = _features(sample)
        for b in self.buckets:
            y = self._forward_arrays([np.stack([f] * b) for f in feats])
            to_numpy_rows(y)  # blocks until the forward has run
            with self._slock:
                self._compiled.add((_signature(feats), b))
        return self.compile_count()

    def compile_count(self) -> int:
        """Distinct (feature signature, bucket) forwards run so far: the
        engine's own ledger (the reference's fallback; eager PyTorch has no
        compile cache to count)."""
        with self._slock:
            return len(self._compiled)

    # ------------------------------------------------------------ dispatcher
    def _run(self):
        pending: deque = deque()  # (reqs, device result) in flight
        with torch.inference_mode():  # grad mode is per thread
            try:
                while True:
                    if pending:
                        # an idle queue: fetch in-flight results instead of
                        # blocking for new work, or their clients would wait
                        # for the next arrival
                        with self._lock:
                            idle = not self._q and not self._closing
                        if idle:
                            self._complete(pending.popleft())
                            continue
                    reqs = self._gather()
                    if reqs is None:
                        break
                    for group in self._group(reqs):
                        batch = self._dispatch(group)
                        if batch is not None:
                            pending.append(batch)
                        while len(pending) > self.inflight:
                            self._complete(pending.popleft())
            finally:
                while pending:
                    self._complete(pending.popleft())

    def _gather(self) -> Optional[List[_Request]]:
        """Pop one micro-batch worth of requests: wait for the first, hold
        the window open `max_wait_ms` for more (a draining close skips the
        wait), then drop deadline-expired requests. None = shut down."""
        with self._lock:
            while not self._q and not self._closing:
                self._not_empty.wait()
            if not self._q:
                return None  # closing and nothing left
            if self._closing and not self._drain:
                return None  # the leftover queue is failed by close()
            reqs = [self._q.popleft()]
            window_end = time.perf_counter() + self.max_wait_s
            while len(reqs) < self.max_batch_size:
                while self._q and len(reqs) < self.max_batch_size:
                    reqs.append(self._q.popleft())
                if len(reqs) >= self.max_batch_size or self._closing:
                    break
                remaining = window_end - time.perf_counter()
                if remaining <= 0:
                    break
                self._not_empty.wait(remaining)
            self._not_full.notify_all()
        now = time.perf_counter()
        alive = []
        for r in reqs:
            if r.deadline is not None and now >= r.deadline:
                # count before resolving: a client that saw its future
                # settle must already see consistent stats()
                with self._slock:
                    self._n["timed_out"] += 1
                _resolve(r.future, exc=ServingTimeoutError(
                    "deadline lapsed in the serving queue "
                    f"({(now - r.t_submit) * 1e3:.1f} ms queued)"))
            else:
                self.queue_wait.record(now - r.t_submit)
                alive.append(r)
        return alive

    @staticmethod
    def _group(reqs: List[_Request]) -> List[List[_Request]]:
        """Split a gathered window by feature signature: each distinct
        shape/dtype set is its own batch and its own failure domain."""
        groups: Dict[tuple, List[_Request]] = {}
        for r in reqs:
            groups.setdefault(r.signature(), []).append(r)
        return list(groups.values())

    def _forward_arrays(self, arrs: List[np.ndarray]):
        x = [self._pred._to_device(a) for a in arrs]
        return self._pred._forward(x[0] if len(x) == 1 else x)

    def _dispatch(self, reqs: List[_Request]):
        """Pad a group with its last row up to its bucket and launch one
        forward (asynchronous on the card). A failure resolves only this
        group's futures."""
        n = len(reqs)
        bucket = self._bucket_for(n)
        sig = reqs[0].signature()
        try:
            cols = [np.stack(c) for c in zip(*(r.features for r in reqs))]
            if bucket > n:
                # the last row, not zeros: always in the model's domain
                cols = [np.concatenate(
                    [a, np.repeat(a[-1:], bucket - n, axis=0)])
                    for a in cols]
            y = self._forward_arrays(cols)
        except Exception as e:
            with self._slock:  # count before resolving
                self._n["failed"] += n
                self._n["batches"] += 1
            for r in reqs:
                _resolve(r.future, exc=ServingError(
                    f"batch forward failed: {e!r}"))
            return None
        self.batch_sizes.record(n)
        with self._slock:
            hit = (sig, bucket) in self._compiled
            self._compiled.add((sig, bucket))
            self._n["batches"] += 1
            self._n["bucket_hits"] += int(hit)
            self._n["rows"] += bucket
            self._n["padded_rows"] += bucket - n
        return reqs, y

    def _complete(self, batch):
        """Blocking device-to-host fetch of the oldest in-flight batch;
        newer batches keep the device busy meanwhile."""
        reqs, y = batch
        try:
            arr = to_numpy_rows(y)
        except Exception as e:
            with self._slock:  # count before resolving
                self._n["failed"] += len(reqs)
            for r in reqs:
                _resolve(r.future, exc=ServingError(
                    f"batch fetch failed: {e!r}"))
            return
        now = time.perf_counter()
        with self._slock:
            self._n["completed"] += len(reqs)
        for i, r in enumerate(reqs):
            self.latency.record(now - r.t_submit)
            _resolve(r.future, value=arr[i])

    def _fail_queued(self, exc: BaseException):
        with self._lock:
            left = list(self._q)
            self._q.clear()
            self._not_full.notify_all()
        with self._slock:
            self._n["cancelled"] += len(left)
        for r in left:
            _resolve(r.future, exc=exc)
