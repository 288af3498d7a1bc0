"""The serving engine's shared machinery (counterpart of the parts of
`bigdl_tpu/serving/engine.py` that `GenerationEngine` inherits).

`ServingEngine` owns the bounded request queue with block-with-deadline
or reject-on-full admission, the non-daemon dispatcher thread with
`start` / `close(drain)` / context-manager lifetime, power-of-two batch
buckets, and the `stats()` snapshot. A subclass supplies the dispatcher
loop (`_run`). Not ported yet: the one-shot forward engine
(`InferenceEngine` in the JAX package), the per-bucket circuit breaker
(and its `ServingUnavailableError`), telemetry, tracing and fault sites.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional

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
