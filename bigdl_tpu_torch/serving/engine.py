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

Telemetry and tracing (`telemetry=`, `tracer=`), as the reference's: a
request gets a `TraceContext` at admission (only when one of them is
attached, so an engine without them pays nothing), and one `trace` record
when it finishes, whether ok, timed out, failed or cancelled, with its
phase split (queue, batch form, dispatch, forward, fetch); with a tracer,
its spans lie on one of 16 request lanes, flow-linked to the batch's
"serve dispatch" span. `trace_sample=N` keeps every Nth completed
request's record and spans (each kept record has `sample_weight` N); a
request that did not complete always traces. A `serving_stats` record
every `emit_every` batches and a `serving_summary` on close. A failing
sink is logged and never stops serving. `replica_id` (a fleet's replica
identity) and each request's `session` ride on its `trace` record.

The circuit breaker (`breaker=`, the reference's): one
`resilience.CircuitBreaker` per (feature signature, bucket) batch domain,
built on first use and labelled `b{bucket}[shape:dtype|...]`. An OPEN
domain sheds its group at dispatch with `ServingUnavailableError` and no
forward (counted in `shed`); a batch admitted while HALF_OPEN is the
probe. A batch's outcome reaches its breaker only when its rows reach the
host (`_complete`), and a batch dispatched while the circuit was closed
carries `probe=False`, so with `inflight` 2 a batch that finishes after a
trip is not probe evidence. Transitions emit `circuit_open` /
`circuit_half_open` / `circuit_close` events; `health()` reports the open
domains. The `serve.forward` fault site fires inside the dispatch span
with `bucket`, `n` and `sig`.

Costs: `stats()` carries `flops_per_step` (the mean FLOPs of a dispatched
batch) and `mfu` (the lifetime FLOPs over the wall time since the engine
started, against the card's registry peak; None on the CPU). The port has
no compiler cost analysis: each (feature signature, bucket) forward is
counted once, on a meta-device copy of the served model, by the
predictor's `CompiledFunction` (`observability/compilation.py`: nothing
launches; each kernel wrapper adds its formula; a `compile` record goes
to the engine's stream under the label `serving.forward/<model>`).
`bytes_accessed` is always None: the count is of operations, not bytes,
and no executable reports its traffic.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
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
from bigdl_tpu_torch.observability import costs
from bigdl_tpu_torch.observability.spans import TraceContext
from bigdl_tpu_torch.optim.predictor import LocalPredictor, to_numpy_rows
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.resilience.breaker import (CLOSED, HALF_OPEN, OPEN,
                                                CircuitBreaker)
from bigdl_tpu_torch.serving.stats import WindowedHistogram

logger = logging.getLogger("bigdl_tpu_torch.serving")

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


class ServingUnavailableError(ServingError):
    """Fast-fail shed: this request's batch domain has its circuit breaker
    OPEN (too many consecutive batch failures), so it was refused without
    a forward. Retry after the breaker's reset timeout, or route
    elsewhere."""


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
    telemetry / tracer : an `observability.Telemetry` / `SpanTracer`, or
        None (see the module docstring).
    emit_every : a `serving_stats` record every this many batches.
    hist_window : observations kept by each latency histogram.
    trace_sample : trace every Nth completed request (1: all).
    breaker : a dict of `CircuitBreaker` keyword arguments
        (`failure_threshold`, `reset_timeout_s`, `probe_successes`,
        `clock`) arming one breaker per batch domain, or None (off).
    replica_id : the engine's identity in a fleet, written on every
        `trace` record, or None.
    """

    def __init__(self, max_batch_size: int = 32, queue_capacity: int = 256,
                 admission: str = "block", start: bool = True, *,
                 telemetry=None, tracer=None, emit_every: int = 50,
                 hist_window: int = 8192, trace_sample: int = 1,
                 breaker: Optional[Dict] = None,
                 replica_id: Optional[str] = None):
        if queue_capacity < 1:
            raise ValueError(
                f"queue_capacity must be >= 1, got {queue_capacity}")
        if admission not in ("block", "reject"):
            raise ValueError(
                f"admission must be 'block' or 'reject', got {admission!r}")
        if trace_sample < 1:
            raise ValueError(
                f"trace_sample must be >= 1, got {trace_sample}")
        self.buckets = default_buckets(max_batch_size)
        self.max_batch_size = self.buckets[-1]
        self.queue_capacity = queue_capacity
        self.admission = admission
        self.telemetry = telemetry
        self.tracer = tracer
        self.emit_every = max(1, int(emit_every))
        self.trace_sample = int(trace_sample)
        self._req_seq = itertools.count()

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
        self.queue_wait = WindowedHistogram(hist_window)   # seconds
        self.latency = WindowedHistogram(hist_window)      # seconds
        self.batch_sizes = WindowedHistogram(hist_window)  # per batch
        self._n = {"submitted": 0, "completed": 0, "failed": 0,
                   "timed_out": 0, "rejected": 0, "cancelled": 0,
                   "shed": 0, "batches": 0, "bucket_hits": 0, "rows": 0,
                   "padded_rows": 0}
        self._compiled = set()  # (shape, bucket) pairs seen or warmed
        self._breaker_cfg = dict(breaker) if breaker is not None else None
        self._breakers: Dict[tuple, CircuitBreaker] = {}  # under _slock
        self.replica_id = replica_id
        # the FLOPs of the dispatched batches (each forward's count from
        # its `CompiledFunction`'s `last_info`), under _slock
        self._flops_total = 0.0
        self._t0_mono = time.monotonic()
        # perf_counter twin of _t0_mono: a trace record's arrival offset
        self._t0_perf = time.perf_counter()

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
        self._emit_safe({"type": "serving_summary", **self.stats()})

    def _run(self):
        raise NotImplementedError

    def _fail_queued(self, exc: BaseException):
        raise NotImplementedError

    # ------------------------------------------------------------ telemetry
    def _new_context(self) -> Optional[TraceContext]:
        """A request's trace identity, minted at admission, only when a
        telemetry or a tracer is attached."""
        if self.telemetry is None and self.tracer is None:
            return None
        return TraceContext.new_trace()

    def _emit_safe(self, record: Dict):
        """Emit to the telemetry; a failing sink is logged, never raised
        into the dispatcher (an observability failure is not a serving
        failure)."""
        if self.telemetry is None:
            return
        try:
            self.telemetry.emit(record)
        except Exception:
            logger.exception("serving telemetry sink failed; record dropped")

    def _span(self, name: str, **args):
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, cat="serving", **args)

    def _traced(self, r, status: str) -> bool:
        """Whether request `r`'s trace is kept: every non-ok one, and
        every `trace_sample`th completed one."""
        return r.ctx is not None and (status != "ok"
                                      or r.seq % self.trace_sample == 0)

    def _emit_trace(self, r, kind: str, status: str, total_ms: float,
                    phases, fields: Dict, error: Optional[str]):
        """The `trace` record of request `r`: `phases` (name, start, end,
        record field) on the perf_counter clock give its critical path."""
        rec = {"type": "trace", "trace_id": r.ctx.trace_id, "kind": kind,
               "status": status, "latency_ms": round(total_ms, 3),
               "arrival_offset_ms":
                   round((r.t_submit - self._t0_perf) * 1e3, 3), **fields}
        if r.session is not None:
            rec["session_id"] = str(r.session)
        if self.replica_id is not None:
            rec["replica_id"] = self.replica_id
        if status == "ok" and self.trace_sample > 1:
            # this record stands for trace_sample completed requests
            rec["sample_weight"] = self.trace_sample
        path = []
        for name, a, b, field in phases:
            ms = (b - a) * 1e3
            path.append({"name": name, "ms": round(ms, 3),
                         "frac": round(ms / total_ms, 4)
                         if total_ms > 0 else None})
            rec[field] = round(ms, 3)
        rec["critical_path"] = path
        if error is not None:
            rec["error"] = error
        self._emit_safe(rec)

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

    # ------------------------------------------------------------ breaker
    @staticmethod
    def _bucket_label(sig, bucket: int) -> str:
        """A batch domain's label: the bucket and each feature's
        shape:dtype."""
        shapes = "|".join(
            "x".join(map(str, shape)) + f":{dtype}" for shape, dtype in sig)
        return f"b{bucket}[{shapes}]"

    def _breaker_for(self, sig, bucket: int) -> Optional[CircuitBreaker]:
        """The breaker guarding one (signature, bucket) batch domain, built
        on first use; None when breakers are off."""
        if self._breaker_cfg is None:
            return None
        key = (sig, bucket)
        with self._slock:
            br = self._breakers.get(key)
            if br is None:
                br = self._breakers[key] = CircuitBreaker(
                    name=self._bucket_label(sig, bucket),
                    on_transition=self._on_breaker_transition,
                    **self._breaker_cfg)
            return br

    def _on_breaker_transition(self, old: str, new: str,
                               br: CircuitBreaker):
        kind = {OPEN: "circuit_open", CLOSED: "circuit_close"}.get(
            new, "circuit_half_open")
        logger.warning("serving circuit %s: %s -> %s", br.name, old, new)
        self._emit_safe({"type": "event", "event": kind,
                         "bucket": br.name, "from": old, "to": new})

    def _admit_batch(self, sig, bucket: int, n: int):
        """The breaker check at dispatch: (breaker, probe, shed). `shed`
        means the domain is OPEN and the caller must refuse its group (the
        `shed` counter is already raised); `probe` is whether this batch
        was admitted HALF_OPEN (the dispatcher alone dispatches, so the
        state read after `allow()` is the one it admitted under)."""
        br = self._breaker_for(sig, bucket)
        if br is not None and not br.allow():
            with self._slock:  # count before resolving
                self._n["shed"] += n
            return br, False, True
        return br, br is not None and br.state == HALF_OPEN, False

    # ------------------------------------------------------------ costs
    def _add_flops(self, compiled):
        """Add the FLOPs of the forward `compiled` (a `CompiledFunction`)
        just ran on this thread (none when its count failed)."""
        info = compiled.last_info
        n = None if info is None else info.get("flops")
        if n:
            with self._slock:
                self._flops_total += n

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict:
        """Flat JSON-safe snapshot: counters, queue depth, bucket hit rate,
        pad fraction, ms-scaled p50/p95/p99 of queue wait and end-to-end
        latency, batch-size quantiles, and the costs (the module docstring
        says how `flops_per_step` and `mfu` are counted)."""
        with self._lock:
            depth = len(self._q)
        with self._slock:
            n = dict(self._n)
            flops_total = self._flops_total
        out = {"queue_depth": depth, **n}
        out["bucket_hit_rate"] = round(n["bucket_hits"] / n["batches"], 4) \
            if n["batches"] else None
        out["pad_fraction"] = round(n["padded_rows"] / n["rows"], 4) \
            if n["rows"] else None
        out["flops_per_step"] = round(flops_total / n["batches"], 1) \
            if n["batches"] and flops_total else None
        out["bytes_accessed"] = None
        m = costs.mfu(flops_total or None, time.monotonic() - self._t0_mono,
                      device_kind=self._device_kind())
        out["mfu"] = round(m, 6) if m is not None else None
        out.update(self.queue_wait.snapshot("queue_wait_ms", scale=1e3))
        out.update(self.latency.snapshot("latency_ms", scale=1e3))
        out.update(self.batch_sizes.snapshot("batch_size", digits=1))
        return out

    def _device_kind(self) -> str:
        """The registry key of the engine's device (`self.device`, which
        each subclass sets)."""
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return self.device.type

    def health(self) -> Dict:
        """The load balancer's probe: `status` "ok" (serving, every circuit
        closed), "degraded" (a batch domain's breaker is open or half open;
        the others still serve) or "closed"; `open_buckets`, the degraded
        domains' labels; `breakers`, each domain's
        `CircuitBreaker.snapshot()`; `queue_depth` / `queue_capacity`."""
        with self._lock:
            depth = len(self._q)
            closing = self._closing
        with self._slock:
            breakers = list(self._breakers.values())
        snaps = {br.name: br.snapshot() for br in breakers}
        open_buckets = sorted(name for name, s in snaps.items()
                              if s["state"] != CLOSED)
        status = "closed" if closing else \
            ("degraded" if open_buckets else "ok")
        return {"status": status, "open_buckets": open_buckets,
                "breakers": snaps, "queue_depth": depth,
                "queue_capacity": self.queue_capacity}


class _Request:
    __slots__ = ("features", "future", "t_submit", "deadline", "ctx", "seq",
                 "t_gather", "session", "deadline_budget_ms")

    def __init__(self, features: List[np.ndarray],
                 deadline: Optional[float],
                 ctx: Optional[TraceContext] = None, seq: int = 0,
                 session=None, deadline_budget_ms: Optional[float] = None):
        self.features = features
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        self.deadline = deadline  # absolute perf_counter seconds, or None
        self.ctx = ctx            # trace identity, carried across threads
        self.seq = seq
        self.t_gather: Optional[float] = None  # when its batch closed
        self.session = session    # echoed into the trace record
        self.deadline_budget_ms = deadline_budget_ms  # as given

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
    telemetry / tracer / emit_every / hist_window / trace_sample /
        breaker / replica_id : as `ServingEngine` (the module docstring
        says what they do).
    device : where the engine runs; the model must live there. Default
        CUDA (see `resolve_device`).
    queue_capacity / admission / start : as `ServingEngine`.
    """

    def __init__(self, model, max_batch_size: int = 32,
                 max_wait_ms: float = 2.0, queue_capacity: int = 256,
                 admission: str = "block",
                 buckets: Optional[Sequence[int]] = None,
                 inflight: int = 2, convert: bool = True,
                 telemetry=None, tracer=None, emit_every: int = 50,
                 hist_window: int = 8192, breaker: Optional[Dict] = None,
                 trace_sample: int = 1, replica_id: Optional[str] = None,
                 *, device=None, start: bool = True):
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
        # the forward's compile records go to this engine's stream under a
        # serving label: bucket warm-ups and new shapes show up there
        self._pred = LocalPredictor(
            model, batch_size=max_batch_size, convert=convert,
            instrument=True, telemetry=telemetry, device=device,
            label="serving.forward")
        super().__init__(max_batch_size=max_batch_size,
                         queue_capacity=queue_capacity, admission=admission,
                         start=False, telemetry=telemetry, tracer=tracer,
                         emit_every=emit_every, hist_window=hist_window,
                         trace_sample=trace_sample, breaker=breaker,
                         replica_id=replica_id)
        if buckets is not None:
            self.buckets = buckets
        self.model = self._pred.model  # the converted serving copy
        self.device = self._pred.device
        self.max_wait_s = max_wait_ms / 1e3
        self.inflight = inflight
        if start:
            self.start()

    # ------------------------------------------------------------ admission
    def submit(self, sample, deadline_ms: Optional[float] = None,
               session=None) -> Future:
        """Enqueue one request; returns a `concurrent.futures.Future` that
        resolves to the per-sample output row (a numpy array) or raises
        `ServingTimeoutError` / `ServingError`. `sample` is a `Sample` or
        a feature array. `deadline_ms` bounds the request's whole queued
        life: admission (block mode) and batching both observe it.
        `session` is the caller's identity, echoed on the request's trace
        record as `session_id` (affinity is the fleet router's job)."""
        deadline = time.perf_counter() + deadline_ms / 1e3 \
            if deadline_ms is not None else None
        req = _Request(_features(sample), deadline, self._new_context(),
                       next(self._req_seq), session, deadline_ms)
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
        request pays no kernel build or library initialisation; each
        bucket's FLOPs are counted here too, off the serving path. Returns
        `compile_count()`."""
        feats = _features(sample)
        for b in self.buckets:
            cols = [np.stack([f] * b) for f in feats]
            y = self._forward_arrays(cols)
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
                self._finish_trace([r], None, now, status="timeout")
            else:
                r.t_gather = now
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
        """One forward of the stacked feature columns: the 1-based `Table`
        of them when there is more than one, as the reference's engine
        gives a multi-feature model. The predictor's `CompiledFunction`
        counts each (signature, bucket) forward once, on the meta
        device."""
        pred = self._pred
        return pred._forward(
            pred._to_device(arrs[0] if len(arrs) == 1 else arrs))

    def _dispatch(self, reqs: List[_Request]):
        """Pad a group with its last row up to its bucket and launch one
        forward (asynchronous on the card). A failure resolves only this
        group's futures; with breakers armed, an OPEN domain sheds its
        group with `ServingUnavailableError` and no forward."""
        n = len(reqs)
        bucket = self._bucket_for(n)
        sig = reqs[0].signature()
        br, probe, shed = self._admit_batch(sig, bucket, n)
        if shed:
            for r in reqs:
                _resolve(r.future, exc=ServingUnavailableError(
                    f"circuit open for batch domain {br.name}; request "
                    "shed without a forward"))
            self._finish_trace(reqs, {"bucket": bucket},
                               time.perf_counter(), status="shed")
            return None
        meta = {"bucket": bucket, "n": n, "t_d0": time.perf_counter(),
                "disp_tid": threading.get_ident() % 2 ** 31}
        try:
            with self._span("serve dispatch", n=n, bucket=bucket):
                # no-op unless a FaultInjector is installed; a plan targets
                # one domain through the bucket and sig of its context
                faults.fire("serve.forward", bucket=bucket, n=n, sig=sig)
                cols = [np.stack(c)
                        for c in zip(*(r.features for r in reqs))]
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
            if br is not None:
                br.record_failure(probe=probe)
            for r in reqs:
                _resolve(r.future, exc=ServingError(
                    f"batch forward failed: {e!r}"))
            self._finish_trace(reqs, meta, time.perf_counter(),
                               status="error", error=repr(e))
            return None
        meta["t_d1"] = time.perf_counter()
        self.batch_sizes.record(n)
        with self._slock:
            hit = (sig, bucket) in self._compiled
            self._compiled.add((sig, bucket))
            self._n["batches"] += 1
            self._n["bucket_hits"] += int(hit)
            self._n["rows"] += bucket
            self._n["padded_rows"] += bucket - n
        self._add_flops(self._pred._jitted)
        return reqs, y, br, probe, meta

    def _complete(self, batch):
        """Blocking device-to-host fetch of the oldest in-flight batch;
        newer batches keep the device busy meanwhile. The batch's breaker
        learns its outcome here: a batch succeeds only once its rows reach
        the host."""
        reqs, y, br, probe, meta = batch
        meta["t_f0"] = time.perf_counter()
        try:
            with self._span("serve fetch", n=len(reqs)):
                arr = to_numpy_rows(y)
        except Exception as e:
            with self._slock:  # count before resolving
                self._n["failed"] += len(reqs)
            if br is not None:
                br.record_failure(probe=probe)
            for r in reqs:
                _resolve(r.future, exc=ServingError(
                    f"batch fetch failed: {e!r}"))
            self._finish_trace(reqs, meta, time.perf_counter(),
                               status="error", error=repr(e))
            return
        if br is not None:
            br.record_success(probe=probe)
        now = time.perf_counter()
        with self._slock:
            self._n["completed"] += len(reqs)
            batches = self._n["batches"]
        for i, r in enumerate(reqs):
            self.latency.record(now - r.t_submit)
            _resolve(r.future, value=arr[i])
        self._finish_trace(reqs, meta, now, status="ok")
        if batches % self.emit_every == 0:
            self._emit_safe({"type": "serving_stats", **self.stats()})

    # ------------------------------------------------------------ tracing
    def _finish_trace(self, reqs: List[_Request], meta: Optional[Dict],
                      t_done: float, status: str,
                      error: Optional[str] = None):
        """Close each request's trace: its phase split (queue, batch form,
        dispatch, forward, fetch) from its timestamps, one `trace` record
        each, and with a tracer its spans on a request lane, flow-linked
        to the batch's dispatch span. Never raises: tracing must not take
        the dispatcher down."""
        if self.telemetry is None and self.tracer is None:
            return
        try:
            self._finish_trace_impl(reqs, meta or {}, t_done, status,
                                    error)
        except Exception:
            logger.exception("request trace emission failed; dropped")

    def _finish_trace_impl(self, reqs, meta, t_done, status, error):
        t_d0, t_d1, t_f0 = meta.get("t_d0"), meta.get("t_d1"), \
            meta.get("t_f0")
        bucket = meta.get("bucket")
        tracer = self.tracer
        # the engine times phases on perf_counter, the tracer on its own
        # epoch-anchored clock: one offset for the whole batch
        off = tracer.now_us() - time.perf_counter() * 1e6 \
            if tracer is not None else 0.0

        def us(t):
            return t * 1e6 + off

        for r in reqs:
            if not self._traced(r, status):
                continue  # sampled out: neither record nor spans
            phases = [("queue", r.t_submit,
                       r.t_gather if r.t_gather is not None else t_done,
                       "queue_wait_ms")]
            if r.t_gather is not None and t_d0 is not None:
                phases.append(("batch form", r.t_gather, t_d0,
                               "batch_form_ms"))
            if t_d0 is not None and t_d1 is not None:
                phases.append(("dispatch", t_d0, t_d1, "dispatch_ms"))
                if t_f0 is not None:
                    phases.append(("forward", t_d1, t_f0, "forward_ms"))
                    phases.append(("fetch", t_f0, t_done, "fetch_ms"))
                else:
                    phases.append(("forward", t_d1, t_done, "forward_ms"))
            if tracer is not None:
                # 16 request lanes; the trace_id keeps identity exact
                tid = tracer.lane(f"request-{r.seq % 16}")
                tracer.add_span("request", us(r.t_submit),
                                (t_done - r.t_submit) * 1e6,
                                cat="serving", tid=tid, ctx=r.ctx,
                                status=status, bucket=bucket)
                for name, a, b, _ in phases:
                    tracer.add_span(name, us(a), (b - a) * 1e6,
                                    cat="serving", tid=tid,
                                    ctx=r.ctx.child())
                if r.t_gather is not None and t_d0 is not None:
                    # this request's lane -> the batch's dispatch span
                    tracer.add_flow(r.seq, "batched", us(r.t_gather),
                                    tid, us(t_d0), meta["disp_tid"])
            if self.telemetry is None:
                continue
            fields = {}
            if r.deadline_budget_ms is not None:
                fields["deadline_budget_ms"] = round(r.deadline_budget_ms, 3)
            if r.features:
                fields["shape"] = [int(d) for d in
                                   np.asarray(r.features[0]).shape]
            if bucket is not None:
                fields["bucket"] = int(bucket)
            if meta.get("n") is not None:
                fields["batch"] = int(meta["n"])
            self._emit_trace(r, "serving_request", status,
                             (t_done - r.t_submit) * 1e3, phases, fields,
                             error)

    def _fail_queued(self, exc: BaseException):
        with self._lock:
            left = list(self._q)
            self._q.clear()
            self._not_full.notify_all()
        with self._slock:
            self._n["cancelled"] += len(left)
        for r in left:
            _resolve(r.future, exc=exc)
        if left:
            # a shutdown that failed queued work traces it
            self._finish_trace(left, None, time.perf_counter(),
                               status="cancelled", error=repr(exc))
