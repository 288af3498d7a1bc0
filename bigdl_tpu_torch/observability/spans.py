"""Nested host-side trace spans, exportable as Chrome/Perfetto trace JSON
(counterpart of `bigdl_tpu/observability/spans.py`).

The device trace (`torch.profiler`) shows kernels, not the framework's
phases: "data fetch", "step dispatch", "loss sync", "checkpoint" are host
concepts. A `SpanTracer` records them with wall-clock timestamps and
exports the Chrome trace-event format, which Perfetto loads directly.
With `annotate=True` each span is also a `torch.profiler.record_function`
of the same name, so when the profiler is tracing (`tools/bench.py
--profile`) the phases appear in its trace too, one naming scheme across
both views.

Request-scoped tracing: a `TraceContext` gives a span its distributed
identity (trace_id / span_id / parent_id). Open one with
`tracer.trace(...)` (a root) or pass `ctx=`; spans opened inside an active
context become its children (thread-local propagation), and the ids land
in the exported event's `args`. A request handed from the submitting
thread to a dispatcher carries its context on the request object, and
`add_flow` links the two lanes with Chrome flow events.

Process lanes: every `SpanTracer` gets a Perfetto pid from its
`process_name` (same name, same lane), so several tracers merge into one
loadable trace with `merge_traces` / `export_merged`.

Example:
    >>> from bigdl_tpu_torch.observability import SpanTracer
    >>> tr = SpanTracer(process_name="doc", annotate=False)
    >>> with tr.span("outer"):
    ...     with tr.span("inner"):
    ...         pass
    >>> [e["name"] for e in tr.events]
    ['inner', 'outer']
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

# ---------------------------------------------------------------- identity
_pid_lock = threading.Lock()
_pids: Dict[str, int] = {}


def _pid_for(process_name: str) -> int:
    """Stable Perfetto pid for a process lane name: the first registration
    takes the next pid, a later one with the same name gets the same."""
    with _pid_lock:
        pid = _pids.get(process_name)
        if pid is None:
            pid = len(_pids) + 1
            _pids[process_name] = pid
        return pid


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class TraceContext:
    """Distributed span identity: (trace_id, span_id, parent_id).

    One `trace_id` names a whole request or run; each span under it has
    its own `span_id` and points at its parent. `new_trace()` mints a
    root, `child()` the context of a sub-span. Immutable, so it can ride
    on a queued request across threads."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    @classmethod
    def new_trace(cls) -> "TraceContext":
        return cls(_new_id(8), _new_id(4), None)

    def child(self) -> "TraceContext":
        return TraceContext(self.trace_id, _new_id(4), self.span_id)

    def ids(self) -> Dict[str, str]:
        out = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id is not None:
            out["parent_id"] = self.parent_id
        return out

    def __repr__(self):
        return (f"TraceContext({self.trace_id}/{self.span_id}"
                f"<-{self.parent_id})")


class SpanTracer:
    """Records nested `with tracer.span(name): ...` phases.

    Spans are complete events ("ph": "X"): microsecond wall-clock
    timestamps (absolute epoch), per-thread track ids, and JSON-safe
    `args`. Thread-safe; each thread has its own context stack.

    `annotate=True` (default) also wraps every span in
    `torch.profiler.record_function(name)`, which costs little unless the
    profiler is tracing.

    `max_events` bounds host memory: once full, the oldest events are
    dropped and the drop count is reported in the exported process
    metadata (`dropped_events`)."""

    def __init__(self, process_name: str = "bigdl_tpu",
                 annotate: bool = True, max_events: int = 1_000_000):
        self.process_name = process_name
        self.pid = _pid_for(process_name)
        self.annotate = annotate
        self._events: deque = deque(maxlen=max_events)
        self.dropped_events = 0
        self._lock = threading.Lock()
        self._tls = threading.local()  # per-thread TraceContext stack
        self._lanes: Dict[int, str] = {}  # tid -> display name
        self._next_lane_tid = 1_000_000_000  # synthetic-lane tid range
        # monotonic offsets give the durations (a clock step mid-run never
        # makes a negative span); the wall base, sampled once, anchors
        # them to epoch time
        self._wall0_us = time.time() * 1e6
        self._mono0 = time.monotonic()

    def _now_us(self) -> float:
        return self._wall0_us + (time.monotonic() - self._mono0) * 1e6

    def now_us(self) -> float:
        """This tracer's current timestamp (epoch microseconds), for
        callers that build spans after the fact with `add_span`."""
        return self._now_us()

    # ------------------------------------------------------------ context
    def _ctx_stack(self) -> List[TraceContext]:
        stack = getattr(self._tls, "ctx", None)
        if stack is None:
            stack = self._tls.ctx = []
        return stack

    def current_context(self) -> Optional[TraceContext]:
        """The innermost active `TraceContext` on this thread, or None."""
        stack = self._ctx_stack()
        return stack[-1] if stack else None

    @contextlib.contextmanager
    def trace(self, name: str, cat: str = "host", **args):
        """Open a root trace: a fresh trace_id, `name` its root span;
        spans opened inside become its children. Yields the root
        `TraceContext`."""
        ctx = TraceContext.new_trace()
        with self.span(name, cat=cat, ctx=ctx, **args):
            yield ctx

    def begin_trace(self, name: str, cat: str = "host",
                    **args) -> TraceContext:
        """A root trace for a loop that cannot wrap its body in a `with`:
        pushes a fresh root context for this thread and returns it; the
        root span is recorded by `end_trace()`. A root a crashed run left
        open is dropped (the stack goes back to its base), but an
        enclosing user context (`with tracer.trace(...): opt.optimize()`)
        survives: the run joins it as a child."""
        stack = self._ctx_stack()
        frame = getattr(self._tls, "open_roots", None)
        if frame is None:
            frame = self._tls.open_roots = []
        if frame:  # a stale root of a failed run: unwind to its base
            _, _, _, _, _, base = frame[0]
            del frame[:]
            del stack[base:]
        ctx = stack[-1].child() if stack else TraceContext.new_trace()
        frame.append((ctx, name, cat, self._now_us(), args, len(stack)))
        stack.append(ctx)
        return ctx

    def end_trace(self):
        """Record the span `begin_trace` opened and pop the stack back to
        the depth it found. A no-op when no root is open."""
        frame = getattr(self._tls, "open_roots", None)
        if not frame:
            return
        ctx, name, cat, t0, args, base = frame.pop()
        stack = self._ctx_stack()
        del stack[base:]
        self.add_span(name, t0, self._now_us() - t0, cat=cat, ctx=ctx,
                      **args)

    # ------------------------------------------------------------ recording
    @contextlib.contextmanager
    def span(self, name: str, cat: str = "host",
             ctx: Optional[TraceContext] = None, **args):
        """Time a nested phase. `args` (JSON-serializable) land in the
        event's `args`. `ctx` pins the span's identity; without it, an
        active context on this thread makes the span its child, and with
        none the span has no identity."""
        ann = None
        if self.annotate:
            try:
                import torch
                ann = torch.profiler.record_function(name)
                ann.__enter__()
            except Exception:
                ann = None
        stack = self._ctx_stack()
        if ctx is None and stack:
            ctx = stack[-1].child()
        pushed = ctx is not None
        if pushed:
            stack.append(ctx)
        t0 = self._now_us()
        try:
            yield self
        finally:
            dur = self._now_us() - t0
            if pushed and stack and stack[-1] is ctx:
                stack.pop()
            if ann is not None:
                ann.__exit__(None, None, None)
            if ctx is not None:
                args = {**args, **ctx.ids()}
            tid = threading.get_ident() % 2 ** 31
            ev = {"name": name, "cat": cat, "ph": "X",
                  "ts": t0, "dur": dur, "pid": self.pid, "tid": tid}
            if args:
                ev["args"] = args
            tname = threading.current_thread().name
            with self._lock:
                self._lanes.setdefault(tid, tname)
                self._append(ev)

    def _append(self, ev):  # under self._lock
        if len(self._events) == self._events.maxlen:
            self.dropped_events += 1
        self._events.append(ev)

    def lane(self, name: str) -> int:
        """A synthetic track (tid) with a display name, for spans of a
        logical flow (one serving request) rather than a thread. Same
        name, same tid."""
        with self._lock:
            for tid, lname in self._lanes.items():
                if lname == name and tid >= 1_000_000_000:
                    return tid
            tid = self._next_lane_tid
            self._next_lane_tid += 1
            self._lanes[tid] = name
            return tid

    def add_span(self, name: str, ts_us: float, dur_us: float,
                 cat: str = "host", tid: Optional[int] = None,
                 ctx: Optional[TraceContext] = None, **args):
        """Record a complete span with explicit timestamps, for producers
        that know a phase's bounds only afterwards (the serving engines
        rebuild a request's phases when it finishes). `tid` defaults to
        the calling thread; `lane(name)` gives a synthetic track."""
        if ctx is not None:
            args = {**args, **ctx.ids()}
        if tid is None:
            tid = threading.get_ident() % 2 ** 31
            tname = threading.current_thread().name
        else:
            tname = None
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": ts_us, "dur": max(0.0, dur_us),
              "pid": self.pid, "tid": tid}
        if args:
            ev["args"] = args
        with self._lock:
            if tname is not None:
                self._lanes.setdefault(tid, tname)
            self._append(ev)

    def add_flow(self, flow_id, name: str, ts_from_us: float, tid_from: int,
                 ts_to_us: float, tid_to: int, cat: str = "flow"):
        """Link two tracks with a Chrome flow arrow (`ph:"s"` -> `ph:"f"`),
        as a request's lane points at the batch that served it. `flow_id`
        is unique per arrow within the trace."""
        s = {"name": name, "cat": cat, "ph": "s", "id": flow_id,
             "ts": ts_from_us, "pid": self.pid, "tid": tid_from}
        f = {"name": name, "cat": cat, "ph": "f", "bp": "e", "id": flow_id,
             "ts": max(ts_to_us, ts_from_us), "pid": self.pid,
             "tid": tid_to}
        with self._lock:
            self._append(s)
            self._append(f)

    @property
    def events(self) -> List[Dict]:
        """A copy of the recorded events."""
        with self._lock:
            return list(self._events)

    def reset(self):
        with self._lock:
            self._events.clear()
            self.dropped_events = 0

    # ------------------------------------------------------------ export
    def to_chrome_trace(self) -> Dict:
        """The trace as a Chrome trace-event JSON object
        (`{"traceEvents": [...], "displayTimeUnit": "ms"}`, with process
        and thread metadata events)."""
        with self._lock:
            events = list(self._events)
            dropped = self.dropped_events
            lanes = dict(self._lanes)
        proc_args = {"name": self.process_name}
        if dropped:
            proc_args["dropped_events"] = dropped
        meta = [{"name": "process_name", "ph": "M", "pid": self.pid,
                 "tid": 0, "args": proc_args}]
        for tid in sorted({e["tid"] for e in events}):
            meta.append({"name": "thread_name", "ph": "M", "pid": self.pid,
                         "tid": tid,
                         "args": {"name": lanes.get(tid, f"host-{tid}")}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write the Chrome trace JSON to `path` (local or `memory://`);
        https://ui.perfetto.dev opens it. Returns `path`."""
        from bigdl_tpu_torch.utils import filesystem as fsys
        with fsys.open_file(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


def merge_traces(tracers: Sequence[SpanTracer]) -> Dict:
    """One Chrome trace document from several tracers, each on its own
    process lane. Timestamps are epoch microseconds in every tracer, so
    nothing is rebased."""
    events: List[Dict] = []
    for tr in tracers:
        events.extend(tr.to_chrome_trace()["traceEvents"])
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_merged(path: str, tracers: Sequence[SpanTracer]) -> str:
    """`merge_traces` straight to a file; returns `path`."""
    from bigdl_tpu_torch.utils import filesystem as fsys
    with fsys.open_file(path, "w") as f:
        json.dump(merge_traces(tracers), f)
    return path
