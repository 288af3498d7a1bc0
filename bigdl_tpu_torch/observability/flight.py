"""Crash flight recorder: a bounded ring of recent telemetry records and
spans (counterpart of `bigdl_tpu/observability/flight.py`).

When a run dies (an injected fault, a NaN-guard abort, an exception), the
interesting part of its stream is the last few seconds. Every record
passes through a fixed-size ring (a `deque.append`; no I/O on the happy
path), and a trigger record dumps the ring to one strict-JSON file.

Triggers (`DEFAULT_TRIGGERS`): a `run_abort` event (a loop died), a
`fault_injected` event (a fault plan fired), a `nan_guard` event with
`action="raise"`, and an `alert` record. `dump(path)` also works on
demand. Dumps go to `$BIGDL_TPU_FLIGHT_DIR`, else
`<tempdir>/bigdl_tpu_flight`, as `flight_<pid>_<n>_<trigger>.json`.

With a `SpanTracer` attached (`attach_tracer`; both optimizers do it when
a tracer and a telemetry stream are both set), each dump also carries the
newest spans.

`Telemetry` creates one by default (`flight=` to replace or disable).

Example:
    >>> from bigdl_tpu_torch.observability import FlightRecorder
    >>> fr = FlightRecorder(capacity=2, triggers=())
    >>> for i in range(3):
    ...     fr.emit({"type": "step", "step": i})
    >>> [r["step"] for r in fr.records()]
    [1, 2]
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
from collections import deque
from typing import Dict, List, Optional

logger = logging.getLogger("bigdl_tpu_torch.observability")

#: the triggers that dump the ring (record types and event kinds)
DEFAULT_TRIGGERS = ("run_abort", "fault_injected", "nan_guard_raise",
                    "alert")


def _default_dump_dir() -> str:
    return os.environ.get("BIGDL_TPU_FLIGHT_DIR") or os.path.join(
        tempfile.gettempdir(), "bigdl_tpu_flight")


class FlightRecorder:
    """Bounded ring of the last `capacity` telemetry records (and a span
    tail).

    Usable alone as a sink (it has `emit` / `close`), but normally lives
    on `Telemetry.flight`, fed before the sinks so a failing sink cannot
    starve the crash record.

    capacity : ring size in records.
    dump_dir : where auto-dumps land (default `$BIGDL_TPU_FLIGHT_DIR` or
        `<tempdir>/bigdl_tpu_flight`).
    span_tail : how many of the tracer's newest spans a dump carries.
    triggers : which records auto-dump (`DEFAULT_TRIGGERS`); `()` for a
        ring dumped by hand only.
    """

    def __init__(self, capacity: int = 512, dump_dir: Optional[str] = None,
                 span_tail: int = 128, triggers=DEFAULT_TRIGGERS):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.dump_dir = dump_dir or _default_dump_dir()
        self.span_tail = span_tail
        self.triggers = tuple(triggers)
        self.tracer = None
        self.last_dump_path: Optional[str] = None
        self.dumps = 0
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    # ------------------------------------------------------------ recording
    def attach_tracer(self, tracer) -> "FlightRecorder":
        """Include `tracer`'s newest spans in every dump."""
        self.tracer = tracer
        return self

    def _trigger_of(self, record: Dict) -> Optional[str]:
        if record.get("type") == "alert" and "alert" in self.triggers:
            return "alert"
        if record.get("type") != "event":
            return None
        kind = record.get("event")
        if kind in ("run_abort", "fault_injected") and kind in self.triggers:
            return kind
        if kind == "nan_guard" and record.get("action") == "raise" \
                and "nan_guard_raise" in self.triggers:
            return "nan_guard_raise"
        return None

    def emit(self, record: Dict):
        """Append to the ring; dump when `record` is a trigger. A failed
        dump is logged, never raised: the recorder must not take down the
        run it records."""
        with self._lock:
            self._ring.append(record)
        trigger = self._trigger_of(record)
        if trigger is not None:
            try:
                self.dump(trigger=trigger)
            except Exception:
                logger.exception("flight-recorder auto-dump failed")

    def records(self) -> List[Dict]:
        """The ring, oldest first."""
        with self._lock:
            return list(self._ring)

    def close(self):
        pass  # owns nothing; the sink protocol's close

    # ---------------------------------------------------------------- dump
    def dump(self, path: Optional[str] = None,
             trigger: str = "manual") -> str:
        """Write the ring (and the span tail, with a tracer attached) to
        `path`, default a fresh `flight_<pid>_<n>_<trigger>.json` under
        `dump_dir`, as strict JSON (non-finite floats nulled with
        `_nonfinite` markers, as `JsonlSink` writes them). Returns the
        path."""
        from bigdl_tpu_torch.observability.telemetry import \
            sanitize_nonfinite
        with self._lock:
            records = list(self._ring)
            self.dumps += 1
            n = self.dumps
        doc = {"dumped_at": time.time(), "trigger": trigger,
               "records": sanitize_nonfinite(records)}
        if self.tracer is not None:
            try:
                doc["spans"] = sanitize_nonfinite(
                    self.tracer.events[-self.span_tail:])
            except Exception:
                logger.exception("flight-recorder span capture failed")
        if path is None:
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(
                self.dump_dir, f"flight_{os.getpid()}_{n}_{trigger}.json")
        with open(path, "w") as f:
            json.dump(doc, f, allow_nan=False)
        self.last_dump_path = path
        logger.warning("flight recorder dumped %d records to %s "
                       "(trigger: %s)", len(records), path, trigger)
        return path
