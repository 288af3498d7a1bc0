"""Structured run metrics: per-step records fanned out to pluggable sinks
(counterpart of `bigdl_tpu/observability/telemetry.py`).

`Telemetry` turns the training loops' per-sync figures (step, loss, lr,
throughput, step wall time, optional grad/param norms) plus host and
device resource figures into flat JSON-safe dicts and hands them to every
attached sink. Record types:

- `run_start`  - one per `optimize()` call: the run's configuration.
- `step`       - one per sync point (= per iteration at sync_interval 1).
- `event`      - health-monitor and resilience findings (nan_guard,
                 straggler, run_abort, retry, ...).
- `run_end`    - the final step count plus the `Metrics.as_dict()` table.
- `trace` / `serving_stats` / `serving_summary` / `generation` - the
  serving engines' records.

Every record type's field contract is declared in `RECORD_SCHEMAS`, the
reference's own, record for record (`compile`, `slo_status`, `alert`,
`serving_fleet`, `workload_replay` and the rest included), checked by
`validate_record`.

Every record carries `time` (epoch seconds, absolute, so streams overlay
on device traces). Durations inside records are measured on monotonic
clocks by their producers.

Example:
    >>> from bigdl_tpu_torch.observability import (InMemorySink, Telemetry,
    ...                                            validate_record)
    >>> sink = InMemorySink()
    >>> tel = Telemetry(sink, resources=False, flight=False)
    >>> tel.step(step=1, loss=0.5)
    >>> validate_record(sink.steps()[0])
    >>> sink.steps()[0]["loss"]
    0.5
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, List, Optional

from bigdl_tpu_torch.resilience import faults


def host_rss_mb() -> Optional[float]:
    """Current resident set size of this process in MB (from
    /proc/self/statm; None where procfs is unavailable)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1e6
    except (OSError, ValueError, IndexError):
        return None


def device_memory_stats() -> List[Dict]:
    """Per-card memory figures of this process, one dict per visible CUDA
    device: `bytes_in_use` and `peak_bytes_in_use` are PyTorch's caching
    allocator's `allocated_bytes.all.current` and `.peak`
    (`torch.cuda.memory_stats`), the bytes of live tensors, not what the
    allocator holds in reserve (the reference's keys, read there from
    PJRT).
    Without a card (the CPU), `[]`."""
    import torch
    if not torch.cuda.is_available():
        return []
    out = []
    for d in range(torch.cuda.device_count()):
        try:
            stats = torch.cuda.memory_stats(d)
        except Exception:
            stats = None
        if not stats:
            continue
        out.append({"device": f"cuda:{d}",
                    "bytes_in_use": stats.get("allocated_bytes.all.current"),
                    "peak_bytes_in_use":
                        stats.get("allocated_bytes.all.peak")})
    return out


def sanitize_nonfinite(obj):
    """Strict-JSON view of a record: non-finite floats become `null`, and
    a dict field also gains a sibling `"<field>_nonfinite": true` marker,
    so consumers can tell "loss was NaN" from "loss was absent". Recurses
    through nested dicts and lists; everything else passes through."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if isinstance(v, float) and not math.isfinite(v):
                out[k] = None
                out[k + "_nonfinite"] = True
            else:
                out[k] = sanitize_nonfinite(v)
        return out
    if isinstance(obj, (list, tuple)):
        return [None if isinstance(v, float) and not math.isfinite(v)
                else sanitize_nonfinite(v) for v in obj]
    return obj


class TelemetrySink:
    """A destination for telemetry records. Subclasses implement `emit`
    (one flat JSON-safe dict per call); `close` is optional."""

    def emit(self, record: Dict):
        raise NotImplementedError

    def close(self):
        pass


class JsonlSink(TelemetrySink):
    """Append records to a JSONL file, one strict-JSON object per line
    (non-finite floats as `null` with a `<field>_nonfinite` marker),
    flushed per record so a crashed run still leaves its stream."""

    def __init__(self, path: str, append: bool = True):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a" if append else "w")

    def emit(self, record: Dict):
        self._f.write(json.dumps(sanitize_nonfinite(record),
                                 allow_nan=False) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class InMemorySink(TelemetrySink):
    """Collects records in a list: the test and notebook sink."""

    def __init__(self):
        self.records: List[Dict] = []

    def emit(self, record: Dict):
        self.records.append(record)

    def steps(self) -> List[Dict]:
        """Just the per-step records, in order."""
        return [r for r in self.records if r.get("type") == "step"]


class SummarySink(TelemetrySink):
    """Numeric fields of `step` records as `summary.add_scalar(tag,
    value, step)` calls under `telemetry/<field>` tags. `summary` is any
    object with `add_scalar` and `close` (a `visualization.TrainSummary`,
    say)."""

    _SKIP = ("step", "epoch", "time", "type")

    def __init__(self, summary):
        self.summary = summary

    def emit(self, record: Dict):
        if record.get("type") != "step" or "step" not in record:
            return
        it = int(record["step"])
        for key, val in record.items():
            if key in self._SKIP or not isinstance(val, (int, float)):
                continue
            self.summary.add_scalar(f"telemetry/{key}", float(val), it)

    def close(self):
        self.summary.close()


class CompositeSink(TelemetrySink):
    """Fan one stream out to several sinks."""

    def __init__(self, *sinks: TelemetrySink):
        self.sinks = list(sinks)

    def emit(self, record: Dict):
        for s in self.sinks:
            s.emit(record)

    def close(self):
        for s in self.sinks:
            s.close()


_NUM = (int, float)
_OPT_NUM = (int, float, type(None))
_OPT_STR = (str, type(None))

#: Declared field contract per record type (the reference's): `required`
#: fields are always present with the given types, `optional` fields are
#: typed when present, and unless `open` is True any other field is a
#: violation (`<field>_nonfinite` markers excepted). `event` is open.
RECORD_SCHEMAS: Dict[str, Dict] = {
    "run_start": {
        "required": {},
        "optional": {"loop": str, "model": str, "optim_method": str,
                     "backend": str, "n_devices": int, "sync_interval": int},
    },
    "step": {
        "required": {"step": int},
        "optional": {
            "epoch": int, "loss": _OPT_NUM, "lr": _NUM,
            "throughput": _NUM, "step_time_s": _NUM, "records": int,
            "grad_norm": _NUM, "param_norm": _NUM, "nonfinite_steps": int,
            "host_rss_mb": _NUM, "device_mem": list,
            "prefetch_queue_depth": int, "prefetch_fetch_wait_s": _NUM,
            "prefetch_worker_busy": _NUM,
            "flops_per_step": _OPT_NUM, "bytes_accessed": _OPT_NUM,
            "mfu": _OPT_NUM,
        },
    },
    "event": {
        "required": {"event": str},
        "optional": {},
        "open": True,
    },
    "compile": {
        "required": {"label": str, "signature": str, "lower_s": _NUM,
                     "compile_s": _NUM, "cache_hit": bool},
        "optional": {"jaxpr_eqns": _OPT_NUM, "flops": _OPT_NUM,
                     "bytes_accessed": _OPT_NUM},
    },
    "run_end": {
        "required": {},
        "optional": {"step": int, "epoch": int, "loss": _OPT_NUM,
                     "metrics": dict},
    },
    # one per finished serving request: the phase breakdown under the
    # request's trace identity; kind="generate" requests carry the
    # prefill/decode split and the token count instead
    "trace": {
        "required": {"trace_id": str, "kind": str, "status": str},
        "optional": {"latency_ms": _NUM, "queue_wait_ms": _NUM,
                     "batch_form_ms": _NUM, "dispatch_ms": _NUM,
                     "forward_ms": _NUM, "fetch_ms": _NUM,
                     "prefill_ms": _NUM, "decode_ms": _NUM, "tokens": int,
                     "batch": int, "bucket": int,
                     "critical_path": list, "error": str,
                     "sample_weight": int, "replica_id": str,
                     "arrival_offset_ms": _NUM, "session_id": _OPT_STR,
                     "deadline_budget_ms": _OPT_NUM, "idempotent": bool,
                     "shape": list, "prompt_tokens": int},
    },
    # continuous-batching generation snapshot, one every emit_every
    # decode steps plus a final one at close
    "generation": {
        "required": {"slots": int, "active_slots": int,
                     "tokens_total": int, "decode_steps": int,
                     "prefill_requests": int, "slot_joins": int,
                     "slot_leaves": int, "tokens_per_sec": _OPT_NUM,
                     "decode_occupancy": _OPT_NUM},
        "optional": {"queue_depth": int, "max_len": int,
                     "prefill_batches": int, "prefill_s_total": _NUM,
                     "decode_s_total": _NUM},
    },
    "serving_fleet": {
        "required": {"replicas_alive": int, "replicas_total": int,
                     "replicas_draining": int, "reroutes_total": int},
        "optional": {"routed_total": int, "affinity_routes_total": int,
                     "reroute_failed_total": int, "drains_total": int,
                     "scale_ups_total": int, "scale_downs_total": int,
                     "generations_total": int,
                     "stream_reroutes_total": int,
                     "replica_queue_depth": dict},
    },
    "slo_status": {
        "required": {"slo": str, "kind": str, "alerting": bool},
        "optional": {"objective": _NUM, "good": int, "bad": int,
                     "compliance": _OPT_NUM, "burn_rate": _OPT_NUM,
                     "error_budget_remaining": _OPT_NUM,
                     "window_s": _NUM, "alerts_fired": int},
    },
    "workload_replay": {
        "required": {"workload": str, "entries_total": int,
                     "entries_done": int, "chaos_fired": int},
        "optional": {"seed": int, "speed": _NUM, "offset_ms": _NUM,
                     "ok": int, "errors": int, "timeouts": int,
                     "shed": int},
    },
    "replay_summary": {
        "required": {"workload": str, "entries_total": int,
                     "ok": int, "errors": int, "timeouts": int,
                     "shed": int, "chaos_fired": int},
        "optional": {"seed": int, "speed": _NUM, "replicas": int,
                     "workload_sha256": str, "duration_ms": _NUM,
                     "rerouted": int, "cancelled": int,
                     "divergent": bool, "divergence": _OPT_STR},
    },
    # a burn-rate breach; the flight recorder dumps on it
    "alert": {
        "required": {"slo": str, "message": str},
        "optional": {"kind": str, "severity": str,
                     "burn_rate_short": _NUM, "burn_rate_long": _NUM,
                     "short_window_s": _NUM, "long_window_s": _NUM,
                     "factor": _NUM},
    },
}

_SERVING_FIELDS = {
    "required": {"queue_depth": int, "submitted": int, "completed": int,
                 "failed": int, "timed_out": int, "rejected": int,
                 "cancelled": int, "shed": int, "batches": int,
                 "bucket_hits": int, "rows": int, "padded_rows": int,
                 "bucket_hit_rate": _OPT_NUM, "pad_fraction": _OPT_NUM,
                 "queue_wait_ms_count": int, "latency_ms_count": int,
                 "batch_size_count": int},
    "optional": {
        **{f"{pre}_p{q}": _NUM
           for pre in ("queue_wait_ms", "latency_ms", "batch_size")
           for q in (50, 95, 99)},
        "flops_per_step": _OPT_NUM, "bytes_accessed": _OPT_NUM,
        "mfu": _OPT_NUM,
    },
}
RECORD_SCHEMAS["serving_stats"] = _SERVING_FIELDS
RECORD_SCHEMAS["serving_summary"] = _SERVING_FIELDS


def validate_record(record: Dict):
    """Check one record against `RECORD_SCHEMAS`; raises `ValueError`
    naming the first violation (unknown type, missing or mistyped field,
    undeclared field on a closed record type)."""
    rtype = record.get("type")
    if rtype not in RECORD_SCHEMAS:
        raise ValueError(f"unknown record type {rtype!r}")
    if not isinstance(record.get("time"), (int, float)):
        raise ValueError(f"{rtype}: missing/mistyped 'time'")
    schema = RECORD_SCHEMAS[rtype]
    fields = {**schema["required"], **schema["optional"]}

    def check(name, types):
        val = record[name]
        allowed = types if isinstance(types, tuple) else (types,)
        ok = isinstance(val, allowed)
        # bools are ints in python; True does not satisfy an int field
        if ok and isinstance(val, bool) and bool not in allowed:
            ok = False
        if not ok:
            raise ValueError(
                f"{rtype}.{name}: {type(val).__name__} not in {types}")

    for name, types in schema["required"].items():
        if name not in record:
            raise ValueError(f"{rtype}: missing required field {name!r}")
        check(name, types)
    for name in record:
        if name in ("type", "time") or name.endswith("_nonfinite"):
            continue
        if name in fields:
            check(name, fields[name])
        elif not schema.get("open"):
            raise ValueError(f"{rtype}: undeclared field {name!r}")


class Telemetry:
    """The collector the training loops and serving engines emit through.

    Attach with `set_telemetry` (the loops) or `telemetry=` (the engines).
    The loops call `step(...)` at every sync point and `run_start` /
    `run_end` around a run.

    - `grad_norms=True`: the step also computes the global gradient and
      parameter L2 norms on the device, read back once a sync point.
    - `resources=True`: every step record also carries the host RSS and
      `device_memory_stats()` (host-side reads only).
    - `flight`: the crash flight recorder (`observability/flight.py`):
      every record also lands in a bounded ring, dumped to disk on
      `run_abort`, `fault_injected` and a NaN-guard `raise`. Pass a
      configured `FlightRecorder`, or `False` to disable.

    With `BIGDL_TPU_STRICT_TELEMETRY=1` in the environment, a record of
    an undeclared type raises.
    """

    def __init__(self, *sinks: TelemetrySink, grad_norms: bool = False,
                 resources: bool = True, flight=None):
        from bigdl_tpu_torch.observability.flight import FlightRecorder
        self.sink = CompositeSink(*sinks)
        self.grad_norms = grad_norms
        self.resources = resources
        if flight is None:
            flight = FlightRecorder()
        self.flight = flight or None  # False/0: disabled

    def add_sink(self, sink: TelemetrySink) -> "Telemetry":
        self.sink.sinks.append(sink)
        return self

    def emit(self, record: Dict):
        if os.environ.get("BIGDL_TPU_STRICT_TELEMETRY") == "1":
            rtype = record.get("type")
            if rtype not in RECORD_SCHEMAS:
                raise ValueError(
                    f"unknown telemetry record type {rtype!r} under "
                    f"BIGDL_TPU_STRICT_TELEMETRY=1: declare it in "
                    f"RECORD_SCHEMAS (known: "
                    f"{', '.join(sorted(RECORD_SCHEMAS))})")
        # a fault plan can make the sink path fail here, to show that a
        # failing sink never stops the system it observes
        faults.fire("telemetry.sink", record_type=record.get("type"))
        record.setdefault("time", time.time())
        if self.flight is not None:
            # the ring first: a failing sink must not starve the crash
            # record
            self.flight.emit(record)
        self.sink.emit(record)

    def run_start(self, **fields):
        self.emit({"type": "run_start", **fields})

    def step(self, **fields):
        rec = {"type": "step", **fields}
        if self.resources:
            rss = host_rss_mb()
            if rss is not None:
                rec["host_rss_mb"] = round(rss, 2)
            mem = device_memory_stats()
            if mem:
                rec["device_mem"] = mem
        self.emit(rec)

    def event(self, kind: str, **fields):
        self.emit({"type": "event", "event": kind, **fields})

    def run_end(self, **fields):
        self.emit({"type": "run_end", **fields})

    def close(self):
        self.sink.close()
