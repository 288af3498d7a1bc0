"""Open-loop workload replay with a virtual clock and chaos interleave
(counterpart of `bigdl_tpu/workload/replay.py`, pure Python; the
targets are the port's engines and `ServingFleet`).

`WorkloadReplayer` drives a recorded (or synthesized) `Workload`
against a live serving target — an `InferenceEngine`, a
`GenerationEngine`, or a `ServingFleet` (typically over
`SimulatedCluster`-style virtual devices in CI) — in two phases:

1. **drive** — submit entries in arrival order, pacing on an
   injectable clock at `offset / speed` (time compression; the
   `VirtualClock` collapses all waits for tests), firing the
   `ChaosSchedule`'s due actions at entry boundaries. Open-loop means
   arrivals do NOT wait for completions — a slow target builds queue,
   exactly like production.
2. **canonicalize** — once every outcome resolved, emit ONE
   deterministic stream through the replayer's telemetry: per-entry
   `trace` records at VIRTUAL times (`epoch + arrival_offset`),
   chaos `event` records at their fire offsets, `workload_replay`
   progress heartbeats, and a final `replay_summary`. Record times are
   virtual, trace ids are `replay-NNNNNN`, and fleet-internal noise is
   excluded — so the stream (and any `SloEngine` attached to the same
   telemetry) is a pure function of (workload, seed, target config).

That purity is the **SLO-replay invariance contract**
(docs/workload.md): same workload + same chaos seed + same target
config ⇒ `metrics_cli diff` finds byte-equal outcome tallies and
slo_status trajectories. It holds when chaos quiesces at entry
boundaries (the default) and deadlines are generous relative to
service time; wall-clock latency VALUES are never part of the
contract — the diff ignores them.
"""

import logging
import time as _time
from typing import Dict, List, Optional

import numpy as np

from bigdl_tpu_torch.workload.chaos import ChaosSchedule
from bigdl_tpu_torch.workload.record import Workload

__all__ = ["VirtualClock", "RealClock", "WorkloadReplayer"]

logger = logging.getLogger("bigdl_tpu_torch.workload")


class VirtualClock:
    """A clock that jumps instead of waiting: `sleep(dt)` advances
    `now()` by dt and returns immediately. Deterministic pacing for
    tests and maximal time compression for CI."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def sleep(self, dt: float):
        if dt > 0:
            self._t += dt


class RealClock:
    """Wall-clock pacing (`time.monotonic` / `time.sleep`) — soak runs
    that should feel like production."""

    def now(self) -> float:
        return _time.monotonic()

    def sleep(self, dt: float):
        if dt > 0:
            _time.sleep(dt)


def _classify(exc: Optional[BaseException]) -> str:
    """Map a resolution to the trace-status vocabulary. Import-light so
    an engine-less test double still classifies."""
    if exc is None:
        return "ok"
    from bigdl_tpu_torch.serving.engine import (QueueFullError,
                                                ServingError,
                                                ServingTimeoutError)
    if isinstance(exc, ServingTimeoutError):
        return "timeout"
    if isinstance(exc, QueueFullError):
        return "shed"
    from concurrent.futures import CancelledError
    if isinstance(exc, CancelledError):
        return "cancelled"
    if isinstance(exc, ServingError):
        return "error"
    return "error"


class WorkloadReplayer:
    """Replay `workload` against `target` (see module docstring).

    Parameters the invariance gate cares about: `seed` resolves the
    chaos schedule's open choices AND synthesizes deterministic
    prompts/features; `speed` compresses time (5.0 = 5x faster;
    deadlines are honored AS RECORDED unless `scale_deadlines=True`
    divides them too — compressed arrivals with production deadline
    budgets is the honest default, docs/workload.md spells out why);
    `quiesce_on_chaos` (default True) waits out in-flight work before a
    chaos action fires, making the routing history — and therefore the
    outcome trajectory — deterministic.

    `telemetry` receives the canonical stream; attach an `SloEngine`
    and/or a `JsonlSink` to it. `baseline` (a records list or a JSONL
    path) makes `run()` self-diff against a previous replay and stamp
    `divergent` / `divergence` on the `replay_summary`.
    """

    def __init__(self, target, workload: Workload,
                 chaos: Optional[ChaosSchedule] = None,
                 seed: int = 0, speed: float = 1.0,
                 clock=None, telemetry=None,
                 scale_deadlines: bool = False,
                 progress_every: int = 50,
                 quiesce_on_chaos: bool = True,
                 result_timeout_s: float = 120.0,
                 epoch: float = 0.0,
                 baseline=None):
        if speed <= 0:
            raise ValueError(f"speed must be > 0, got {speed}")
        if progress_every < 1:
            raise ValueError("progress_every must be >= 1")
        self.target = target
        self.workload = workload
        self.seed = int(seed)
        if chaos is None and workload.chaos:
            chaos = ChaosSchedule.from_dicts(workload.chaos,
                                             seed=self.seed)
        self.chaos = chaos
        self.speed = float(speed)
        self.clock = clock if clock is not None else VirtualClock()
        self.telemetry = telemetry
        self.scale_deadlines = bool(scale_deadlines)
        self.progress_every = int(progress_every)
        self.quiesce_on_chaos = bool(quiesce_on_chaos)
        self.result_timeout_s = float(result_timeout_s)
        self.epoch = float(epoch)
        self.baseline = baseline
        self._is_fleet = hasattr(target, "maintain") \
            and hasattr(target, "replica_ids")
        self._can_generate = hasattr(target, "generate")

    # ------------------------------------------------------------ requests
    def _sample_for(self, entry, i: int):
        shape = entry.shape if entry.shape else [4]
        # deterministic content: the seed and index, nothing wall-clock
        rng = np.random.default_rng(self.seed * 1_000_003 + i)
        return rng.standard_normal(shape).astype(np.float32)

    def _prompt_for(self, entry, i: int):
        n = entry.prompt_tokens or 4
        rng = np.random.default_rng(self.seed * 1_000_003 + i)
        # 1-based ids in a deliberately small band: any toy vocab holds
        return (1 + rng.integers(0, 32, size=n)).astype(np.int32)

    def _submit(self, entry, i: int):
        """Hand one entry to the target; returns a handle with
        `.result(timeout)` (Future, TokenStream, FleetTokenStream)."""
        deadline = entry.deadline_ms
        if deadline is not None and self.scale_deadlines:
            deadline = deadline / self.speed
        if entry.is_generate():
            if not self._can_generate:
                raise TypeError(
                    f"workload entry {i} is kind={entry.kind} but the "
                    f"target has no generate()")
            kw = {"deadline_ms": deadline}
            if entry.max_new_tokens:
                kw["max_new_tokens"] = entry.max_new_tokens
            if entry.session_id is not None:
                kw["session"] = entry.session_id
            if self._is_fleet:
                kw["idempotent"] = entry.idempotent
            return self.target.generate(self._prompt_for(entry, i), **kw)
        kw = {"deadline_ms": deadline}
        if entry.session_id is not None:
            kw["session"] = entry.session_id
        if self._is_fleet:
            kw["idempotent"] = entry.idempotent
        return self.target.submit(self._sample_for(entry, i), **kw)

    def _resolve(self, handle) -> str:
        """Block on one handle's terminal outcome; returns a status."""
        try:
            handle.result(self.result_timeout_s)
            return "ok"
        except BaseException as e:  # noqa: BLE001 — classified, not hidden
            return _classify(e)

    def _watch_latency(self, handle, i: int, latencies: List):
        """Best-effort wall latency per entry, measured at COMPLETION
        via a done-callback where the handle has one (futures; token
        streams fall back to drain time in `_drain_pending`). Values
        are informational — the invariance diff never reads them — but
        the canonical records need SOME latency for the latency SLO to
        score `ok` outcomes against its threshold."""
        t0 = _time.perf_counter()
        if hasattr(handle, "add_done_callback"):
            def _done(_f, t0=t0, i=i):
                latencies[i] = (_time.perf_counter() - t0) * 1e3
            try:
                handle.add_done_callback(_done)
            except Exception:
                pass
        return t0

    # ------------------------------------------------------------ the run
    def run(self) -> Dict:
        """Drive the whole workload; returns the `replay_summary` dict
        (also emitted through `telemetry`)."""
        entries = self.workload.entries
        n = len(entries)
        if self.chaos is not None:
            self.chaos.reset()
        t_start = self.clock.now()
        statuses: List[Optional[str]] = [None] * n
        latencies: List[Optional[float]] = [None] * n
        pending: List = []  # (index, handle, t_submitted)
        chaos_trail: List[Dict] = []  # event dicts + their emit offset
        try:
            for i, e in enumerate(entries):
                off = e.arrival_offset_ms
                if self.chaos is not None and self._is_fleet:
                    due = [a for a in self.chaos.actions
                           if a.due(off, i)]
                    if due:
                        if self.quiesce_on_chaos:
                            self._drain_pending(pending, statuses,
                                                latencies)
                        for ev in self.chaos.fire_due(self.target,
                                                      off, i):
                            ev["emit_offset_ms"] = round(off, 3)
                            chaos_trail.append(ev)
                        self.target.maintain()
                self.clock.sleep(t_start + off / 1e3 / self.speed
                                 - self.clock.now())
                try:
                    handle = self._submit(e, i)
                except BaseException as exc:  # noqa: BLE001
                    statuses[i] = _classify(exc)
                    latencies[i] = 0.0
                    continue
                pending.append((i, handle,
                                self._watch_latency(handle, i,
                                                    latencies)))
            # actions scheduled past the last arrival still fire —
            # a restore tail, a final scale-down
            if self.chaos is not None and self._is_fleet:
                end = self.workload.duration_ms
                for ev in self.chaos.fire_due(self.target, end, n):
                    ev["emit_offset_ms"] = round(end, 3)
                    chaos_trail.append(ev)
                self.target.maintain()
            self._drain_pending(pending, statuses, latencies)
        finally:
            if self.chaos is not None:
                self.chaos.close()
        return self._canonicalize(statuses, latencies, chaos_trail)

    def _drain_pending(self, pending: List, statuses: List,
                       latencies: List):
        for i, handle, t0 in pending:
            statuses[i] = self._resolve(handle)
            if latencies[i] is None:  # no done-callback fired (token
                # streams): drain time IS completion time, result()
                # just blocked until the stream finished
                latencies[i] = (_time.perf_counter() - t0) * 1e3
        del pending[:]

    # ------------------------------------------------------ canonical emit
    def _canonicalize(self, statuses: List[str],
                      latencies: List[Optional[float]],
                      chaos_trail: List[Dict]) -> Dict:
        entries = self.workload.entries
        n = len(entries)
        tally = {"ok": 0, "errors": 0, "timeouts": 0, "shed": 0,
                 "cancelled": 0}
        key = {"ok": "ok", "error": "errors", "timeout": "timeouts",
               "shed": "shed", "cancelled": "cancelled"}
        stream: List[tuple] = []  # (offset_ms, seq, record)
        seq = 0
        for ev in chaos_trail:
            stream.append((ev.pop("emit_offset_ms"), seq,
                           {"type": "event", **ev}))
            seq += 1
        done = 0
        for i, (e, st) in enumerate(zip(entries, statuses)):
            st = st or "error"
            tally[key.get(st, "errors")] += 1
            done += 1
            off = e.arrival_offset_ms
            rec = {"type": "trace", "trace_id": f"replay-{i:06d}",
                   "kind": e.kind, "status": st,
                   "arrival_offset_ms": round(off, 3)}
            if latencies[i] is not None:
                # measured wall latency: informational (the diff
                # ignores it) but the latency SLO scores against it
                rec["latency_ms"] = round(latencies[i], 3)
            if e.session_id is not None:
                rec["session_id"] = e.session_id
            if e.deadline_ms is not None:
                rec["deadline_budget_ms"] = round(e.deadline_ms, 3)
            if e.shape is not None:
                rec["shape"] = e.shape
            if e.prompt_tokens is not None:
                rec["prompt_tokens"] = e.prompt_tokens
            stream.append((off, seq, rec))
            seq += 1
            if done % self.progress_every == 0 or done == n:
                stream.append((off, seq, {
                    "type": "workload_replay",
                    "workload": self.workload.name,
                    "entries_total": n, "entries_done": done,
                    "chaos_fired": len(chaos_trail),
                    "seed": self.seed, "speed": self.speed,
                    "offset_ms": round(off, 3),
                    "ok": tally["ok"], "errors": tally["errors"],
                    "timeouts": tally["timeouts"],
                    "shed": tally["shed"]}))
                seq += 1
        summary = {"type": "replay_summary",
                   "workload": self.workload.name,
                   "entries_total": n,
                   "ok": tally["ok"], "errors": tally["errors"],
                   "timeouts": tally["timeouts"], "shed": tally["shed"],
                   "cancelled": tally["cancelled"],
                   "chaos_fired": len(chaos_trail),
                   "seed": self.seed, "speed": self.speed,
                   "workload_sha256": self.workload.sha256(),
                   "duration_ms": round(self.workload.duration_ms, 3)}
        if self._is_fleet:
            summary["replicas"] = len(self.target.replica_ids())
        stream.sort(key=lambda t: (t[0], t[1]))
        records = [dict(r, time=self.epoch + off / 1e3)
                   for off, _, r in stream]
        if self.baseline is not None:
            self._self_diff(records, summary)
        records.append(dict(summary,
                            time=self.epoch
                            + self.workload.duration_ms / 1e3))
        if self.telemetry is not None:
            for r in records:
                self.telemetry.emit(r)
        return records[-1]

    def _self_diff(self, records: List[Dict], summary: Dict):
        """Compare this replay's canonical stream against `baseline`
        and stamp the verdict on the summary (the Prometheus
        `workload_replay_divergent` gauge reads it)."""
        from bigdl_tpu_torch.workload.diff import compare_streams
        baseline = self.baseline
        if isinstance(baseline, str):
            from bigdl_tpu_torch.workload.diff import load_stream
            baseline = load_stream(baseline)
        # the baseline stream carries ITS summary; ours is not emitted
        # yet, so compare it explicitly alongside
        result = compare_streams(baseline, records + [summary])
        summary["divergent"] = result.divergent
        if result.divergent:
            summary["divergence"] = result.first
