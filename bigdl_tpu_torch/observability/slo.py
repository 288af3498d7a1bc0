"""Declarative SLOs with multi-window burn-rate alerting over telemetry
(counterpart of `bigdl_tpu/observability/slo.py`, pure Python, the same
rules, windows and records).

The attribution layer answers "where did the time go"; this module answers
"are we inside our budget RIGHT NOW". An `SLO` declares one objective —
a latency ceiling a fraction of requests must meet, an error-rate bound,
an MFU floor, a recovery-time (MTTR) bound — and the `SloEngine` is a
`TelemetrySink` that folds the live record stream into per-objective
good/bad samples and evaluates them the way production monitoring does
(Google SRE workbook ch.5): **burn rate** = (observed bad fraction) /
(error budget), alerting only when BOTH a short and a long window burn
faster than a threshold factor — fast enough to page on a real incident,
immune to one bad minute tripping a week-long budget.

Sample sources:
- `trace` records (serving/engine.py emits one per completed request)
  feed `latency` ("request finished ok within threshold_ms") and
  `error_rate` ("request finished ok at all") objectives,
- `step` records feed `mfu` ("per-step MFU at or above the floor"; steps
  with no MFU figure — CPU runs — are skipped, not failed),
- `worker_lost` events paired with the first subsequent proof of
  recovery feed `mttr`, matched to the lost worker's domain: a `step`
  record recovers a TRAINING loss, a status-ok `trace` record recovers
  a SERVING loss (events carrying `role: serving`, stamped from the
  fleet registry's worker metadata — fleet streams have no step
  records, and in a co-located stream an unrelated serving request
  must not "recover" a dead training worker). A loss that NEVER
  recovers counts bad at `finalize()` — a CI gate must fail a chaos
  run that simply died.

On an alert transition the engine emits an `alert` record (which the
crash flight recorder treats as a dump trigger — the stream tail around
the breach lands on disk) and `slo_status` records flow periodically so
`PrometheusTextSink` can export `slo_burn_rate` /
`slo_error_budget_remaining` gauges per objective. `metrics_cli slo
[--check]` replays a recorded stream through the same engine — the CI
gate and the live monitor share one implementation.

Time base: samples are stamped with the RECORD's `time` field, never the
wall clock, so a replayed stream evaluates exactly as the live run did.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from bigdl_tpu_torch.observability.telemetry import TelemetrySink

logger = logging.getLogger("bigdl_tpu_torch.observability")

#: (short_s, long_s, burn-rate factor) pairs, evaluated independently; an
#: SLO alerts when ANY pair has both windows burning >= factor. Defaults
#: are the SRE-workbook page tiers scaled to a service reviewed daily.
DEFAULT_WINDOWS: Tuple[Tuple[float, float, float], ...] = (
    (300.0, 3600.0, 14.4),    # 5m/1h both burning 14.4x -> page
    (1800.0, 21600.0, 6.0),   # 30m/6h both burning 6x   -> page
)


class SLO:
    """One declarative objective.

    Parameters
    ----------
    name : stable identifier (the `slo` label on records and gauges).
    kind : `latency` | `error_rate` | `mfu` | `mttr`.
    objective : target GOOD fraction (0.99 = 1% error budget). For
        `latency` with objective 0.99, `threshold_ms` is effectively a
        p99 ceiling: the SLO holds while 99% of requests beat it.
    threshold_ms : per-request latency ceiling (`latency` kind).
    floor : minimum per-step MFU (`mfu` kind).
    max_s : recovery deadline after a worker loss (`mttr` kind).
    windows : burn-rate window table; `DEFAULT_WINDOWS` unless given.
    min_samples : the long window must hold at least this many samples
        before the burn-rate ALERT rule is evaluated — on a stream
        shorter than the short window both windows see the same handful
        of samples, and one bad request must not page. Budget accounting
        (`error_budget_remaining`, `violated()`) is NOT gated: a CI
        replay with one unrecovered loss still fails the gate through
        the overspent budget.
    """

    KINDS = ("latency", "error_rate", "mfu", "mttr")

    def __init__(self, name: str, kind: str, objective: float = 0.99,
                 threshold_ms: Optional[float] = None,
                 floor: Optional[float] = None,
                 max_s: Optional[float] = None,
                 windows: Sequence[Tuple[float, float, float]] = None,
                 min_samples: int = 10):
        if kind not in self.KINDS:
            raise ValueError(f"kind must be one of {self.KINDS}, "
                             f"got {kind!r}")
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), "
                             f"got {objective}")
        if kind == "latency" and threshold_ms is None:
            raise ValueError("latency SLO needs threshold_ms")
        if kind == "mfu" and floor is None:
            raise ValueError("mfu SLO needs floor")
        if kind == "mttr" and max_s is None:
            raise ValueError("mttr SLO needs max_s")
        self.name = name
        self.kind = kind
        self.objective = objective
        self.threshold_ms = threshold_ms
        self.floor = floor
        self.max_s = max_s
        self.windows = tuple(windows) if windows is not None \
            else DEFAULT_WINDOWS
        self.min_samples = int(min_samples)

    @property
    def budget(self) -> float:
        """The error budget: the bad fraction the objective tolerates."""
        return 1.0 - self.objective

    def __repr__(self):
        return f"SLO({self.name!r}, kind={self.kind!r})"


def default_slos(latency_p99_ms: float = 100.0,
                 error_objective: float = 0.999,
                 mfu_floor: Optional[float] = None,
                 mttr_s: float = 60.0,
                 windows=None) -> List[SLO]:
    """The stock objective set the CLIs arm: a p99 latency ceiling, a
    request error-rate bound, a training-recovery deadline, and (opt-in,
    `mfu_floor=`) an MFU floor. Tune each knob or build `SLO`s directly
    for anything richer."""
    kw = {"windows": windows} if windows is not None else {}
    slos = [
        SLO("serving_latency_p99", "latency", objective=0.99,
            threshold_ms=latency_p99_ms, **kw),
        SLO("serving_errors", "error_rate", objective=error_objective,
            **kw),
        SLO("training_mttr", "mttr", objective=0.99, max_s=mttr_s, **kw),
    ]
    if mfu_floor is not None:
        slos.append(SLO("training_mfu", "mfu", objective=0.95,
                        floor=mfu_floor, **kw))
    return slos


class _Series:
    """Per-SLO (time, good) sample ring, pruned to the longest window.

    Times are kept sorted (records arrive in stream order; a rare
    out-of-order time is clamped forward) with a running bad-count prefix,
    so a window query is two bisects — the engine evaluates on every
    ingested record and a busy serving stream emits one trace record per
    request."""

    def __init__(self, horizon_s: float):
        self.horizon_s = horizon_s
        self.times: List[float] = []
        self.bad_prefix: List[int] = [0]  # bad_prefix[i] = bads in [:i]
        self.good_total = 0
        self.bad_total = 0

    def add(self, t: float, good: bool):
        if self.times and t < self.times[-1]:
            t = self.times[-1]
        self.times.append(t)
        self.bad_prefix.append(self.bad_prefix[-1] + (not good))
        if good:
            self.good_total += 1
        else:
            self.bad_total += 1

    def prune(self, now: float):
        """Drop samples older than the horizon. Purely memory management —
        `window()` bisects to its own cut, so stale entries never skew a
        query — which lets pruning be LAZY: the front is only rebuilt
        once >=1024 samples (or half the list) are stale, keeping emit
        amortized O(1) instead of O(window) per record on the serving
        dispatcher's hot path."""
        import bisect
        i = bisect.bisect_left(self.times, now - self.horizon_s)
        if i >= 1024 or (i and i * 2 >= len(self.times)):
            del self.times[:i]
            base = self.bad_prefix[i]
            self.bad_prefix = [b - base for b in self.bad_prefix[i:]]

    def window(self, now: float, window_s: float) -> Tuple[int, int]:
        """(good, bad) counts inside [now - window_s, now]."""
        import bisect
        i = bisect.bisect_left(self.times, now - window_s)
        n = len(self.times) - i
        bad = self.bad_prefix[-1] - self.bad_prefix[i]
        return n - bad, bad


class SloEngine(TelemetrySink):
    """Evaluate `SLO`s over a telemetry stream; live sink or replay.

    Wire-up (live): `engine.attach(telemetry)` adds it as a sink AND
    points its own `slo_status`/`alert` emissions back through the same
    `Telemetry` (so the flight recorder and the Prometheus sink both see
    them). Records the engine itself emits are ignored on ingest — no
    feedback loop. Replay: feed records to `emit()` in stream order (the
    CLI does) and read `status()` / `finalize()`.

    `emit_every_s` paces `slo_status` emission in RECORD time; alert
    transitions always emit immediately.
    """

    _OWN_TYPES = ("slo_status", "alert")

    def __init__(self, slos: Sequence[SLO], emit_every_s: float = 10.0):
        slos = list(slos)
        names = [s.name for s in slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.slos = slos
        self.emit_every_s = emit_every_s
        self._telemetry = None
        self._lock = threading.RLock()
        self._series: Dict[str, _Series] = {
            s.name: _Series(max(long for _, long, _f in s.windows))
            for s in slos}
        self._alerting: Dict[str, bool] = {s.name: False for s in slos}
        self._alerts_fired: Dict[str, int] = {s.name: 0 for s in slos}
        self._last_status_t: Optional[float] = None
        self._now: Optional[float] = None  # newest record time seen
        self._pending_loss_t: Optional[float] = None  # open worker_lost
        self._pending_loss_role: Optional[str] = None  # its worker role

    # ------------------------------------------------------------ wiring
    def attach(self, telemetry) -> "SloEngine":
        """Subscribe to `telemetry` and emit our own records through it."""
        self._telemetry = telemetry
        telemetry.add_sink(self)
        return self

    def _emit_own(self, record: Dict):
        if self._telemetry is None:
            return
        try:
            self._telemetry.emit(record)
        except Exception:
            logger.exception("slo record emission failed; dropped")

    # ------------------------------------------------------------ ingest
    def emit(self, record: Dict):
        rtype = record.get("type")
        if rtype in self._OWN_TYPES:
            return  # our own output fanned back by the composite sink
        t = record.get("time")
        if not isinstance(t, (int, float)):
            return
        with self._lock:
            self._now = t if self._now is None else max(self._now, t)
            if rtype == "trace":
                self._ingest_trace(record, t)
            elif rtype == "step":
                self._ingest_step(record, t)
            elif rtype == "event" and record.get("event") == "worker_lost":
                if self._pending_loss_t is None:
                    self._pending_loss_t = t
                    self._pending_loss_role = record.get("role")
            transitions = self._evaluate(self._now)
            emit_status = False
            if self._last_status_t is None or \
                    self._now - self._last_status_t >= self.emit_every_s:
                self._last_status_t = self._now
                emit_status = True
            status = self._status_unlocked(self._now) \
                if (emit_status or transitions) else None
        # emission outside the lock: it re-enters emit() via the fan-out
        for rec in transitions:
            self._emit_own(rec)
        if status is not None and (emit_status or transitions):
            for s in status:
                self._emit_own({"type": "slo_status", **s})

    def _ingest_trace(self, record: Dict, t: float):
        status = record.get("status", "ok")
        if record.get("kind") in ("serving_request", "generate") \
                and record.get("replica_id") \
                and status in ("cancelled", "shed", "timeout"):
            # a FLEET-managed engine's transient-shaped failure: the
            # router may transparently re-route it (drain casualty,
            # open-breaker shed, queue lapse), so the caller-visible
            # outcome of that request is a SEPARATE record — an ok
            # trace on the survivor, or a `fleet_request`/
            # `fleet_generate` record when the router surfaced the
            # failure. Counting the replica-internal record too would
            # burn budget for requests whose callers saw success
            # (measured live: a drained-and-re-routed batch
            # double-burned the error budget; a generation stream a
            # FleetTokenStream restarts from its prompt is the same
            # shape — its replica emits a cancelled `generate` record
            # while the caller receives every token).
            # Standalone engines (no replica_id) have no router hiding
            # failures, so their records all still count; permanent
            # engine errors (status="error") always surface unchanged
            # and count exactly once from the engine record.
            return
        latency = record.get("latency_ms")
        # a sampled serving stream (engine trace_sample=N) emits 1-in-N
        # ok records carrying sample_weight=N but EVERY failure at
        # weight 1 — honoring the weight keeps the bad fraction honest
        # (ignoring it would inflate burn rates ~N-fold on a healthy
        # service). Capped defensively: a corrupt weight must not spin.
        w = record.get("sample_weight")
        w = min(int(w), 100_000) if isinstance(w, int) and w > 1 else 1
        for s in self.slos:
            if s.kind == "latency":
                if status == "shed":
                    continue  # shed before a forward: error SLO's domain
                good = status == "ok" and isinstance(
                    latency, (int, float)) and latency <= s.threshold_ms
                for _ in range(w):
                    self._series[s.name].add(t, good)
            elif s.kind == "error_rate":
                for _ in range(w):
                    self._series[s.name].add(t, status == "ok")
        # a completed request is recovery proof for an open SERVING
        # worker loss (role=serving on the worker_lost event, stamped by
        # the fleet's registry metadata): fleet streams carry trace
        # records, not steps, and "requests flow again" is exactly what
        # a serving MTTR measures. The role gate keeps a co-located
        # stream honest both ways — an unrelated serving request must
        # not "recover" a dead TRAINING worker (and vice versa below)
        if self._pending_loss_t is not None and status == "ok" \
                and self._pending_loss_role == "serving":
            dt = t - self._pending_loss_t
            for s in self.slos:
                if s.kind == "mttr":
                    self._series[s.name].add(t, dt <= s.max_s)
            self._pending_loss_t = None
            self._pending_loss_role = None

    def _ingest_step(self, record: Dict, t: float):
        mfu = record.get("mfu")
        for s in self.slos:
            if s.kind == "mfu" and isinstance(mfu, (int, float)):
                self._series[s.name].add(t, mfu >= s.floor)
        if self._pending_loss_t is not None \
                and self._pending_loss_role != "serving":
            # a training step cannot prove a SERVING worker recovered
            dt = t - self._pending_loss_t
            for s in self.slos:
                if s.kind == "mttr":
                    self._series[s.name].add(t, dt <= s.max_s)
            self._pending_loss_t = None
            self._pending_loss_role = None

    def finalize(self):
        """End-of-stream accounting (replay mode): a worker loss with NO
        subsequent step record is an unrecovered outage — count it bad
        against every mttr objective."""
        with self._lock:
            if self._pending_loss_t is None:
                return
            t = self._now if self._now is not None \
                else self._pending_loss_t
            for s in self.slos:
                if s.kind == "mttr":
                    self._series[s.name].add(t, False)
            self._pending_loss_t = None
            self._pending_loss_role = None
            transitions = self._evaluate(t)
        for rec in transitions:
            self._emit_own(rec)

    # ------------------------------------------------------------ evaluate
    @staticmethod
    def _burn(good: int, bad: int, budget: float) -> Optional[float]:
        n = good + bad
        if n == 0:
            return None
        return (bad / n) / budget

    def _evaluate(self, now: float) -> List[Dict]:
        """Re-run the multi-window rule per SLO; returns the alert records
        for fresh breaches (and recovery `slo_status` is handled by the
        caller's status emission)."""
        transitions = []
        for s in self.slos:
            series = self._series[s.name]
            series.prune(now)
            alerting = False
            detail = None
            for short_s, long_s, factor in s.windows:
                long_good, long_bad = series.window(now, long_s)
                if long_good + long_bad < s.min_samples:
                    continue  # too little evidence to page on
                b_short = self._burn(*series.window(now, short_s),
                                     s.budget)
                b_long = self._burn(long_good, long_bad, s.budget)
                if b_short is not None and b_long is not None and \
                        b_short >= factor and b_long >= factor:
                    alerting = True
                    detail = (short_s, long_s, factor, b_short, b_long)
                    break
            was = self._alerting[s.name]
            self._alerting[s.name] = alerting
            if alerting and not was:
                short_s, long_s, factor, b_short, b_long = detail
                self._alerts_fired[s.name] += 1
                transitions.append({
                    "type": "alert", "slo": s.name, "kind": s.kind,
                    "severity": "page",
                    "burn_rate_short": round(b_short, 3),
                    "burn_rate_long": round(b_long, 3),
                    "short_window_s": short_s, "long_window_s": long_s,
                    "factor": factor,
                    "message": (
                        f"SLO {s.name} burning its error budget "
                        f"{b_short:.1f}x over {short_s:.0f}s and "
                        f"{b_long:.1f}x over {long_s:.0f}s "
                        f"(alert factor {factor}x)"),
                })
                logger.warning("SLO ALERT: %s", transitions[-1]["message"])
        return transitions

    # ------------------------------------------------------------ surface
    def _status_unlocked(self, now: Optional[float]) -> List[Dict]:
        out = []
        for s in self.slos:
            series = self._series[s.name]
            longest = max(long for _, long, _f in s.windows)
            if now is None:
                good = bad = 0
            else:
                good, bad = series.window(now, longest)
            n = good + bad
            compliance = good / n if n else None
            burn = self._burn(good, bad, s.budget)
            # budget remaining over the longest window: 1 = untouched,
            # 0 = spent exactly, negative = overspent
            remaining = 1.0 - burn if burn is not None else None
            shortest = min(short for short, _l, _f in s.windows)
            b_short = self._burn(*series.window(now, shortest), s.budget) \
                if now is not None else None
            out.append({
                "slo": s.name, "kind": s.kind, "objective": s.objective,
                "good": good, "bad": bad,
                "compliance": round(compliance, 6)
                if compliance is not None else None,
                "burn_rate": round(b_short, 3)
                if b_short is not None else None,
                "error_budget_remaining": round(remaining, 4)
                if remaining is not None else None,
                "window_s": longest,
                "alerting": self._alerting[s.name],
                "alerts_fired": self._alerts_fired[s.name],
            })
        return out

    def status(self) -> List[Dict]:
        """Current per-SLO evaluation (same fields as `slo_status`
        records), against the newest record time seen."""
        with self._lock:
            return self._status_unlocked(self._now)

    def violated(self) -> List[str]:
        """Names of objectives out of budget — alerting now, budget
        overspent in the long window, or (mttr) an unrecovered loss.
        The `metrics_cli slo --check` CI gate fails on a non-empty
        list."""
        out = []
        for s in self.status():
            rem = s["error_budget_remaining"]
            if s["alerting"] or s["alerts_fired"] or (
                    rem is not None and rem <= 0):
                out.append(s["slo"])
        return out

    def close(self):
        self.finalize()
