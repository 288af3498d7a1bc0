"""Metrics export: Prometheus text exposition over the telemetry stream
(counterpart of `bigdl_tpu/observability/export.py`: for the same records
and the same tracked engines' `health()`, `render()` gives the same text,
the `bigdl_tpu_` namespace and the help strings included).

The serving-fleet roadmap item needs SLOs an external monitor can actually
scrape; JSONL files and in-memory sinks are run artifacts, not a metrics
surface. `PrometheusTextSink` is a `TelemetrySink` that folds the stream
into current values — step gauges from the newest `step` record, serving
counters/quantiles from the newest `serving_stats`/`serving_summary`, and
per-bucket circuit-breaker states read live from `engine.health()` — and
renders them in the Prometheus text exposition format (version 0.0.4:
`# HELP` / `# TYPE` headers plus samples). `MetricsServer` exposes that
render at `GET /metrics` on a stdlib `http.server` — no new dependencies,
one non-daemon thread, `close()` joins it (the same thread-hygiene
contract the serving dispatcher and prefetch workers are held to by the
suite's leak fixture).

    sink = PrometheusTextSink()
    opt.set_telemetry(Telemetry(sink))
    server = MetricsServer(sink, port=9100)   # or port=0 -> ephemeral
    ...
    server.close()
"""

from __future__ import annotations

import logging
import math
import threading
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from bigdl_tpu_torch.observability.telemetry import TelemetrySink

logger = logging.getLogger("bigdl_tpu_torch.observability")

#: serving stats() counter fields exported as Prometheus counters.
_SERVING_COUNTERS = ("submitted", "completed", "failed", "timed_out",
                     "rejected", "cancelled", "shed", "batches",
                     "bucket_hits", "rows", "padded_rows")
#: serving stats() instantaneous fields exported as gauges.
_SERVING_GAUGES = ("queue_depth", "bucket_hit_rate", "pad_fraction",
                   "flops_per_step", "bytes_accessed", "mfu")
#: histogram prefixes exported as Prometheus summaries (quantile labels).
_SERVING_SUMMARIES = ("queue_wait_ms", "latency_ms", "batch_size")

_BREAKER_STATE_VALUE = {"closed": 0, "half_open": 1, "open": 2}


def _fmt(value) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, float):
        if math.isnan(value):
            return "NaN"
        if math.isinf(value):
            return "+Inf" if value > 0 else "-Inf"
        return repr(value)
    return str(value)


def _escape_label(value: str) -> str:
    return str(value).replace("\\", r"\\").replace("\n", r"\n") \
        .replace('"', r'\"')


class PrometheusTextSink(TelemetrySink):
    """Fold telemetry records into scrapable current values.

    Attach to a `Telemetry` like any sink; `render()` returns the full
    exposition document. Serving engines registered via `track_engine`
    contribute live per-bucket breaker-state gauges (from
    `engine.health()`) at render time — breaker transitions are events,
    but a scrape wants *state*. Engines are held weakly: a closed,
    dropped engine disappears from the exposition instead of pinning
    itself in memory."""

    #: membership/elastic events whose newest occurrence drives the
    #: fleet-capacity gauges (`degraded_capacity`, `workers_alive`, ...).
    _FLEET_EVENTS = ("worker_lost", "worker_joined", "worker_left",
                     "elastic_shrink", "elastic_grow", "elastic_rebuild")

    def __init__(self, namespace: str = "bigdl_tpu"):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._step: Dict = {}
        self._serving: Dict = {}
        self._generation: Dict = {}  # newest generation record
        self._fleet: Dict = {}  # newest membership/elastic event
        self._serving_fleet: Dict = {}  # newest serving_fleet record
        self._slo: Dict[str, Dict] = {}  # newest slo_status per objective
        self._alerts: Dict[str, int] = {}  # alert records seen per slo
        self._replay: Dict = {}  # newest workload_replay heartbeat
        self._replay_summary: Dict = {}  # newest replay_summary
        self._counts: Dict[str, int] = {}  # records seen by type
        self._engines: List = []  # (label, weakref) pairs

    # ------------------------------------------------------------ ingest
    def emit(self, record: Dict):
        rtype = record.get("type")
        with self._lock:
            self._counts[rtype] = self._counts.get(rtype, 0) + 1
            if rtype == "step":
                self._step = dict(record)
            elif rtype in ("serving_stats", "serving_summary"):
                self._serving = dict(record)
            elif rtype == "generation":
                self._generation = dict(record)
            elif rtype == "serving_fleet":
                self._serving_fleet = dict(record)
            elif rtype == "workload_replay":
                self._replay = dict(record)
            elif rtype == "replay_summary":
                self._replay_summary = dict(record)
            elif rtype == "slo_status" and record.get("slo"):
                self._slo[record["slo"]] = dict(record)
            elif rtype == "alert" and record.get("slo"):
                self._alerts[record["slo"]] = \
                    self._alerts.get(record["slo"], 0) + 1
            elif rtype == "event" and \
                    record.get("event") in self._FLEET_EVENTS:
                # MERGE, don't replace: worker_* events carry alive/total
                # while elastic_* carry n_active/alive_workers — a
                # wholesale swap would flap series in and out of the
                # exposition (Prometheus reads that as staleness)
                self._fleet.update(record)

    def track_engine(self, engine,
                     name: Optional[str] = None) -> "PrometheusTextSink":
        """Include `engine.health()`'s breaker/queue state in every
        render (weakly referenced). `name` becomes the `engine` label on
        its samples — defaulting to `engine<N>` so two tracked engines
        sharing a bucket shape never emit duplicate label sets (which a
        Prometheus scraper rejects wholesale)."""
        with self._lock:
            if name is None:
                name = f"engine{len(self._engines)}"
            self._engines.append((name, weakref.ref(engine)))
        return self

    # ------------------------------------------------------------ render
    def _sample(self, lines, name, mtype, help_, samples):
        """Append one metric family: HELP/TYPE headers + (labels, value)
        samples; families with no finite samples are skipped entirely."""
        rows = []
        for labels, value in samples:
            if value is None or (isinstance(value, float)
                                 and not math.isfinite(value)):
                continue
            rows.append((labels, value))
        if not rows:
            return
        full = f"{self.namespace}_{name}"
        lines.append(f"# HELP {full} {help_}")
        lines.append(f"# TYPE {full} {mtype}")
        for labels, value in rows:
            label_s = ""
            if labels:
                inner = ",".join(f'{k}="{_escape_label(v)}"'
                                 for k, v in labels.items())
                label_s = "{" + inner + "}"
            lines.append(f"{full}{label_s} {_fmt(value)}")

    def render(self) -> str:
        """The Prometheus text exposition document (text/plain;
        version=0.0.4). Always ends with a newline."""
        with self._lock:
            step = dict(self._step)
            serving = dict(self._serving)
            generation = dict(self._generation)
            serving_fleet = dict(self._serving_fleet)
            fleet = dict(self._fleet)
            slo = {k: dict(v) for k, v in self._slo.items()}
            alerts = dict(self._alerts)
            replay = dict(self._replay)
            replay_summary = dict(self._replay_summary)
            counts = dict(self._counts)
            engines = list(self._engines)
        lines: List[str] = []
        self._sample(lines, "telemetry_records_total", "counter",
                     "Telemetry records ingested by this exporter.",
                     [({"record_type": t}, n)
                      for t, n in sorted(counts.items()) if t])
        # --- step gauges: numeric fields of the newest step record (the
        # help strings are the reference's, word for word, so that both
        # packages' scrapes of one stream are the same text; the port's
        # FLOPs come from `costs.count_flops`, not a compiler's model)
        for field, help_ in (
                ("step", "Latest training iteration number."),
                ("epoch", "Current training epoch (1-based)."),
                ("loss", "Latest synced training loss."),
                ("lr", "Current learning rate."),
                ("throughput", "Training records/sec over the last sync "
                               "window."),
                ("step_time_s", "Per-iteration wall time over the last "
                                "sync window (seconds)."),
                ("flops_per_step", "Model FLOPs per training step (XLA "
                                   "cost model)."),
                ("bytes_accessed", "Bytes accessed per training step (XLA "
                                   "cost model)."),
                ("mfu", "Model FLOPs utilization of the training step "
                        "against registry peak."),
                ("grad_norm", "Global gradient L2 norm."),
                ("param_norm", "Global parameter L2 norm."),
                ("host_rss_mb", "Driver process resident set size (MB)."),
                ("prefetch_queue_depth", "Ready batches in the input "
                                         "pipeline buffer."),
        ):
            val = step.get(field)
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                continue
            self._sample(lines, f"step_{field}", "gauge", help_,
                         [(None, val)])
        # --- fleet capacity: from the newest membership/elastic event,
        # so a scrape sees a shrunken fleet the moment training degrades
        # (0.0 = full capacity, 0.5 = half the devices lost)
        if "alive" not in fleet and "alive_workers" in fleet:
            fleet["alive"] = fleet["alive_workers"]  # elastic_* spelling
        for field, name, help_ in (
                ("degraded_capacity", "degraded_capacity",
                 "Fraction of registered training device capacity "
                 "currently lost (0 = full fleet)."),
                ("alive", "workers_alive",
                 "Worker-registry members currently alive."),
                ("total", "workers_total",
                 "Worker-registry members registered."),
                ("n_active", "elastic_active_devices",
                 "Devices the elastic training loop is running on."),
        ):
            val = fleet.get(field)
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                self._sample(lines, name, "gauge", help_, [(None, val)])
        # --- serving counters / gauges / summaries
        for field in _SERVING_COUNTERS:
            val = serving.get(field)
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                self._sample(lines, f"serving_{field}_total", "counter",
                             f"Serving engine lifetime {field} count.",
                             [(None, val)])
        for field in _SERVING_GAUGES:
            val = serving.get(field)
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                self._sample(lines, f"serving_{field}", "gauge",
                             f"Serving engine {field}.", [(None, val)])
        for pre in _SERVING_SUMMARIES:
            samples = []
            for q in (50, 95, 99):
                val = serving.get(f"{pre}_p{q}")
                if isinstance(val, (int, float)):
                    samples.append(({"quantile": f"0.{q}"}, val))
            count = serving.get(f"{pre}_count")
            if samples:
                self._sample(lines, f"serving_{pre}", "summary",
                             f"Serving {pre} over the recent window.",
                             samples)
                if isinstance(count, int):
                    lines.append(
                        f"{self.namespace}_serving_{pre}_count {count}")
        # --- generation: the newest generation record (continuous-
        # batching decode loop, serving/generation.py) — token
        # throughput and decode-slot occupancy are THE capacity signals
        # for the autoregressive tier
        for field, name, mtype, help_ in (
                ("tokens_per_sec", "serving_tokens_per_sec", "gauge",
                 "Aggregate generated tokens/sec (engine lifetime, idle "
                 "time included)."),
                ("decode_occupancy", "serving_decode_occupancy", "gauge",
                 "Mean active-slot fraction of the continuous-batching "
                 "decode step."),
                ("active_slots", "serving_decode_active_slots", "gauge",
                 "Decode slots currently holding a live stream."),
                ("slots", "serving_decode_slots", "gauge",
                 "Decode slots (fixed batch width of the decode "
                 "executable)."),
                ("tokens_total", "serving_tokens_total", "counter",
                 "Tokens generated over the engine lifetime."),
                ("slot_joins", "serving_slot_joins_total", "counter",
                 "Requests that joined a decode slot (slot churn, "
                 "join side)."),
                ("slot_leaves", "serving_slot_leaves_total", "counter",
                 "Requests that left a decode slot (slot churn, leave "
                 "side)."),
        ):
            val = generation.get(field)
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                self._sample(lines, name, mtype, help_, [(None, val)])
        # --- serving fleet: the newest serving_fleet record
        # (serving/fleet.py emits one per membership change / maintain
        # tick), so a scrape sees replica loss, drains, and re-routes
        # the moment the fleet does
        for field, mtype, help_ in (
                ("replicas_alive", "gauge",
                 "Serving replicas currently in rotation."),
                ("replicas_draining", "gauge",
                 "Serving replicas draining (lease missed / scaling "
                 "down)."),
                ("replicas_total", "gauge",
                 "Serving replicas tracked by the fleet (any state)."),
                ("reroutes_total", "counter",
                 "Requests re-routed off a lost/drained replica."),
                ("reroute_failed_total", "counter",
                 "Re-route attempts that found no healthy replica."),
                ("routed_total", "counter",
                 "Requests dispatched by the fleet router."),
                ("drains_total", "counter",
                 "Replica drains (crash, lease expiry, or injected)."),
                ("scale_ups_total", "counter",
                 "Autoscale scale-up events."),
                ("scale_downs_total", "counter",
                 "Autoscale scale-down events."),
                ("generations_total", "counter",
                 "Generation streams routed by the fleet."),
                ("stream_reroutes_total", "counter",
                 "Generation streams restarted from their prompt on a "
                 "survivor after replica loss."),
        ):
            val = serving_fleet.get(field)
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                self._sample(lines, f"serving_fleet_{field}", mtype,
                             help_, [(None, val)])
        depths = serving_fleet.get("replica_queue_depth")
        if isinstance(depths, dict):
            self._sample(
                lines, "serving_fleet_replica_queue_depth", "gauge",
                "Queued requests per serving replica.",
                [({"replica": rid}, d) for rid, d in sorted(depths.items())
                 if isinstance(d, (int, float))
                 and not isinstance(d, bool)])
        # --- SLO surface: newest slo_status per objective + alert counts
        for field, name, mtype, help_ in (
                ("burn_rate", "slo_burn_rate", "gauge",
                 "Error-budget burn rate over the objective's shortest "
                 "window (1 = spending exactly the budget)."),
                ("error_budget_remaining", "slo_error_budget_remaining",
                 "gauge",
                 "Fraction of the objective's error budget left over its "
                 "longest window (negative = overspent)."),
                ("compliance", "slo_compliance", "gauge",
                 "Good-sample fraction over the objective's longest "
                 "window."),
                ("alerting", "slo_alerting", "gauge",
                 "1 while the objective's multi-window burn-rate alert "
                 "is firing."),
        ):
            samples = []
            for sname, rec in sorted(slo.items()):
                val = rec.get(field)
                if isinstance(val, bool):
                    val = int(val)
                if isinstance(val, (int, float)):
                    samples.append(({"slo": sname}, val))
            self._sample(lines, name, mtype, help_, samples)
        self._sample(lines, "slo_alerts_total", "counter",
                     "SLO burn-rate alerts fired.",
                     [({"slo": s}, n) for s, n in sorted(alerts.items())])
        # --- workload replay: progress from the newest heartbeat,
        # verdict from the newest replay_summary (workload/replay.py)
        if replay:
            wlabel = {"workload": str(replay.get("workload", "?"))}
            for field, name, mtype, help_ in (
                    ("entries_total", "workload_replay_entries_total",
                     "gauge", "Entries in the workload being replayed."),
                    ("entries_done", "workload_replay_entries_done",
                     "gauge", "Workload entries replayed so far."),
                    ("chaos_fired", "workload_replay_chaos_fired",
                     "gauge", "Chaos actions fired so far."),
                    ("ok", "workload_replay_ok_total", "counter",
                     "Replayed requests that completed ok."),
                    ("errors", "workload_replay_errors_total", "counter",
                     "Replayed requests that failed."),
                    ("timeouts", "workload_replay_timeouts_total",
                     "counter", "Replayed requests past their deadline."),
                    ("shed", "workload_replay_shed_total", "counter",
                     "Replayed requests shed by backpressure."),
                    ("offset_ms", "workload_replay_offset_ms", "gauge",
                     "Virtual-timeline position of the replay (ms)."),
            ):
                val = replay.get(field)
                if isinstance(val, (int, float)):
                    self._sample(lines, name, mtype, help_,
                                 [(wlabel, val)])
        if replay_summary:
            slabel = {"workload":
                      str(replay_summary.get("workload", "?"))}
            if "seed" in replay_summary:
                slabel["seed"] = str(replay_summary["seed"])
            self._sample(
                lines, "workload_replay_complete", "gauge",
                "1 once a replay finished (labels carry its scenario).",
                [(slabel, 1)])
            div = replay_summary.get("divergent")
            if isinstance(div, bool):
                self._sample(
                    lines, "workload_replay_divergent", "gauge",
                    "1 when the finished replay diverged from its "
                    "baseline stream under the SLO-replay invariance "
                    "contract (0 = invariant).",
                    [(slabel, int(div))])
        # --- live breaker state per tracked engine
        breaker_samples = []
        health_samples = []
        for ename, ref in engines:
            eng = ref()
            if eng is None:
                continue
            try:
                health = eng.health()
            except Exception:
                logger.exception("engine.health() failed during render")
                continue
            health_samples.append(
                ({"engine": ename,
                  "status": health.get("status", "?")}, 1))
            for bucket, snap in sorted(health.get("breakers", {}).items()):
                state = snap.get("state")
                breaker_samples.append(
                    ({"bucket": bucket, "engine": ename},
                     _BREAKER_STATE_VALUE.get(state)))
        self._sample(lines, "serving_engine_up", "gauge",
                     "Tracked serving engine liveness (label: status).",
                     health_samples)
        self._sample(lines, "serving_breaker_state", "gauge",
                     "Per-bucket circuit breaker state "
                     "(0=closed, 1=half_open, 2=open).", breaker_samples)
        return "\n".join(lines) + "\n"


# Servers still open at interpreter exit would hang shutdown on their
# non-daemon serve thread; same backstop policy as the serving engine.
_LIVE_SERVERS: "weakref.WeakSet" = weakref.WeakSet()


def _close_live_servers():
    for srv in list(_LIVE_SERVERS):
        try:
            srv.close()
        except Exception:
            pass


try:
    threading._register_atexit(_close_live_servers)
except AttributeError:  # < 3.9: best effort only
    import atexit
    atexit.register(_close_live_servers)


class MetricsServer:
    """Serve a `PrometheusTextSink` at `GET /metrics` (stdlib only).

    The serve loop runs on one NON-daemon thread — a leaked server is a
    visible failure under the suite's thread-leak fixture, exactly like a
    leaked dispatcher. Request-handler threads are daemonic and
    short-lived. `close()` shuts the listener down and joins the serve
    thread; idempotent; also usable as a context manager.

    `port=0` binds an ephemeral port; read it back from `.port`.
    """

    def __init__(self, sink: PrometheusTextSink, host: str = "127.0.0.1",
                 port: int = 0):
        self.sink = sink
        render = self._render  # late-bound via the server object

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib naming)
                if self.path.split("?", 1)[0] != "/metrics":
                    self.send_error(404, "try /metrics")
                    return
                try:
                    body = render().encode("utf-8")
                except Exception:
                    logger.exception("metrics render failed")
                    self.send_error(500, "metrics render failed")
                    return
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; "
                                 "charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                logger.debug("metrics server: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True  # per-request threads only
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="bigdl-metrics-server", daemon=False)
        self._closed = False
        _LIVE_SERVERS.add(self)
        self._thread.start()

    def _render(self) -> str:
        return self.sink.render()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}/metrics"

    def close(self):
        """Stop serving and join the serve thread. Idempotent."""
        if self._closed:
            return
        self._closed = True
        _LIVE_SERVERS.discard(self)
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not threading.current_thread():
            self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # backstop; callers close() explicitly
        try:
            self.close()
        except Exception:
            pass
