"""Operator CLI over a recorded telemetry JSONL stream (counterpart of
`bigdl_tpu/tools/metrics_cli.py`: the same subcommands, tables and exit
codes).

    python -m bigdl_tpu_torch.tools.metrics_cli slo --check run.jsonl

Four subcommands, all reading the strict JSONL a `JsonlSink` wrote
(bench `--telemetry` / `--attribution` runs, or any
`Telemetry(JsonlSink(...))` run):

- `report <run.jsonl>` — the performance-attribution tables the MFU push
  needs: run header, step summary with MFU trend, host-vs-device phase
  breakdown, top compile costs, event counts.
- `trace <trace_id> <run.jsonl>` — one request's critical-path tree from
  its `trace` record (phase timings + shares); prefixes match, so the
  short id an operator copied off a log line works.
- `slo [--check] [knobs] <run.jsonl>` — replay the stream through the
  SAME `SloEngine` the live monitor runs (observability/slo.py) and
  print the per-objective table; `--check` exits 1 when any objective is
  out of budget (alert fired, budget overspent, or an unrecovered worker
  loss) — the CI gate of a chaos run (`chip_smoke.py` phase 22 runs
  it on the serving fleet's stream).
- `diff <a.jsonl> <b.jsonl>` — compare two streams under the SLO-replay
  invariance contract (`bigdl_tpu_torch.workload.diff`): outcome tallies,
  slo_status trajectory, chaos trail, replay summary; exit 1 with a
  first-divergence pointer when they disagree — the replay-invariance
  CI gate.

Exit codes: 0 = output printed and (with --check) every objective inside
budget; 1 = --check found a violated objective; 2 = unreadable/empty
stream or bad usage — always with a one-line diagnostic, never a
traceback.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, TextIO


def _raise_constant(tok):  # json parse_constant hook
    raise ValueError(f"non-strict JSON token {tok!r}")


def load_records(path: str) -> List[Dict]:
    """Parse one strict-JSON record per line; raises on NaN/Infinity
    tokens (the JsonlSink contract says they cannot appear) and on lines
    that are valid JSON but not objects (a record stream holds dicts —
    anything else would crash every consumer downstream)."""
    records = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line, parse_constant=_raise_constant)
            except ValueError as e:
                raise ValueError(f"{path}:{i}: {e}") from None
            if not isinstance(rec, dict):
                raise ValueError(
                    f"{path}:{i}: not a JSON object "
                    f"({type(rec).__name__})")
            records.append(rec)
    return records


def _mean(xs: List[float]) -> Optional[float]:
    xs = [x for x in xs if isinstance(x, (int, float))]
    return sum(xs) / len(xs) if xs else None


def _fmt(x, unit="", digits=3) -> str:
    if x is None:
        return "-"
    if isinstance(x, float):
        if abs(x) >= 1e15 or (abs(x) < 1e-3 and x != 0):
            return f"{x:.3e}{unit}"
        x = round(x, digits)
    return f"{x}{unit}"


def report(path: str, out: TextIO = None) -> int:
    """Print the attribution report for one run's JSONL; returns the
    process exit code (0 = report printed)."""
    out = out or sys.stdout
    try:
        records = load_records(path)
    except (OSError, ValueError) as e:
        print(f"metrics_cli: cannot read {path}: {e}", file=sys.stderr)
        return 2
    if not records:
        print(f"metrics_cli: {path} holds no records", file=sys.stderr)
        return 2
    if all(r.get("type") in ("run_start", None) for r in records):
        # header-only stream: a run that died before its first step (or a
        # stream from the wrong file) — nothing to tabulate
        print(f"metrics_cli: {path} holds only run_start/untyped records "
              "(no steps, compiles, serving snapshots, or events) — "
              "nothing to report", file=sys.stderr)
        return 2

    w = out.write
    start = next((r for r in records if r.get("type") == "run_start"), {})
    end = next((r for r in reversed(records)
                if r.get("type") == "run_end"), {})
    steps = [r for r in records if r.get("type") == "step"]
    compiles = [r for r in records if r.get("type") == "compile"]
    serving = [r for r in records
               if r.get("type") in ("serving_stats", "serving_summary")]
    events = [r for r in records if r.get("type") == "event"]

    w(f"== run: {path} ==\n")
    if start:
        w("  " + "  ".join(
            f"{k}={start[k]}" for k in ("loop", "model", "optim_method",
                                        "backend", "n_devices",
                                        "sync_interval") if k in start)
          + "\n")

    if steps:
        half = max(1, len(steps) // 2)
        w(f"\n-- steps ({len(steps)} sync points, "
          f"final step {steps[-1].get('step')}) --\n")
        rows = [
            ("throughput (rec/s)", [s.get("throughput") for s in steps]),
            ("step_time_s", [s.get("step_time_s") for s in steps]),
            ("flops_per_step", [s.get("flops_per_step") for s in steps]),
            ("bytes_accessed", [s.get("bytes_accessed") for s in steps]),
            ("mfu", [s.get("mfu") for s in steps]),
        ]
        w(f"  {'metric':<20} {'mean':>12} {'first-half':>12} "
          f"{'second-half':>12}\n")
        for name, vals in rows:
            w(f"  {name:<20} {_fmt(_mean(vals)):>12} "
              f"{_fmt(_mean(vals[:half])):>12} "
              f"{_fmt(_mean(vals[half:])):>12}\n")

    metrics = end.get("metrics") or {}
    if metrics:
        w("\n-- host vs device phase table (seconds, per occurrence) --\n")
        w(f"  {'phase':<28} {'mean':>10} {'total':>10} {'count':>7}\n")
        for name, m in sorted(metrics.items(),
                              key=lambda kv: -(kv[1].get("total") or 0)):
            w(f"  {name:<28} {_fmt(m.get('mean'), digits=6):>10} "
              f"{_fmt(m.get('total'), digits=3):>10} "
              f"{m.get('count', 0):>7}\n")

    if compiles:
        total = sum(c.get("compile_s") or 0 for c in compiles)
        hits = sum(1 for c in compiles if c.get("cache_hit"))
        w(f"\n-- compiles ({len(compiles)} signatures, "
          f"{_fmt(total)}s backend compile, {hits} cache hits) --\n")
        w(f"  {'label':<30} {'compile_s':>10} {'lower_s':>9} "
          f"{'eqns':>6} {'hit':>4}  signature\n")
        for c in sorted(compiles,
                        key=lambda c: -(c.get("compile_s") or 0))[:10]:
            w(f"  {c.get('label', '?'):<30} "
              f"{_fmt(c.get('compile_s')):>10} "
              f"{_fmt(c.get('lower_s')):>9} "
              f"{_fmt(c.get('jaxpr_eqns'), digits=0):>6} "
              f"{'y' if c.get('cache_hit') else 'n':>4}  "
              f"{c.get('signature', '')[:48]}\n")

    if serving:
        s = serving[-1]
        w(f"\n-- serving (last of {len(serving)} snapshots) --\n")
        for k in ("submitted", "completed", "failed", "timed_out", "shed",
                  "batches", "bucket_hit_rate", "pad_fraction",
                  "latency_ms_p50", "latency_ms_p99", "flops_per_step",
                  "mfu"):
            if k in s:
                w(f"  {k:<20} {_fmt(s[k])}\n")

    if events:
        counts: Dict[str, int] = {}
        for e in events:
            counts[e.get("event", "?")] = counts.get(e.get("event", "?"),
                                                     0) + 1
        w("\n-- events --\n")
        for kind, n in sorted(counts.items()):
            w(f"  {kind:<24} {n}\n")
    w("\n")
    return 0


def lint_stream(paths: List[str], out: TextIO = None) -> int:
    """`report --lint-stream`: run `validate_record` (the runtime twin of
    the `telemetry` static checker) over every record of the stream(s);
    exit 2 at the FIRST violation with a `path:line:` diagnostic — a
    telemetry stream is a contract surface, and one malformed record
    means the producer is broken, not the line."""
    out = out or sys.stdout
    from bigdl_tpu_torch.observability.telemetry import validate_record
    total = 0
    for path in paths:
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError as e:
            print(f"metrics_cli: cannot read {path}: {e}",
                  file=sys.stderr)
            return 2
        for i, line in enumerate(lines, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line, parse_constant=_raise_constant)
                if not isinstance(rec, dict):
                    raise ValueError(
                        f"not a JSON object ({type(rec).__name__})")
                validate_record(rec)
            except ValueError as e:
                print(f"metrics_cli: {path}:{i}: {e}", file=sys.stderr)
                return 2
            total += 1
    if total == 0:
        print(f"metrics_cli: {', '.join(paths)} hold(s) no records",
              file=sys.stderr)
        return 2
    out.write(f"lint-stream: {total} record"
              f"{'s' if total != 1 else ''} conform to RECORD_SCHEMAS\n")
    return 0


def trace(trace_id: str, paths: List[str], out: TextIO = None) -> int:
    """Print the critical-path tree of the `trace` record(s) whose
    trace_id starts with `trace_id` (operators copy short prefixes);
    returns the process exit code."""
    out = out or sys.stdout
    w = out.write
    found = 0
    for path in paths:
        try:
            records = load_records(path)
        except (OSError, ValueError) as e:
            print(f"metrics_cli: cannot read {path}: {e}",
                  file=sys.stderr)
            return 2
        for r in records:
            if r.get("type") != "trace" or \
                    not str(r.get("trace_id", "")).startswith(trace_id):
                continue
            found += 1
            w(f"trace {r['trace_id']}  [{r.get('kind', '?')}]  "
              f"status={r.get('status', '?')}")
            if r.get("bucket") is not None:
                w(f"  bucket={r['bucket']} batch={r.get('batch', '?')}")
            w("\n")
            total = r.get("latency_ms")
            w(f"└─ request {'':<18}{_fmt(total, ' ms')}\n")
            path_items = r.get("critical_path") or []
            for i, p in enumerate(path_items):
                last = i == len(path_items) - 1
                branch = "└─" if last else "├─"
                frac = p.get("frac")
                bar = "#" * int(round((frac or 0) * 20))
                w(f"   {branch} {p.get('name', '?'):<12} "
                  f"{_fmt(p.get('ms'), ' ms'):>12}  "
                  f"{_fmt(round(frac * 100, 1) if frac is not None else None, '%'):>7}  {bar}\n")
            if r.get("error"):
                w(f"   error: {r['error']}\n")
    if not found:
        print(f"metrics_cli: no trace record matching {trace_id!r} in "
              f"{', '.join(paths)}", file=sys.stderr)
        return 2
    return 0


def slo(paths: List[str], check: bool = False,
        latency_p99_ms: float = 100.0, error_objective: float = 0.999,
        mfu_floor: Optional[float] = None, mttr_s: float = 60.0,
        out: TextIO = None) -> int:
    """Replay recorded streams through the live `SloEngine` and print the
    per-objective table; with `check`, exit 1 when any objective is out
    of budget. Returns the process exit code."""
    out = out or sys.stdout
    from bigdl_tpu_torch.observability.slo import SloEngine, default_slos
    engine = SloEngine(default_slos(
        latency_p99_ms=latency_p99_ms, error_objective=error_objective,
        mfu_floor=mfu_floor, mttr_s=mttr_s))
    total = 0
    for path in paths:
        try:
            records = load_records(path)
        except (OSError, ValueError) as e:
            print(f"metrics_cli: cannot read {path}: {e}",
                  file=sys.stderr)
            return 2
        total += len(records)
        for r in records:
            engine.emit(r)
    if total == 0:
        print(f"metrics_cli: {', '.join(paths)} hold(s) no records",
              file=sys.stderr)
        return 2
    engine.finalize()
    if all(s["good"] + s["bad"] == 0 for s in engine.status()):
        # header-only / wrong-file stream: every objective evaluated to
        # "no data" — a gate that silently passes on that would approve
        # a run that died before its first step
        print(f"metrics_cli: {', '.join(paths)} produced no SLO samples "
              "(no trace/step/worker_lost records) — nothing to "
              "evaluate", file=sys.stderr)
        return 2
    w = out.write
    w(f"== slo: {', '.join(paths)} ==\n")
    w(f"  {'objective':<22} {'kind':<10} {'good':>7} {'bad':>6} "
      f"{'compliance':>11} {'budget left':>12} {'burn':>8}  state\n")
    for s in engine.status():
        state = "ALERT" if (s["alerting"] or s["alerts_fired"]) else \
            ("no data" if s["good"] + s["bad"] == 0 else "ok")
        w(f"  {s['slo']:<22} {s['kind']:<10} {s['good']:>7} {s['bad']:>6} "
          f"{_fmt(s['compliance']):>11} "
          f"{_fmt(s['error_budget_remaining']):>12} "
          f"{_fmt(s['burn_rate']):>8}  {state}\n")
    violated = engine.violated()
    if violated:
        w(f"  VIOLATED: {', '.join(violated)}\n")
    if check:
        return 1 if violated else 0
    return 0


def diff(path_a: str, path_b: str, out: TextIO = None) -> int:
    """Compare two record streams under the SLO-replay invariance
    contract (bigdl_tpu_torch.workload.diff): outcome tallies by
    (kind, status), the ordered `slo_status` trajectory with burn
    rates, the chaos-action trail, replay progress, and the
    `replay_summary` fingerprints. Exit 0 identical / 1 divergent
    (first-divergence pointer printed) / 2 malformed. Works on any two
    streams — two replays for the CI gate, or two live `slo --check`'d
    runs side by side."""
    out = out or sys.stdout
    from bigdl_tpu_torch.workload.diff import compare_streams
    streams = []
    for path in (path_a, path_b):
        try:
            streams.append(load_records(path))
        except (OSError, ValueError) as e:
            print(f"metrics_cli: cannot read {path}: {e}",
                  file=sys.stderr)
            return 2
        if not streams[-1]:
            print(f"metrics_cli: {path} holds no records",
                  file=sys.stderr)
            return 2
    result = compare_streams(streams[0], streams[1])
    w = out.write
    w(f"== diff: {path_a} vs {path_b} ==\n")
    if not result.divergent:
        w("  identical under the invariance contract (outcome tallies, "
          "slo_status trajectory, chaos trail, replay summary)\n")
        return 0
    w(f"  DIVERGENT ({len(result.details)} "
      f"difference{'s' if len(result.details) != 1 else ''})\n")
    w(f"  first divergence: {result.first}\n")
    for d in result.details[1:]:
        w(f"    {d}\n")
    return 1


_USAGE = """\
usage: python -m bigdl_tpu_torch.tools.metrics_cli <command> ...
  report [--lint-stream] <run.jsonl> [...] attribution tables; with
                                           --lint-stream, validate every
                                           record against RECORD_SCHEMAS
                                           instead (exit 2 on first
                                           violation)
  trace  <trace_id> <run.jsonl> [...]      one request's critical path
  slo    [--check] [--latency-p99-ms N] [--error-objective F]
         [--mfu-floor F] [--mttr-s N] <run.jsonl> [...]
                                           SLO replay / CI gate
  diff   <a.jsonl> <b.jsonl>               compare two streams under the
                                           SLO-replay invariance
                                           contract; exit 0 identical /
                                           1 divergent (with a first-
                                           divergence pointer) /
                                           2 malformed\
"""


def main(argv=None) -> int:
    """CLI entry; see `_USAGE`."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("-h", "--help"):
        print(_USAGE, file=sys.stderr)
        return 0
    if not argv or argv[0] not in ("report", "trace", "slo", "diff"):
        print(_USAGE, file=sys.stderr)
        return 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "diff":
        if len(rest) != 2:
            print(_USAGE, file=sys.stderr)
            return 2
        return diff(rest[0], rest[1])
    if cmd == "report":
        do_lint = "--lint-stream" in rest
        rest = [a for a in rest if a != "--lint-stream"]
        if not rest:
            print(_USAGE, file=sys.stderr)
            return 2
        if do_lint:
            return lint_stream(rest)
        rc = 0
        for path in rest:
            rc = max(rc, report(path))
        return rc
    if cmd == "trace":
        if len(rest) < 2:
            print(_USAGE, file=sys.stderr)
            return 2
        return trace(rest[0], rest[1:])
    # slo
    kw: Dict = {}
    paths: List[str] = []
    flags = {"--latency-p99-ms": ("latency_p99_ms", float),
             "--error-objective": ("error_objective", float),
             "--mfu-floor": ("mfu_floor", float),
             "--mttr-s": ("mttr_s", float)}
    i = 0
    while i < len(rest):
        a = rest[i]
        if a == "--check":
            kw["check"] = True
        elif a in flags:
            name, conv = flags[a]
            if i + 1 >= len(rest):
                print(f"metrics_cli: {a} needs a value", file=sys.stderr)
                return 2
            try:
                kw[name] = conv(rest[i + 1])
            except ValueError:
                print(f"metrics_cli: bad value for {a}: {rest[i + 1]!r}",
                      file=sys.stderr)
                return 2
            i += 1
        elif a.startswith("-"):
            print(f"metrics_cli: unknown flag {a}", file=sys.stderr)
            return 2
        else:
            paths.append(a)
        i += 1
    if not paths:
        print(_USAGE, file=sys.stderr)
        return 2
    return slo(paths, **kw)


if __name__ == "__main__":
    raise SystemExit(main())
