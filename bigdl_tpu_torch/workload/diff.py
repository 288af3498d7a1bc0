"""Replay-stream comparison: the SLO-replay invariance gate's judge
(counterpart of `bigdl_tpu/workload/diff.py`, pure Python, the same
sections, tolerances and pointers).

`compare_streams(a, b)` decides whether two telemetry streams tell the
same story, comparing ONLY what the invariance contract promises to be
deterministic — never wall-clock:

- **config** — the `replay_summary` fingerprints (workload name/hash,
  seed, speed, replica count): a perturbed scenario (different chaos
  seed, different fleet size) diverges HERE first, with a pointer
  naming the knob.
- **chaos** — the ordered `chaos_action` event trail (action, target,
  trigger): same seed must fire the same kills at the same offsets.
- **outcomes** — trace tallies by (kind, status), `sample_weight`
  honored: the caller-visible truth of what the traffic experienced.
- **slo_status** — the ordered (slo, kind, alerting, good, bad) plus
  burn/compliance trajectory: the SLO story, window by window.
- **progress** — the `workload_replay` heartbeat trajectory.

Latency values, record `time` stamps, trace ids, and error text are
deliberately IGNORED — they vary run to run without meaning anything.
`metrics_cli diff` wraps this for the CLI (exit 0 identical /
1 divergent / 2 malformed) and `WorkloadReplayer(baseline=...)` uses
it to stamp `replay_summary.divergent` for the Prometheus gauge.
Standalone streams work too (two `slo --check`'d JSONL files): the
replay-only sections are empty on both sides and compare equal.
"""

import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["DiffResult", "compare_streams", "load_stream"]

_SUMMARY_CONFIG = ("workload", "workload_sha256", "seed", "speed",
                   "replicas", "entries_total")
_SUMMARY_OUTCOME = ("ok", "errors", "timeouts", "shed", "cancelled",
                    "chaos_fired")
_SLO_INT = ("slo", "kind", "alerting", "good", "bad", "alerts_fired")
_SLO_FLOAT = ("objective", "compliance", "burn_rate",
              "error_budget_remaining", "window_s")
_PROGRESS = ("entries_done", "ok", "errors", "timeouts", "shed",
             "chaos_fired")
_CHAOS = ("action", "target", "at_offset_ms", "after_entries", "ok")


class DiffResult:
    """Verdict of one comparison: `divergent`, the `first` divergence
    pointer (section / index / field / both values), and the full
    `details` list (every divergence found, not just the first)."""

    def __init__(self, divergent: bool, first: Optional[str],
                 details: List[str]):
        self.divergent = divergent
        self.first = first
        self.details = details

    def __bool__(self):  # truthy == streams MATCH, for natural ifs
        return not self.divergent

    def __repr__(self):
        return (f"DiffResult(divergent={self.divergent}, "
                f"first={self.first!r})")


def load_stream(path: str) -> List[Dict]:
    """Strict-JSONL record loader (the telemetry convention: bare
    NaN/Infinity tokens and non-object lines are malformed). Raises
    `ValueError` naming `path:line` on the first violation."""
    records = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(
                    line, parse_constant=lambda c: (_ for _ in ()).throw(
                        ValueError(f"non-strict JSON constant {c}")))
            except ValueError as e:
                raise ValueError(f"{path}:{i}: {e}") from None
            if not isinstance(rec, dict):
                raise ValueError(f"{path}:{i}: not a JSON object")
            records.append(rec)
    return records


def _close(a, b) -> bool:
    if isinstance(a, (int, float)) and isinstance(b, (int, float)) \
            and not isinstance(a, bool) and not isinstance(b, bool):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-9)
    return a == b


def _project(rec: Dict, fields: Sequence[str]) -> Tuple:
    return tuple(rec.get(f) for f in fields)


def _outcome_tallies(records: List[Dict]) -> Dict[Tuple[str, str], int]:
    tallies: Dict[Tuple[str, str], int] = {}
    for r in records:
        if r.get("type") != "trace":
            continue
        w = r.get("sample_weight")
        w = int(w) if isinstance(w, int) and w > 1 else 1
        k = (str(r.get("kind")), str(r.get("status")))
        tallies[k] = tallies.get(k, 0) + w
    return tallies


def _compare_sequences(section: str, a_rows: List[Tuple],
                       b_rows: List[Tuple], fields: Sequence[str],
                       details: List[str]):
    if len(a_rows) != len(b_rows):
        details.append(f"{section}: {len(a_rows)} records in a vs "
                       f"{len(b_rows)} in b")
        return
    for i, (ra, rb) in enumerate(zip(a_rows, b_rows)):
        for f, va, vb in zip(fields, ra, rb):
            if not _close(va, vb):
                details.append(
                    f"{section}[{i}].{f}: a={va!r} b={vb!r}")
                break  # one pointer per row is plenty
        else:
            continue
        return  # sequences report only their FIRST divergent row


def compare_streams(a: List[Dict], b: List[Dict]) -> DiffResult:
    """Compare two record streams under the invariance contract (module
    docstring). Deterministic and side-effect free; never raises on
    well-formed records."""
    details: List[str] = []

    # config first: "you compared different scenarios" beats a wall of
    # downstream outcome noise
    sa = [r for r in a if r.get("type") == "replay_summary"]
    sb = [r for r in b if r.get("type") == "replay_summary"]
    if len(sa) != len(sb):
        details.append(f"config: {len(sa)} replay_summary records in a "
                       f"vs {len(sb)} in b")
    else:
        _compare_sequences(
            "config", [_project(r, _SUMMARY_CONFIG) for r in sa],
            [_project(r, _SUMMARY_CONFIG) for r in sb],
            _SUMMARY_CONFIG, details)

    chaos_a = [r for r in a if r.get("type") == "event"
               and r.get("event") == "chaos_action"]
    chaos_b = [r for r in b if r.get("type") == "event"
               and r.get("event") == "chaos_action"]
    _compare_sequences(
        "chaos", [_project(r, _CHAOS) for r in chaos_a],
        [_project(r, _CHAOS) for r in chaos_b], _CHAOS, details)

    ta, tb = _outcome_tallies(a), _outcome_tallies(b)
    for k in sorted(set(ta) | set(tb)):
        na, nb = ta.get(k, 0), tb.get(k, 0)
        if na != nb:
            details.append(
                f"outcomes[kind={k[0]} status={k[1]}]: a={na} b={nb}")

    slo_fields = _SLO_INT + _SLO_FLOAT
    _compare_sequences(
        "slo_status",
        [_project(r, slo_fields) for r in a
         if r.get("type") == "slo_status"],
        [_project(r, slo_fields) for r in b
         if r.get("type") == "slo_status"],
        slo_fields, details)

    _compare_sequences(
        "progress",
        [_project(r, _PROGRESS) for r in a
         if r.get("type") == "workload_replay"],
        [_project(r, _PROGRESS) for r in b
         if r.get("type") == "workload_replay"],
        _PROGRESS, details)

    if len(sa) == len(sb):
        _compare_sequences(
            "summary", [_project(r, _SUMMARY_OUTCOME) for r in sa],
            [_project(r, _SUMMARY_OUTCOME) for r in sb],
            _SUMMARY_OUTCOME, details)

    return DiffResult(bool(details), details[0] if details else None,
                      details)
