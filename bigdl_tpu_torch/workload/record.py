"""Workload capture: distill a live trace stream into a replayable file
(counterpart of `bigdl_tpu/workload/record.py`, pure Python: the same
entries, the same files byte for byte for the same records and seeds).

A *workload* is everything about production traffic that matters for
capacity and robustness questions, and nothing else: WHEN each request
arrived (relative offsets, so the file is self-contained), WHO it
belonged to (session ids — affinity changes routing), WHAT it asked for
(feature shape / prompt+token counts), and WHAT WAS PROMISED
(deadline budget, idempotency). Outcomes and latencies are deliberately
NOT part of a workload — they are what a replay re-derives against the
code under test.

Two ways to get one:

- `WorkloadRecorder` — a `TelemetrySink` that watches a live
  `trace` stream (the serving engine's `serving_request`, the fleet's
  `fleet_request`/`fleet_generate`, the generation engine's `generate`
  records) and distills it into a `Workload`. Attach it next to the
  JSONL sink; call `.workload()` when the run ends.
- the synthetic generators (`poisson_arrivals` / `bursty_arrivals` /
  `diurnal_arrivals` + `synthesize`) — seeded arrival processes for
  traffic not yet recorded ("what if arrivals double?").

The file format is strict JSONL (the repo-wide telemetry convention):
a `{"type": "workload", "version": 1, ...}` header line, then one
`{"type": "workload_entry", ...}` line per request in arrival order.
`tests/workloads/` checks scenario files in; `docs/workload.md` is the
format contract.
"""

import hashlib
import json
import os
import random
from typing import Dict, List, Optional, Sequence

from bigdl_tpu_torch.observability.telemetry import TelemetrySink

__all__ = ["WorkloadEntry", "Workload", "WorkloadRecorder",
           "poisson_arrivals", "bursty_arrivals", "diurnal_arrivals",
           "synthesize"]

#: trace `kind`s replayed through `generate()`; everything else goes
#: through `submit()`
GENERATE_KINDS = ("generate", "fleet_generate")

_RECORDED_KINDS = ("serving_request", "fleet_request") + GENERATE_KINDS


class WorkloadEntry:
    """One request of a workload. `arrival_offset_ms` is relative to the
    workload's own t0 (the first entry is at or near 0); `kind` is the
    trace kind it was recorded from (`serving_request` / `fleet_request`
    replay as `submit`, `generate` / `fleet_generate` as `generate`)."""

    __slots__ = ("arrival_offset_ms", "kind", "session_id", "shape",
                 "prompt_tokens", "max_new_tokens", "deadline_ms",
                 "idempotent")

    def __init__(self, arrival_offset_ms: float, kind: str = "fleet_request",
                 session_id: Optional[str] = None,
                 shape: Optional[Sequence[int]] = None,
                 prompt_tokens: Optional[int] = None,
                 max_new_tokens: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 idempotent: bool = True):
        if arrival_offset_ms < 0:
            raise ValueError(
                f"arrival_offset_ms must be >= 0, got {arrival_offset_ms}")
        self.arrival_offset_ms = float(arrival_offset_ms)
        self.kind = str(kind)
        self.session_id = session_id
        self.shape = [int(d) for d in shape] if shape is not None else None
        self.prompt_tokens = int(prompt_tokens) \
            if prompt_tokens is not None else None
        self.max_new_tokens = int(max_new_tokens) \
            if max_new_tokens is not None else None
        self.deadline_ms = float(deadline_ms) \
            if deadline_ms is not None else None
        self.idempotent = bool(idempotent)

    def is_generate(self) -> bool:
        return self.kind in GENERATE_KINDS

    def to_dict(self) -> Dict:
        d = {"type": "workload_entry",
             "arrival_offset_ms": round(self.arrival_offset_ms, 3),
             "kind": self.kind}
        if self.session_id is not None:
            d["session_id"] = self.session_id
        if self.shape is not None:
            d["shape"] = self.shape
        if self.prompt_tokens is not None:
            d["prompt_tokens"] = self.prompt_tokens
        if self.max_new_tokens is not None:
            d["max_new_tokens"] = self.max_new_tokens
        if self.deadline_ms is not None:
            d["deadline_ms"] = round(self.deadline_ms, 3)
        if not self.idempotent:
            d["idempotent"] = False
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "WorkloadEntry":
        return cls(arrival_offset_ms=d["arrival_offset_ms"],
                   kind=d.get("kind", "fleet_request"),
                   session_id=d.get("session_id"),
                   shape=d.get("shape"),
                   prompt_tokens=d.get("prompt_tokens"),
                   max_new_tokens=d.get("max_new_tokens"),
                   deadline_ms=d.get("deadline_ms"),
                   idempotent=d.get("idempotent", True))

    def __repr__(self):
        return (f"WorkloadEntry(+{self.arrival_offset_ms:.1f}ms "
                f"{self.kind} session={self.session_id})")


class Workload:
    """An ordered set of `WorkloadEntry`s plus the metadata that makes a
    replay reproducible: a `name`, the `seed` synthetic pieces were drawn
    with, and an optional embedded chaos schedule (action dicts, see
    `workload.chaos`). Entries are kept sorted by arrival offset —
    the monotonic-offset invariant every consumer relies on."""

    def __init__(self, name: str, entries: Sequence[WorkloadEntry],
                 seed: int = 0, chaos: Optional[List[Dict]] = None,
                 meta: Optional[Dict] = None):
        self.name = str(name)
        self.seed = int(seed)
        self.entries = sorted(entries,
                              key=lambda e: (e.arrival_offset_ms,
                                             e.session_id or "", e.kind))
        self.chaos = list(chaos or [])
        self.meta = dict(meta or {})

    def __len__(self):
        return len(self.entries)

    def __iter__(self):
        return iter(self.entries)

    @property
    def duration_ms(self) -> float:
        return self.entries[-1].arrival_offset_ms if self.entries else 0.0

    def scale_rate(self, factor: float) -> "Workload":
        """The capacity question as a transform: `scale_rate(2.0)` is
        this traffic arriving twice as fast (offsets divided by factor;
        deadlines untouched — the PROMISE does not change with load)."""
        if factor <= 0:
            raise ValueError(f"factor must be > 0, got {factor}")
        entries = []
        for e in self.entries:
            d = e.to_dict()
            d["arrival_offset_ms"] = e.arrival_offset_ms / factor
            entries.append(WorkloadEntry.from_dict(d))
        return Workload(f"{self.name}@x{factor:g}", entries,
                        seed=self.seed, chaos=self.chaos,
                        meta=self.meta)

    def sha256(self) -> str:
        """Content fingerprint over the canonical serialized form —
        what `replay_summary.workload_sha256` carries so a diff can tell
        "same scenario, different outcome" from "different scenario"."""
        h = hashlib.sha256()
        h.update(json.dumps(self._header(), sort_keys=True,
                            allow_nan=False).encode())
        for e in self.entries:
            h.update(json.dumps(e.to_dict(), sort_keys=True,
                                allow_nan=False).encode())
        return h.hexdigest()

    def _header(self) -> Dict:
        return {"type": "workload", "version": 1, "name": self.name,
                "seed": self.seed, "entries": len(self.entries),
                "chaos": self.chaos, "meta": self.meta}

    def save(self, path: str):
        """Write the strict-JSONL workload file (header + one line per
        entry, arrival order)."""
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            f.write(json.dumps(self._header(), allow_nan=False) + "\n")
            for e in self.entries:
                f.write(json.dumps(e.to_dict(), allow_nan=False) + "\n")

    @classmethod
    def load(cls, path: str) -> "Workload":
        """Parse a workload file, validating the header, strict JSON,
        and the monotonic-offset invariant. Raises `ValueError` naming
        `path:line` on the first violation."""
        header = None
        entries: List[WorkloadEntry] = []
        last_off = -1.0
        with open(path) as f:
            for i, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    d = json.loads(
                        line, parse_constant=lambda c: (_ for _ in ()).throw(
                            ValueError(f"non-strict JSON constant {c}")))
                except ValueError as e:
                    raise ValueError(f"{path}:{i}: {e}") from None
                if not isinstance(d, dict):
                    raise ValueError(f"{path}:{i}: not a JSON object")
                if i == 1:
                    if d.get("type") != "workload":
                        raise ValueError(
                            f"{path}:1: expected a workload header "
                            f"(type=workload), got type={d.get('type')!r}")
                    if d.get("version") != 1:
                        raise ValueError(
                            f"{path}:1: unsupported workload version "
                            f"{d.get('version')!r}")
                    header = d
                    continue
                if d.get("type") != "workload_entry":
                    raise ValueError(
                        f"{path}:{i}: expected type=workload_entry, "
                        f"got {d.get('type')!r}")
                try:
                    e = WorkloadEntry.from_dict(d)
                except (KeyError, TypeError, ValueError) as exc:
                    raise ValueError(f"{path}:{i}: {exc}") from None
                if e.arrival_offset_ms < last_off:
                    raise ValueError(
                        f"{path}:{i}: arrival_offset_ms went backwards "
                        f"({e.arrival_offset_ms} < {last_off})")
                last_off = e.arrival_offset_ms
                entries.append(e)
        if header is None:
            raise ValueError(f"{path}: empty workload file")
        return cls(header.get("name", os.path.basename(path)), entries,
                   seed=header.get("seed", 0),
                   chaos=header.get("chaos"),
                   meta=header.get("meta"))


class WorkloadRecorder(TelemetrySink):
    """Distill a live trace stream into a `Workload`.

    Mirrors `SloEngine`'s caller-visibility rule: a FLEET-managed
    replica's transient-shaped casualty (`cancelled`/`shed`/`timeout`
    with a `replica_id`) is the router's problem, not a distinct
    arrival — the re-routed attempt (or the fleet's surfaced failure)
    is recorded separately, so counting both would duplicate the
    request. Arrival times come from the record's own timeline
    (`time - latency_ms`, falling back to `arrival_offset_ms`), then
    normalize so the first arrival is offset 0 — the workload file has
    no wall-clock in it.

    One caveat the docs spell out: a request that fails PERMANENTLY at
    a replica leaves a replica-level error record *and* a fleet-level
    one; the recorder (like `SloEngine`) keeps both, slightly
    over-counting errored arrivals on a fleet stream."""

    def __init__(self, name: str = "recorded", seed: int = 0):
        self.name = name
        self.seed = int(seed)
        self._raw: List[Dict] = []  # (arrival key, entry dict) pairs

    def emit(self, record: Dict):
        if record.get("type") != "trace":
            return
        kind = record.get("kind")
        if kind not in _RECORDED_KINDS:
            return
        if kind in ("serving_request", "generate") \
                and record.get("replica_id") \
                and record.get("status") in ("cancelled", "shed",
                                             "timeout"):
            return  # fleet-managed casualty: the caller's outcome is
            # a separate record (SloEngine applies the same rule)
        latency = record.get("latency_ms")
        t_emit = record.get("time")
        if isinstance(t_emit, (int, float)) and \
                isinstance(latency, (int, float)):
            arrival = t_emit * 1e3 - latency  # one shared wall timeline
        else:
            # engine-anchored offset: exact for single-emitter streams
            arrival = record.get("arrival_offset_ms", 0.0)
        w = record.get("sample_weight")
        w = int(w) if isinstance(w, int) and w > 1 else 1
        entry = {"kind": kind,
                 "session_id": record.get("session_id"),
                 "shape": record.get("shape"),
                 "prompt_tokens": record.get("prompt_tokens"),
                 "max_new_tokens": record.get("tokens") or None,
                 "deadline_ms": record.get("deadline_budget_ms"),
                 "idempotent": record.get("idempotent", True)}
        # a sampled stream's 1-in-N ok record stands for N arrivals:
        # re-materialize them at the same offset so replayed LOAD
        # matches the live load the stream was sampled from
        for _ in range(w):
            self._raw.append((float(arrival), entry))

    def workload(self, chaos: Optional[List[Dict]] = None,
                 meta: Optional[Dict] = None) -> "Workload":
        """Build the `Workload` from everything seen so far."""
        if not self._raw:
            return Workload(self.name, [], seed=self.seed, chaos=chaos,
                            meta=meta)
        t0 = min(a for a, _ in self._raw)
        entries = [WorkloadEntry(arrival_offset_ms=max(0.0, a - t0),
                                 **e) for a, e in self._raw]
        return Workload(self.name, entries, seed=self.seed, chaos=chaos,
                        meta=meta)


# ------------------------------------------------------- synthetic traffic

def poisson_arrivals(rate_per_s: float, duration_s: float,
                     seed: int = 0) -> List[float]:
    """Homogeneous Poisson arrival offsets (ms), seeded: exponential
    inter-arrival gaps at `rate_per_s`, truncated at `duration_s`."""
    if rate_per_s <= 0 or duration_s <= 0:
        raise ValueError("rate_per_s and duration_s must be > 0")
    rng = random.Random(seed)
    out, t = [], 0.0
    while True:
        t += rng.expovariate(rate_per_s)
        if t >= duration_s:
            return out
        out.append(t * 1e3)


def bursty_arrivals(rate_per_s: float, duration_s: float, seed: int = 0,
                    burst_factor: float = 8.0,
                    burst_fraction: float = 0.2) -> List[float]:
    """Two-state (Markov-modulated) Poisson process: `burst_fraction`
    of the timeline runs at `burst_factor * rate_per_s`, the rest at a
    compensating calm rate so the MEAN rate stays `rate_per_s` — the
    flash-crowd shape that breaks queues a steady process never will."""
    if not 0.0 < burst_fraction < 1.0:
        raise ValueError("burst_fraction must be in (0, 1)")
    if burst_factor <= 1.0:
        raise ValueError("burst_factor must be > 1")
    calm = rate_per_s * (1 - burst_factor * burst_fraction) \
        / (1 - burst_fraction)
    calm = max(calm, rate_per_s * 0.01)  # a heavy burst may demand a
    # negative calm rate; floor it instead of going degenerate
    rng = random.Random(seed)
    # deterministic state plan: alternate calm/burst dwell windows
    out, t = [], 0.0
    in_burst = False
    window_end = 0.0
    while t < duration_s:
        if t >= window_end:
            in_burst = not in_burst if window_end > 0 else \
                rng.random() < burst_fraction
            mean_dwell = duration_s * (burst_fraction if in_burst
                                       else (1 - burst_fraction)) / 4
            window_end = t + rng.expovariate(1.0 / max(mean_dwell, 1e-6))
        rate = rate_per_s * burst_factor if in_burst else calm
        step = rng.expovariate(rate)
        if t + step >= window_end:
            # the candidate arrival lands past this dwell window, where
            # the rate is different — advance to the boundary and
            # redraw there (memorylessness makes the discard exact)
            t = window_end
            continue
        t += step
        if t < duration_s:
            out.append(t * 1e3)
    return out


def diurnal_arrivals(rate_per_s: float, duration_s: float, seed: int = 0,
                     period_s: Optional[float] = None,
                     depth: float = 0.8) -> List[float]:
    """Inhomogeneous Poisson with a sinusoidal day curve (peak at half
    period), thinned from a `rate_per_s * (1 + depth)` envelope —
    `depth` in [0, 1) is how far the trough drops below the mean."""
    import math
    if not 0.0 <= depth < 1.0:
        raise ValueError("depth must be in [0, 1)")
    period = duration_s if period_s is None else period_s
    peak = rate_per_s * (1 + depth)
    rng = random.Random(seed)
    out, t = [], 0.0
    while True:
        t += rng.expovariate(peak)
        if t >= duration_s:
            return out
        lam = rate_per_s * (1 + depth * math.sin(
            2 * math.pi * t / period - math.pi / 2))
        if rng.random() < lam / peak:
            out.append(t * 1e3)


def synthesize(name: str, arrivals: Sequence[float], seed: int = 0,
               kind: str = "fleet_request",
               shape: Optional[Sequence[int]] = None,
               prompt_tokens: Optional[int] = None,
               max_new_tokens: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               sessions: int = 0,
               chaos: Optional[List[Dict]] = None) -> Workload:
    """Turn a list of arrival offsets (ms) into a `Workload`: every
    entry shares the given request shape; `sessions > 0` deals session
    ids `s0..s{n-1}` round-robin from a seeded shuffle (affinity
    without an accidental replica hot-spot)."""
    rng = random.Random(seed)
    ids = [f"s{i}" for i in range(sessions)]
    rng.shuffle(ids)
    entries = []
    for i, off in enumerate(sorted(arrivals)):
        entries.append(WorkloadEntry(
            arrival_offset_ms=off, kind=kind,
            session_id=ids[i % sessions] if sessions else None,
            shape=shape, prompt_tokens=prompt_tokens,
            max_new_tokens=max_new_tokens, deadline_ms=deadline_ms))
    return Workload(name, entries, seed=seed, chaos=chaos)
