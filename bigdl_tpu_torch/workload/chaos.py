"""Seeded, declarative chaos schedules over a `ServingFleet`
(counterpart of `bigdl_tpu/workload/chaos.py`, pure Python).

The fleet soak drills (kill a replica mid-traffic, watch the router
save the work) generalized into data: a `ChaosSchedule` is an ordered
list of `ChaosAction`s, each firing either at a virtual-time offset
(`at_offset_ms`) or at a progress trigger (`after_entries` — "once N
requests have been replayed", the predicate form that stays meaningful
under time compression). Actions drive the fleet's EXISTING chaos
surface — `fail` / `restore` / `scale_up` / `scale_down` /
`suspend_heartbeat` — plus `route_fault`, which arms the `serve.route`
fault site through a `FaultInjector` for breaker/retry chaos.

Determinism contract: the same `(schedule, seed)` fires the same
actions at the same replay points against the same targets.
`target` may be an explicit replica id, an INDEX into the sorted
live-replica list at fire time (stable under identical histories), or
`None` — a pick from the schedule's own `random.Random(seed)`, which
consumes the stream in fire order. `ChaosSchedule.random(...)` draws a
whole kill/restore plan from one seed — same seed, same plan, byte for
byte (tests/test_torch_workload.py holds it to that, and to the
reference's plan for the same seed).

Schedules serialize to plain dicts (`to_dicts` / `from_dicts`) so a
workload file embeds its chaos plan — the scenario IS the file.
"""

import random
from typing import Dict, List, Optional, Sequence, Union

__all__ = ["ChaosAction", "ChaosSchedule", "CHAOS_ACTIONS"]

#: the action verbs a schedule may carry (fleet method per verb, except
#: route_fault which arms the serve.route fault site)
CHAOS_ACTIONS = ("kill", "restore", "scale_up", "scale_down",
                 "suspend_heartbeat", "route_fault")


class ChaosAction:
    """One scheduled intervention. Exactly one trigger: `at_offset_ms`
    (virtual workload time) or `after_entries` (replay progress)."""

    __slots__ = ("action", "at_offset_ms", "after_entries", "target",
                 "times", "fired")

    def __init__(self, action: str,
                 at_offset_ms: Optional[float] = None,
                 after_entries: Optional[int] = None,
                 target: Union[int, str, None] = None,
                 times: int = 1):
        if action not in CHAOS_ACTIONS:
            raise ValueError(f"unknown chaos action {action!r} "
                             f"(known: {', '.join(CHAOS_ACTIONS)})")
        if (at_offset_ms is None) == (after_entries is None):
            raise ValueError("exactly one of at_offset_ms / "
                             "after_entries must be set")
        if times < 1:
            raise ValueError(f"times must be >= 1, got {times}")
        self.action = action
        self.at_offset_ms = float(at_offset_ms) \
            if at_offset_ms is not None else None
        self.after_entries = int(after_entries) \
            if after_entries is not None else None
        self.target = target
        self.times = int(times)  # route_fault: how many routing
        # attempts the armed injector fails
        self.fired = False

    def due(self, offset_ms: float, entries_done: int) -> bool:
        if self.fired:
            return False
        if self.at_offset_ms is not None:
            return offset_ms >= self.at_offset_ms
        return entries_done >= self.after_entries

    def sort_key(self):
        # offset triggers order by time; entry triggers by progress —
        # mixed schedules interleave deterministically because the
        # replayer checks both at every entry boundary
        return (self.at_offset_ms if self.at_offset_ms is not None
                else float(self.after_entries),
                self.action, str(self.target))

    def to_dict(self) -> Dict:
        d = {"action": self.action}
        if self.at_offset_ms is not None:
            d["at_offset_ms"] = self.at_offset_ms
        if self.after_entries is not None:
            d["after_entries"] = self.after_entries
        if self.target is not None:
            d["target"] = self.target
        if self.times != 1:
            d["times"] = self.times
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "ChaosAction":
        return cls(d["action"], at_offset_ms=d.get("at_offset_ms"),
                   after_entries=d.get("after_entries"),
                   target=d.get("target"), times=d.get("times", 1))

    def __repr__(self):
        trig = (f"@{self.at_offset_ms}ms" if self.at_offset_ms is not None
                else f"@entry{self.after_entries}")
        return f"ChaosAction({self.action} {trig} target={self.target})"


class ChaosSchedule:
    """An ordered plan of `ChaosAction`s plus the seed that resolves
    its open choices (unpinned targets). `fire_due(...)` is called by
    the replayer at every entry boundary; it applies every newly-due
    action against the fleet and returns one event dict per firing —
    the deterministic chaos trail that lands in the replay stream."""

    def __init__(self, actions: Sequence[ChaosAction] = (), seed: int = 0):
        self.actions = sorted(actions, key=ChaosAction.sort_key)
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._injectors: List = []  # armed route_fault injectors

    def __len__(self):
        return len(self.actions)

    def __iter__(self):
        return iter(self.actions)

    def reset(self):
        """Rewind for a fresh replay: unfire every action and re-seed
        the target-choice rng (so two runs of ONE schedule object make
        identical choices)."""
        self.close()
        for a in self.actions:
            a.fired = False
        self._rng = random.Random(self.seed)

    # ------------------------------------------------------------ firing
    def fire_due(self, fleet, offset_ms: float,
                 entries_done: int) -> List[Dict]:
        """Apply every not-yet-fired action whose trigger has passed.
        Returns one event dict per firing (action, target, trigger,
        ok) in deterministic order."""
        events = []
        for a in self.actions:
            if a.due(offset_ms, entries_done):
                a.fired = True
                events.append(self._apply(a, fleet, offset_ms,
                                          entries_done))
        return events

    def _apply(self, a: ChaosAction, fleet, offset_ms: float,
               entries_done: int) -> Dict:
        ev = {"event": "chaos_action", "action": a.action,
              "offset_ms": round(offset_ms, 3),
              "entries_done": entries_done}
        if a.at_offset_ms is not None:
            ev["at_offset_ms"] = a.at_offset_ms
        else:
            ev["after_entries"] = a.after_entries
        try:
            target = self._resolve_target(a, fleet)
            if target is not None:
                ev["target"] = target
            if a.action == "kill":
                fleet.fail(target, reason="chaos kill")
            elif a.action == "restore":
                ev["ok"] = bool(fleet.restore(target))
                return ev
            elif a.action == "scale_up":
                ev["target"] = fleet.scale_up(trigger="chaos")
            elif a.action == "scale_down":
                fleet.scale_down(target, trigger="chaos")
            elif a.action == "suspend_heartbeat":
                fleet.suspend_heartbeat(target)
            elif a.action == "route_fault":
                from bigdl_tpu_torch.resilience.faults import (
                    FaultInjector, FaultSpec)
                inj = FaultInjector(
                    FaultSpec("serve.route", times=a.times),
                    seed=self.seed)
                inj.__enter__()
                self._injectors.append(inj)
            ev["ok"] = True
        except Exception as e:  # a failed action is chaos data, not a
            # replay crash — the event records it and the diff sees it
            ev["ok"] = False
            ev["error"] = repr(e)
        return ev

    def _resolve_target(self, a: ChaosAction, fleet) -> Optional[str]:
        if a.action in ("scale_up", "route_fault"):
            return None
        if isinstance(a.target, str):
            return a.target
        pool_state = "lost" if a.action == "restore" else "active"
        pool = sorted(fleet.replica_ids(pool_state))
        if not pool:
            raise RuntimeError(
                f"no {pool_state} replica to {a.action}")
        if isinstance(a.target, int):
            return pool[a.target % len(pool)]
        return self._rng.choice(pool)

    def close(self):
        """Disarm any armed route_fault injectors (the replayer calls
        this when the run ends, success or not)."""
        while self._injectors:
            inj = self._injectors.pop()
            try:
                inj.__exit__(None, None, None)
            except Exception:
                pass

    # ------------------------------------------------------- serialization
    def to_dicts(self) -> List[Dict]:
        return [a.to_dict() for a in self.actions]

    @classmethod
    def from_dicts(cls, dicts: Sequence[Dict],
                   seed: int = 0) -> "ChaosSchedule":
        return cls([ChaosAction.from_dict(d) for d in dicts], seed=seed)

    # ------------------------------------------------------------ synthesis
    @classmethod
    def random(cls, seed: int, duration_ms: float, kills: int = 1,
               restore_after_ms: Optional[float] = None,
               scale_events: int = 0) -> "ChaosSchedule":
        """Draw a kill/restore/churn plan from one seed: `kills` replica
        kills uniform over the middle 80% of the timeline (each followed
        by a restore after `restore_after_ms`, if given), plus
        `scale_events` alternating scale_up/scale_down ticks. Same seed
        in, same plan out."""
        if duration_ms <= 0:
            raise ValueError("duration_ms must be > 0")
        rng = random.Random(seed)
        actions = []
        lo, hi = 0.1 * duration_ms, 0.9 * duration_ms
        for _ in range(kills):
            at = rng.uniform(lo, hi)
            actions.append(ChaosAction("kill", at_offset_ms=at))
            if restore_after_ms is not None:
                actions.append(ChaosAction(
                    "restore", at_offset_ms=at + restore_after_ms))
        for i in range(scale_events):
            actions.append(ChaosAction(
                "scale_up" if i % 2 == 0 else "scale_down",
                at_offset_ms=rng.uniform(lo, hi)))
        return cls(actions, seed=seed)
