"""Deterministic, plan-driven fault injection (counterpart of
`bigdl_tpu/resilience/faults.py`).

Named sites in the framework call `fire("site.name")`, a single global
load and `None` check when no injector is installed, which raises a chosen
exception at a chosen hit when one is. Tests then crash the system at an
instrumented point (between two checkpoint writes, on the Nth training
step) and check that the recovery machinery (durable checkpoints, the
retry policy) recovers.

Sites the port instruments:

    ckpt.write.params / ckpt.write.state / ckpt.write.optim /
    ckpt.write.manifest / ckpt.commit      serialization/checkpoint.py
    train.step                             both optimizers' training loops
    mesh.device_loss / mesh.collective     DistriOptimizer's elastic loop
    serve.forward                          serving/engine.py dispatch and
                                           generation.py prefill
    serve.decode                           serving/generation.py (registered
                                           with register_site on import)
    serve.replica_crash / serve.route /
    serve.drain                            serving/fleet.py (registered
                                           with register_site on import)
    fs.remote_io                           utils/filesystem.py remote ops
    telemetry.sink                         observability/telemetry.py emit

The reference's `prefetch.worker` belongs to a subsystem the port has not
ported yet; a `FaultSpec` naming it raises, since it would never fire.
An injector given a `Telemetry` emits a `fault_injected` event for each
fault it raises; that emission does not fire the `telemetry.sink` site
again.

Example: crash the 3rd training step once, transiently:

    >>> from bigdl_tpu_torch.resilience import FaultInjector, FaultSpec
    >>> plan = FaultInjector(FaultSpec("train.step", at_hit=3))
    >>> with plan:
    ...     pass  # optimizer.optimize() here would crash at step 3
"""

from __future__ import annotations

import logging
import random
import threading
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger("bigdl_tpu_torch.resilience")

#: Every site the port instruments, `<subsystem>.<event>`. `FaultSpec`
#: validates against this registry (plus `register_site` extras), so a
#: misspelt site raises when the plan is built instead of never firing.
KNOWN_SITES = (
    "ckpt.write.params", "ckpt.write.state", "ckpt.write.optim",
    "ckpt.write.manifest", "ckpt.commit",
    "train.step", "mesh.device_loss", "mesh.collective",
    "serve.forward", "fs.remote_io", "telemetry.sink",
)

_EXTRA_SITES: set = set()


def register_site(site: str) -> str:
    """Register an application-level site so `FaultSpec(site)` accepts
    it; returns the name."""
    if not site or "." not in site:
        raise ValueError(
            f"fault site {site!r} must follow '<subsystem>.<event>'")
    _EXTRA_SITES.add(site)
    return site


def known_sites() -> tuple:
    """Every registered site (in-tree and `register_site` extras)."""
    return KNOWN_SITES + tuple(sorted(_EXTRA_SITES))


class InjectedFault(Exception):
    """Base class of injector-raised faults."""


class TransientInjectedFault(InjectedFault):
    """A fault `RetryPolicy` classifies transient by default: a flaky read,
    a preempted worker."""


class PermanentInjectedFault(InjectedFault):
    """A fault `RetryPolicy` classifies permanent by default: a shape error
    or a poisoned input that retrying cannot fix."""


class FaultSpec:
    """One entry of a fault plan: raise `exc` at site `site`.

    site : an instrumented site, one of `known_sites()`; any other name
        raises `ValueError`.
    at_hit : the 1-based hit (one `fire()` call at the site that matches
        `when`) at which the fault starts.
    times : how many consecutive hits fire from `at_hit` on; None: every
        hit from `at_hit` (a persistent failure).
    p : per-hit probability, drawn from the injector's seeded rng, so a
        (plan, seed) pair replays exactly; `at_hit` / `times` still bound
        the eligible hits.
    exc : the exception: a class (built with a message), an instance
        (raised as it is), or a callable `ctx -> BaseException`.
    when : optional predicate over the site's context dict; hits that
        fail it are not counted.
    """

    __slots__ = ("site", "at_hit", "times", "p", "exc", "when")

    def __init__(self, site: str, at_hit: int = 1,
                 times: Optional[int] = 1, p: Optional[float] = None,
                 exc=TransientInjectedFault,
                 when: Optional[Callable[[Dict], bool]] = None):
        if at_hit < 1:
            raise ValueError(f"at_hit must be >= 1, got {at_hit}")
        if times is not None and times < 1:
            raise ValueError(f"times must be >= 1 or None, got {times}")
        if site not in KNOWN_SITES and site not in _EXTRA_SITES:
            raise ValueError(
                f"FaultSpec site {site!r} is not an instrumented site; it "
                f"would never fire. Known sites: {', '.join(known_sites())}."
                " Application fire() points must call register_site() "
                "first.")
        self.site = site
        self.at_hit = at_hit
        self.times = times
        self.p = p
        self.exc = exc
        self.when = when

    def _build_exc(self, ctx: Dict, hit: int) -> BaseException:
        if isinstance(self.exc, BaseException):
            return self.exc
        if isinstance(self.exc, type) and issubclass(self.exc,
                                                     BaseException):
            return self.exc(f"injected fault at {self.site} (hit {hit})")
        return self.exc(ctx)

    def __repr__(self):
        return (f"FaultSpec({self.site!r}, at_hit={self.at_hit}, "
                f"times={self.times}, p={self.p})")


class FaultInjector:
    """A seeded fault plan, installable as the process-wide injector: as a
    context manager, or with `install()` / `uninstall()`. Thread-safe.
    `fired` lists the `(site, hit)` pairs that raised; `hits(site)` counts
    the `fire()` calls a site made while installed."""

    def __init__(self, *specs: FaultSpec, seed: int = 0, telemetry=None):
        self.specs = list(specs)
        self.telemetry = telemetry
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {}
        self._spec_hits: Dict[int, int] = {}
        self.fired: List[Tuple[str, int]] = []
        self._local = threading.local()

    def add(self, spec: FaultSpec) -> "FaultInjector":
        """Append a spec to the plan (usable while installed)."""
        with self._lock:
            self.specs.append(spec)
        return self

    def hits(self, site: str) -> int:
        """`fire()` calls at `site` while this plan was installed."""
        with self._lock:
            return self._hits.get(site, 0)

    def install(self) -> "FaultInjector":
        """Make this plan the process-wide injector."""
        global _ACTIVE
        _ACTIVE = self
        return self

    def uninstall(self):
        """Remove this plan if it is the installed one."""
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None

    def __enter__(self) -> "FaultInjector":
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()

    def _fire(self, site: str, ctx: Dict):
        if getattr(self._local, "emitting", False):
            return
        raise_exc = None
        with self._lock:
            hit = self._hits.get(site, 0) + 1
            self._hits[site] = hit
            for s in self.specs:
                if s.site != site:
                    continue
                if s.when is not None and not s.when(ctx):
                    continue
                # at_hit / times count the calls matching this spec
                shit = self._spec_hits.get(id(s), 0) + 1
                self._spec_hits[id(s)] = shit
                if shit < s.at_hit:
                    continue
                if s.times is not None and shit >= s.at_hit + s.times:
                    continue
                if s.p is not None and self._rng.random() >= s.p:
                    continue
                raise_exc = s._build_exc(ctx, shit)
                self.fired.append((site, hit))
                break
        if raise_exc is None:
            return
        logger.warning("fault injected at %s (hit %d): %r", site, hit,
                       raise_exc)
        if self.telemetry is not None:
            self._local.emitting = True
            try:
                self.telemetry.event("fault_injected", site=site, hit=hit,
                                     error=repr(raise_exc))
            except Exception:
                logger.exception("fault_injected telemetry emit failed")
            finally:
                self._local.emitting = False
        raise raise_exc


#: the installed injector, or None; read on every `fire()` call
_ACTIVE: Optional[FaultInjector] = None


def fire(site: str, **ctx):
    """A fault point: a no-op unless a `FaultInjector` is installed, whose
    plan then decides whether this hit at `site` raises. `ctx` (step,
    path, ...) is visible to `FaultSpec.when` and exception factories."""
    inj = _ACTIVE
    if inj is not None:
        inj._fire(site, ctx)


def active_injector() -> Optional[FaultInjector]:
    """The installed injector, or None."""
    return _ACTIVE
