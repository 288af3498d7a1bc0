"""Compile records: a per-signature cost and first-use wrapper
(counterpart of `bigdl_tpu/observability/compilation.py`).

The reference wraps a `jax.jit` callable so that every compilation is an
observable event. The port compiles nothing ahead of time: an eager
PyTorch call pays its one-off costs at its first use of a shape (kernel
builds, cuDNN's choice of algorithm, the caching allocator's growth). So
`CompiledFunction` keeps the reference's contract over an eager callable:

- each call computes a cheap input *signature*: the shapes and dtypes of
  the designated `sig_argnums` (the reference's `arg_signature`), plus
  the device they live on;
- a new signature has its cost counted once, on the meta device
  (`costs.count_costs`: the FLOPs, each hand-written kernel by its
  formula, and the aten ops of the call, in one dispatch walk; nothing
  launches). `lower_s` is the time of that count, `jaxpr_eqns` the op
  count. Then the first real call at the signature runs between two
  device synchronizations; its time is `compile_s`, the first-use cost.
  ONE `compile` telemetry record follows: `{type: "compile", label,
  signature, lower_s, compile_s, jaxpr_eqns, cache_hit, flops,
  bytes_accessed}` (`bytes_accessed` is None: nothing models the bytes a
  call moves);
- a `(label, signature, op count)` triple that an earlier wrapper in this
  process has already seen reports `cache_hit: true`;
- a known signature dispatches straight to the function: no record, no
  synchronization.

`last_info` (per thread) holds the dispatched signature's cost dict; the
training loops' step records and the serving engines' FLOPs read it, so
every per-signature FLOP count of the port lives here.

The reference falls back to plain `jit` when its AOT path fails; the port
has no AOT path, so nothing falls back. A count that fails is logged and
leaves `flops` and `jaxpr_eqns` None: the call itself always runs.

Durations use `time.monotonic()`.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from bigdl_tpu_torch.observability import costs
from bigdl_tpu_torch.utils.table import Table

logger = logging.getLogger("bigdl_tpu_torch.observability")

#: Process-level ledger of (label, signature, op count) triples already
#: seen by some `CompiledFunction`: a later wrapper hitting the same triple
#: reports its compile record with `cache_hit: true`.
_COMPILED_BEFORE: set = set()
_COMPILED_BEFORE_LOCK = threading.Lock()


def _leaves(x):
    """The leaves of a nest of lists, tuples, `Table`s and dicts."""
    if isinstance(x, (list, tuple, Table)):
        for v in x:
            yield from _leaves(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    else:
        yield x


def _dtype_name(dtype) -> str:
    name = str(dtype)
    return name[len("torch."):] if name.startswith("torch.") else name


def _leaf_sig(leaf) -> Tuple:
    shape = getattr(leaf, "shape", None)
    if shape is not None:
        return (tuple(shape),
                _dtype_name(getattr(leaf, "dtype", type(leaf).__name__)))
    return ("py", type(leaf).__name__)


def arg_signature(args) -> Tuple:
    """Hashable shape/dtype signature of a tuple of (nested) arguments."""
    return tuple(tuple(_leaf_sig(leaf) for leaf in _leaves(a))
                 for a in args)


def signature_str(sig: Tuple) -> str:
    """Compact human/JSON form of an `arg_signature`, e.g.
    `"32x28x28:float32|32:int32"`."""
    parts = []
    for arg in sig:
        for leaf in arg:
            if leaf[0] == "py":
                parts.append(f"py:{leaf[1]}")
            else:
                shape, dtype = leaf
                parts.append("x".join(map(str, shape)) + f":{dtype}"
                             if shape else f"scalar:{dtype}")
    return "|".join(parts)


def to_meta(x):
    """`x` with every tensor moved to the meta device (shapes and dtypes
    kept), through lists, tuples, `Table`s and dicts; anything else (a
    numpy array, a number) as it is."""
    if isinstance(x, torch.Tensor):
        return x.to("meta")
    if isinstance(x, Table):
        return Table(*[to_meta(v) for v in x])
    if isinstance(x, (list, tuple)):
        return type(x)(to_meta(v) for v in x)
    if isinstance(x, dict):
        return {k: to_meta(v) for k, v in x.items()}
    return x


def _device_of(args) -> Optional[str]:
    for leaf in _leaves(args):
        if isinstance(leaf, torch.Tensor):
            return str(leaf.device)
    return None


def _synchronize(device: Optional[str]):
    if device is not None and device.startswith("cuda"):
        torch.cuda.synchronize(device)


class CompiledFunction:
    """Wrap an eager callable with per-signature cost counting, first-use
    timing and `compile` telemetry (see the module docstring).

    Parameters
    ----------
    fn : the callable.
    label : the compile record's `label` (name the call site:
        `"local.step/LeNet5"`, `"serving.forward/Sequential"`).
    telemetry : optional `observability.Telemetry`; assignable after
        construction (`wrapper.telemetry = tel`), as the serving engine
        does with its predictor's wrapper.
    sig_argnums : positional indices whose shapes and dtypes define the
        signature (default: all arguments). The other arguments must keep
        their shapes over the wrapper's life.
    meta : `meta(*args) -> (meta_fn, meta_args)`, the call to count on
        the meta device for these arguments. Default: `fn` itself on the
        arguments moved to the meta device (`to_meta`), which suits a
        function of its arguments alone; a call that closes over a model
        passes the same call on a meta copy of it.
    device : the signature's device; default the device of the first
        tensor among the signature's arguments.
    flops_scale : a multiplier of the counted FLOPs (a data-parallel
        step counts one rank's batch and records the global step's).

    After a call, `last_info` holds the dispatched signature's cost dict
    (`{"flops", "bytes_accessed", "jaxpr_eqns", "lower_s", "compile_s",
    "cache_hit", "signature"}`).
    """

    def __init__(self, fn: Callable, *, label: str, telemetry=None,
                 sig_argnums: Optional[Sequence[int]] = None,
                 meta: Optional[Callable] = None,
                 device: Optional[str] = None, flops_scale: int = 1):
        self._fn = fn
        self.label = label
        self.telemetry = telemetry
        self.sig_argnums = tuple(sig_argnums) if sig_argnums is not None \
            else None
        self._meta = meta
        self.device = str(device) if device is not None else None
        self.flops_scale = flops_scale
        self._lock = threading.Lock()
        self._cache: Dict[Tuple, Dict] = {}  # signature -> info
        self._tls = threading.local()  # per-thread last dispatched info

    # ------------------------------------------------------------ internals
    def _signature(self, args) -> Tuple:
        picked = args if self.sig_argnums is None \
            else tuple(args[i] for i in self.sig_argnums)
        device = self.device if self.device is not None \
            else _device_of(picked)
        return arg_signature(picked), device

    @property
    def last_info(self) -> Optional[Dict]:
        """Cost dict of the signature THIS THREAD last dispatched (a
        serving dispatcher must not read the warmup thread's bucket);
        None before its first call."""
        return getattr(self._tls, "info", None)

    def _cache_size(self) -> int:
        """Distinct signatures seen through this wrapper."""
        with self._lock:
            return len(self._cache)

    def _emit(self, record: Dict):
        if self.telemetry is None:
            return
        try:
            self.telemetry.emit(record)
        except Exception:
            logger.exception("compile telemetry emit failed; record dropped")

    def _count(self, args) -> Tuple[Optional[int], Optional[int], float]:
        """(FLOPs, aten ops, seconds) of the call's meta twin."""
        t0 = time.monotonic()
        try:
            meta_fn, meta_args = self._meta(*args) if self._meta is not None \
                else (self._fn, to_meta(args))
            flops, ops = costs.count_costs(meta_fn, *meta_args)
            flops = int(flops * self.flops_scale)
        except Exception as e:  # attribution never fails the call
            logger.warning("cost count of %s failed (%r); its compile "
                           "record carries no FLOPs", self.label, e)
            flops = ops = None
        return flops, ops, time.monotonic() - t0

    def _first_call(self, sig: Tuple, args):
        """Count a new signature on the meta device, time its first real
        call between two synchronizations, record it."""
        flops, ops, lower_s = self._count(args)
        _synchronize(sig[1])
        t1 = time.monotonic()
        out = self._fn(*args)
        _synchronize(sig[1])
        compile_s = time.monotonic() - t1
        key = (self.label, sig, ops)
        with _COMPILED_BEFORE_LOCK:
            cache_hit = key in _COMPILED_BEFORE
            _COMPILED_BEFORE.add(key)
        text = signature_str(sig[0])
        if sig[1] is not None:
            text += f"@{sig[1]}"
        info = {"signature": text, "lower_s": round(lower_s, 6),
                "compile_s": round(compile_s, 6), "jaxpr_eqns": ops,
                "cache_hit": cache_hit, "flops": flops,
                "bytes_accessed": None}
        with self._lock:
            kept = self._cache.setdefault(sig, info)
        if kept is info:  # a racing first call of the same signature
            self._emit({"type": "compile", "label": self.label, **info})
        return out, kept

    # ------------------------------------------------------------- dispatch
    def __call__(self, *args):
        sig = self._signature(args)
        with self._lock:
            info = self._cache.get(sig)
        if info is None:
            out, info = self._first_call(sig, args)
        else:
            out = self._fn(*args)
        self._tls.info = info
        return out

    def cost_info(self, *args) -> Optional[Dict]:
        """The cost dict for the signature `args` would dispatch under,
        without running anything; None if never seen."""
        with self._lock:
            return self._cache.get(self._signature(args))

