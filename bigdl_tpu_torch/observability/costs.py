"""Cost accounting: FLOPs of one call, the peak-FLOPs registry, and MFU
(counterpart of `bigdl_tpu/observability/costs.py`).

- `PEAK_BF16_FLOPS` / `peak_flops(device_kind)`: dense bf16 peak FLOP/s
  per chip, the reference's TPU entries plus NVIDIA's H100s. An unknown
  kind (the CPU included) gives None, and every MFU derived from it is
  None, never a made-up number.
- `count_flops(fn, *args)`: the FLOPs of one call of `fn`, the port's
  counterpart of `executable_costs` / `jaxpr_flops`. Matmuls and
  convolutions (forward and backward) are counted by
  `torch.utils.flop_counter.FlopCounterMode`; each hand-written kernel
  by its own formula, once per launch (`tally_kernel`), since the counter
  cannot see a `ctypes` launch. On the CPU a kernel wrapper runs its plain
  version through `plain_route`, which adds the same formula and hides
  the plain version's own aten ops from the counter, so a step counts the
  same number on the CPU and on the card. Inside a count, a wrapper given
  `meta` tensors only counts, so a step can be counted on shapes alone
  (`tools/bench.py` `step_flops`) without launching anything. Gathers
  and scatters (the embeddings, the sparse layers' lookups and their
  gradients) count nothing, as in `FlopCounterMode`; the sparse layers'
  weighted sums are `einsum`s, counted as the batched matmuls they run.
- `mfu(flops, step_time_s, ...)`: achieved FLOP/s over the peak. A
  data-parallel step's is the global FLOPs (every rank's shard) over
  `n_devices` = the world size times the peak, the reference's
  `_n_compute_devices` (`DistriOptimizer._n_compute_devices`,
  `tools/bench.py bench_dp`).

The kernels' formulas are the counts `PERF.md` section 6 takes for the
bounds: 2*D operations per unmasked (query, key) pair a product (2
products in the flash forward and the ring hop, 3 in dq, 4 in dk/dv),
2*k*k*C_in an output element of the stem, and 3 and 7 f32 operations an
element of the BN+ReLU forward and backward.

Example:
    >>> from bigdl_tpu_torch.observability.costs import peak_flops, mfu
    >>> peak_flops("NVIDIA H100 80GB HBM3")
    989000000000000.0
    >>> peak_flops("cpu") is None
    True
    >>> mfu(989e12, step_time_s=2.0, device_kind="NVIDIA H100 80GB HBM3")
    0.5
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch

#: Dense bf16 peak FLOP/s per chip, matched by case-insensitive substring
#: of the device kind, first match wins, most specific first. NVIDIA's
#: figures are from its H100 data sheet (dense bf16, without sparsity):
#: H100 PCIe 756 TFLOP/s, H100 SXM 989 TFLOP/s.
PEAK_BF16_FLOPS = (
    ("h100 pcie", 756e12), ("h100", 989e12),
    ("v6", 918e12), ("trillium", 918e12),
    ("v5p", 459e12), ("v5 lite", 197e12), ("v5e", 197e12), ("v5", 459e12),
    ("v4", 275e12), ("v3", 123e12), ("v2", 45e12),
)


def peak_flops(device_kind) -> Optional[float]:
    """Peak dense bf16 FLOP/s of a chip from the registry; None for an
    unknown kind. Takes a kind string (`torch.cuda.get_device_name()`) or a
    `torch.device` (a CUDA device is looked up by its name; any other
    device has no entry)."""
    if isinstance(device_kind, torch.device):
        device_kind = torch.cuda.get_device_name(device_kind) \
            if device_kind.type == "cuda" else ""
    kind = str(device_kind or "").lower()
    for key, peak in PEAK_BF16_FLOPS:
        if key in kind:
            return peak
    return None


_DEVICE_KIND: Optional[str] = None


def default_device_kind() -> str:
    """The current CUDA device's name, or "" without a card; cached after
    the first call."""
    global _DEVICE_KIND
    if _DEVICE_KIND is None:
        _DEVICE_KIND = torch.cuda.get_device_name() \
            if torch.cuda.is_available() else ""
    return _DEVICE_KIND


def mfu(flops: Optional[float], step_time_s: Optional[float],
        device_kind: Optional[str] = None,
        n_devices: int = 1) -> Optional[float]:
    """Model FLOPs utilization: `flops / step_time_s` over `n_devices *
    peak_flops(device_kind)` (default: the current card). None whenever an
    input is missing or not finite and positive, or the chip is not in the
    registry."""
    if flops is None or step_time_s is None:
        return None
    if not (math.isfinite(flops) and math.isfinite(step_time_s)) \
            or flops <= 0 or step_time_s <= 0:
        return None
    peak = peak_flops(device_kind if device_kind is not None
                      else default_device_kind())
    if not peak:
        return None
    return flops / step_time_s / (peak * max(1, int(n_devices)))


# --------------------------------------------------------------------------
# Counting one call
# --------------------------------------------------------------------------

class _GlobalOnly:
    """Stands in for `FlopCounterMode`'s module tracker: the count here is
    one total, and the tracker's backward hooks on module inputs reject
    `torch.autograd.grad` over a leaf input."""

    parents = {"Global"}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _counter():
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    counter.mod_tracker = _GlobalOnly()
    return counter


class _Session:
    """One `count_flops` call: the kernels' formula counts, and the FLOPs
    the counter saw inside plain versions, to take back out."""

    def __init__(self):
        self.kernel_flops = 0
        self.hidden_flops = 0


#: the active `count_flops` sessions, (counter, session) pairs, outermost
#: first. A kernel wrapper adds to the sessions whose counter is on ITS
#: thread's dispatch-mode stack (`_active`): a serving engine counting a
#: bucket on the meta device must not take in the kernels another replica
#: launches meanwhile, while the backward of a counted step, which
#: autograd runs on its own thread on the card, inherits that stack and
#: counts. With no count anywhere the check is one global load and a
#: truth test.
_SESSIONS: List[Tuple[object, _Session]] = []


def _active() -> List[_Session]:
    """The sessions whose counter is active on the calling thread."""
    if not _SESSIONS:
        return []
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    ids = set()
    for mode in _get_current_dispatch_mode_stack():
        # FlopCounterMode pushes an inner mode that holds it as `counter`
        ids.update((id(mode), id(getattr(mode, "counter", None))))
    return [s for c, s in _SESSIONS if id(c) in ids]


def counting() -> bool:
    """True inside `count_flops` on this thread (or an autograd thread of
    it): a kernel wrapper given `meta` tensors then only counts (outside a
    count, the meta device has no kernel)."""
    return bool(_active())


def tally_kernel(flops: Callable[[], float]) -> None:
    """A kernel wrapper's launch: add `flops()` to every active count."""
    sessions = _active()
    if sessions:
        n = int(flops())
        for s in sessions:
            s.kernel_flops += n


def plain_route(flops: Callable[[], float], fn, *args, **kwargs):
    """Run a kernel's plain version `fn(*args, **kwargs)` in place of the
    kernel: while a count is active, its aten ops are hidden from the
    counter and the kernel's formula `flops()` is added instead."""
    sessions = _active()
    if not sessions:
        return fn(*args, **kwargs)
    with _counter() as inner:
        out = fn(*args, **kwargs)
    seen, n = inner.get_total_flops(), int(flops())
    for s in sessions:
        s.hidden_flops += seen
        s.kernel_flops += n
    return out


def count_flops(fn, *args, **kwargs) -> int:
    """FLOPs of one call `fn(*args, **kwargs)` (which runs): matmuls and
    convolutions as `FlopCounterMode` counts them, each hand-written kernel
    by its formula, the same on the CPU (plain versions) as on the card.
    Elementwise aten ops count nothing, as in `FlopCounterMode`."""
    session = _Session()
    with _counter() as counter:
        entry = (counter, session)
        _SESSIONS.append(entry)
        try:
            fn(*args, **kwargs)
        finally:
            _SESSIONS.remove(entry)
    return (counter.get_total_flops() - session.hidden_flops
            + session.kernel_flops)
