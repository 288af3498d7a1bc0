"""Training throughput of the port (counterpart of
`bigdl_tpu/tools/bench_cli.py` `_framework_throughput` and
`bench_resnet50`).

The model trains through `DistriOptimizer` with `ClassNLLCriterion`,
`SGD(learning_rate=0.01, momentum=0.9)` and bf16 compute with f32 masters,
on ONE synthetic batch from `np.random.RandomState(0)` that is placed on
the device once and reused every step (the reference's resident batch).
Steps are queued without waiting and the host syncs every `sync` steps;
imgs/s is `sync * batch_size` over the median interval between sync
points after the warm-up. The result also carries every step's loss.

    python -m bigdl_tpu_torch.tools.bench             # ResNet-50, b128
    python -m bigdl_tpu_torch.tools.bench --profile   # device time by kernel

prints one JSON object. The benchmark needs a CUDA device unless called
with `device="cpu"`; the profile always does.
"""

from __future__ import annotations

import json
import math
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
from bigdl_tpu_torch.optim import SGD, DistriOptimizer, max_iteration


def _resident_optimizer(model: torch.nn.Module, in_shape: Sequence[int],
                        n_class: int, batch_size: int,
                        device: torch.device) -> DistriOptimizer:
    """The benchmark's optimizer over one synthetic batch placed on
    `device` once."""
    rs = np.random.RandomState(0)
    x = rs.rand(batch_size, *in_shape).astype(np.float32)
    y = (rs.randint(0, n_class, size=batch_size) + 1).astype(np.int32)
    batch = MiniBatch(torch.from_numpy(x).to(device),
                      torch.from_numpy(y).to(device))
    opt = DistriOptimizer(model, LocalDataSet([batch]), ClassNLLCriterion(),
                          devices=[device])
    opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
    return opt.set_compute_precision("bfloat16")


def framework_throughput(model: torch.nn.Module, in_shape: Sequence[int],
                         n_class: int, batch_size: int, warmup: int,
                         iters: int, sync: int = 4, device=None) -> Dict:
    """Train `model` (already on `device`) for `warmup + iters` steps on a
    resident batch of NHWC `in_shape` images; returns imgs/s, ms/step and
    the losses. `warmup` and `iters` are rounded to whole sync windows."""
    device = resolve_device(device)
    sync = math.gcd(math.gcd(warmup, iters), sync)  # windows tile the run
    opt = _resident_optimizer(model, in_shape, n_class, batch_size, device)
    opt.set_sync_interval(sync)
    opt.set_end_when(max_iteration(warmup + iters))
    times, losses = [], []

    def hook(state):
        losses.append(opt.last_loss)
        if state["neval"] % sync == 0:  # the device has drained here
            times.append(time.perf_counter())
        if state["neval"] == warmup:
            opt.metrics.reset()  # keep the warm-up out of the phase table

    opt.set_iteration_hook(hook)
    opt.optimize()
    intervals = np.diff(times[warmup // sync - 1:])
    window_s = float(np.median(intervals))
    return {"imgs_per_sec": sync * batch_size / window_s,
            "ms_per_step": 1e3 * window_s / sync,
            "batch_size": batch_size, "steps": warmup + iters,
            "warmup": warmup, "sync": sync,
            "losses": [float(v) for v in losses],
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else device.type)}


def bench_resnet50(batch_size: int = 128, warmup: int = 216,
                   iters: int = 648, sync: int = 216, device=None,
                   generator: Optional[torch.Generator] = None) -> Dict:
    """`ResNet50(class_num=1000, s2d_stem=True)` at 224x224x3, random
    weights from `generator` (default seed 0)."""
    from bigdl_tpu_torch.models.resnet import ResNet50
    device = resolve_device(device)
    model = ResNet50(class_num=1000, s2d_stem=True, device=device,
                     generator=generator)
    return framework_throughput(model, (224, 224, 3), 1000, batch_size,
                                warmup, iters, sync=sync, device=device)


#: kernel-name fragments of each kind in `profile_resnet50`, tried in order
_KERNEL_KINDS = (
    ("bn_relu (csrc)", ("bn_relu_fwd", "bn_relu_bwd")),
    ("convolution", ("conv", "xmma", "gemm", "cudnn", "cutlass", "dgrad",
                     "wgrad", "fprop")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def _kind(name: str) -> str:
    low = name.lower()
    for kind, parts in _KERNEL_KINDS:
        if any(p in low for p in parts):
            return kind
    return "other"


def profile_resnet50(batch_size: int = 128, warmup: int = 8, steps: int = 8,
                     top: int = 15, device=None,
                     generator: Optional[torch.Generator] = None) -> Dict:
    """Where the device time of the benchmark configuration goes: after
    `warmup` steps, `steps` more under `torch.profiler`. Returns the
    device-busy and idle shares of the profiled wall time (host clock,
    from a drained device to a drained device), device ms per step by
    kind of kernel, and the `top` kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.models.resnet import ResNet50
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("profile_resnet50 measures the CUDA device")
    model = ResNet50(class_num=1000, s2d_stem=True, device=device,
                     generator=generator)
    opt = _resident_optimizer(model, (224, 224, 3), 1000, batch_size, device)
    opt.set_sync_interval(warmup)
    opt.set_end_when(max_iteration(warmup))
    opt.optimize()
    torch.cuda.synchronize(device)
    opt.set_sync_interval(steps)
    opt.set_end_when(max_iteration(warmup + steps))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize(device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name: Dict[str, list] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        acc = by_name.setdefault(e.name, [0, 0.0])
        acc[0] += 1
        acc[1] += e.time_range.elapsed_us() / 1e3
    if not by_name:
        raise RuntimeError("the profiler recorded no device events")
    busy_ms = sum(ms for _, ms in by_name.values())
    kinds: Dict[str, float] = {}
    for name, (_, ms) in by_name.items():
        kinds[_kind(name)] = kinds.get(_kind(name), 0.0) + ms / steps
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"batch_size": batch_size, "steps": steps,
            "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "kernel_launches_per_step": sum(
                n for n, _ in by_name.values()) / steps,
            "ms_per_step_by_kind": dict(sorted(kinds.items(),
                                               key=lambda kv: -kv[1])),
            "top_kernels": [{"name": name[:120], "kind": _kind(name),
                             "calls_per_step": n / steps,
                             "ms_per_step": ms / steps}
                            for name, (n, ms) in ranked],
            "device": torch.cuda.get_device_name(device)}


if __name__ == "__main__":
    import sys
    if "--profile" in sys.argv[1:]:
        print(json.dumps(profile_resnet50()))
    else:
        print(json.dumps(bench_resnet50()))
