"""Training throughput of the port (counterpart of
`bigdl_tpu/tools/bench_cli.py` `_framework_throughput`, `bench_resnet50`
and its transformer-LM block), and its long-context attention figures
(`bench_attention`).

The model trains through `DistriOptimizer` with `SGD(learning_rate=0.01,
momentum=0.9)` and bf16 compute with f32 masters, on ONE synthetic batch
from `np.random.RandomState(0)` that is placed on the device once and
reused every step (the reference's resident batch). Steps are queued
without waiting and the host syncs every `sync` steps; the rate is
`sync * records` over the median interval between sync points after the
warm-up. The result also carries every step's loss.

- ResNet-50: b128 images at 224x224x3, `ClassNLLCriterion`; imgs/s.
- TransformerLM (`--model lm`): vocab 1024, embed 512, 4 layers, 8 heads,
  b8 at T=2048, `TimeDistributedCriterion(ClassNLLCriterion())` with the
  reference's default `size_average=False` (a sum over T, so the loss
  grows with T and this recipe diverges after a few steps, in the
  reference as here); tokens/s.

    python -m bigdl_tpu_torch.tools.bench                       # ResNet-50
    python -m bigdl_tpu_torch.tools.bench --model lm            # the LM
    python -m bigdl_tpu_torch.tools.bench [--model lm] --profile
    python -m bigdl_tpu_torch.tools.bench --model attention [--profile]
    python -m bigdl_tpu_torch.tools.bench --model serve [--profile]

`--model serve` times one b32 forward of the served ResNet-50
(`LocalPredictor` over `ResNet50(class_num=1000, s2d_stem=True)`, f32,
TF32 off) with the stem kernel off and on; with `--profile`, the device
time by kind of kernel with it on.

prints one JSON object. `--profile` gives device time by kind of kernel.
The benchmark needs a CUDA device unless called with `device="cpu"`; the
profile always does.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
from bigdl_tpu_torch.nn.conv import STEM_ENV
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.optim import SGD, DistriOptimizer, max_iteration


def _resident_optimizer(model: torch.nn.Module, x: np.ndarray,
                        y: np.ndarray, criterion,
                        device: torch.device) -> DistriOptimizer:
    """The benchmark's optimizer over one batch (x, y) placed on `device`
    once."""
    batch = MiniBatch(torch.from_numpy(x).to(device),
                      torch.from_numpy(y).to(device))
    opt = DistriOptimizer(model, LocalDataSet([batch]), criterion,
                          devices=[device])
    opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
    return opt.set_compute_precision("bfloat16")


def _image_batch(in_shape: Sequence[int], n_class: int, batch_size: int):
    rs = np.random.RandomState(0)
    x = rs.rand(batch_size, *in_shape).astype(np.float32)
    y = (rs.randint(0, n_class, size=batch_size) + 1).astype(np.int32)
    return x, y


def _token_batch(vocab: int, seq: int, batch_size: int):
    """1-based tokens [B, T+1] from `RandomState(0)`: inputs are the first
    T, targets the last T (the reference's next-token batch)."""
    rs = np.random.RandomState(0)
    toks = rs.randint(1, vocab + 1, (batch_size, seq + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _timed_run(opt: DistriOptimizer, warmup: int, iters: int, sync: int):
    """Run `warmup + iters` steps, syncing every `sync`; returns the median
    sync-window length (s) after the warm-up and every step's loss."""
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
    return float(np.median(intervals)), [float(v) for v in losses]


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else device.type


def framework_throughput(model: torch.nn.Module, in_shape: Sequence[int],
                         n_class: int, batch_size: int, warmup: int,
                         iters: int, sync: int = 4, device=None) -> Dict:
    """Train `model` (already on `device`) for `warmup + iters` steps on a
    resident batch of NHWC `in_shape` images; returns imgs/s, ms/step and
    the losses. `warmup` and `iters` are rounded to whole sync windows."""
    device = resolve_device(device)
    sync = math.gcd(math.gcd(warmup, iters), sync)  # windows tile the run
    opt = _resident_optimizer(model, *_image_batch(in_shape, n_class,
                                                   batch_size),
                              ClassNLLCriterion(), device)
    window_s, losses = _timed_run(opt, warmup, iters, sync)
    return {"imgs_per_sec": sync * batch_size / window_s,
            "ms_per_step": 1e3 * window_s / sync,
            "batch_size": batch_size, "steps": warmup + iters,
            "warmup": warmup, "sync": sync, "losses": losses,
            "device": _device_name(device)}


def lm_throughput(model: torch.nn.Module, vocab: int, seq: int,
                  batch_size: int, warmup: int, iters: int, sync: int = 4,
                  device=None) -> Dict:
    """Train the `TransformerLM` `model` (already on `device`) for
    `warmup + iters` steps on a resident batch of `batch_size` sequences
    of `seq` tokens; returns tokens/s, ms/step and the losses."""
    device = resolve_device(device)
    sync = math.gcd(math.gcd(warmup, iters), sync)
    opt = _resident_optimizer(model, *_token_batch(vocab, seq, batch_size),
                              TimeDistributedCriterion(ClassNLLCriterion()),
                              device)
    window_s, losses = _timed_run(opt, warmup, iters, sync)
    return {"tokens_per_sec": sync * batch_size * seq / window_s,
            "ms_per_step": 1e3 * window_s / sync,
            "batch_size": batch_size, "seq": seq, "steps": warmup + iters,
            "warmup": warmup, "sync": sync, "losses": losses,
            "device": _device_name(device)}


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


def _lm(vocab: int, device, generator=None):
    from bigdl_tpu_torch.models.transformer import TransformerLM
    return TransformerLM(vocab, embed_dim=512, n_layer=4, n_head=8,
                         device=device, generator=generator)


def bench_transformer_lm(batch_size: int = 8, seq: int = 2048,
                         vocab: int = 1024, warmup: int = 12,
                         iters: int = 36, sync: int = 12, device=None,
                         generator: Optional[torch.Generator] = None
                         ) -> Dict:
    """`TransformerLM(vocab, embed 512, 4 layers, 8 heads)`, random weights
    from `generator` (default seed 0), trained as `bench_cli.py`'s LM block
    does (48 steps, sync every 12, timed after the first window)."""
    device = resolve_device(device)
    return lm_throughput(_lm(vocab, device, generator), vocab, seq,
                         batch_size, warmup, iters, sync=sync, device=device)


def _median_ms(fn, reps: int, device: torch.device) -> float:
    """Median time of one call of `fn` over `reps` calls after one
    warm-up: CUDA events around each call on a CUDA device, the host clock
    elsewhere."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def _sp_mesh(device: torch.device, length: int):
    """The sequence-parallel mesh of the attention figures: every CUDA
    device when there are two or more, else 4 shards on `device`; and the
    sequence length, `length` rounded down to a multiple of 2n."""
    from bigdl_tpu_torch.parallel import build_mesh
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 0
    devices = ([torch.device("cuda", i) for i in range(n_dev)]
               if n_dev >= 2 else [device] * 4)
    n = len(devices)
    return build_mesh(data=n, devices=devices), {
        "seq": max(1, length // (2 * n)) * 2 * n, "shards": n,
        "mesh": [str(x) for x in devices], "one_device": n_dev < 2}


def bench_attention(device=None, lengths: Sequence[int] = (8192, 16384),
                    naive_max: int = 8192, ring_len: int = 8192,
                    reps: int = 10,
                    generator: Optional[torch.Generator] = None) -> Dict:
    """The long-context attention figures of `bench_cli.py`'s
    `bench_attention` (its LM block is `--model lm` here), at B=1, H=8,
    D=64, bf16, causal: the flash forward (kernel 1) and forward plus
    backward (kernels 1, 3, 4; gradients for q, k and v) at each of
    `lengths`, naive attention at lengths up to `naive_max`, and ring
    against zigzag sequence parallelism (kernel 2) at
    `ring_len // 2n * 2n` over a mesh of every CUDA device when there are
    two or more, else of 4 shards on the one device. TFLOP/s use the
    reference's counts: causal forward 2*B*H*T^2*D*2/2, forward plus
    backward 7*B*H*T^2*D*2/2."""
    from bigdl_tpu_torch.ops.attention_kernel import (flash_attention,
                                                      flash_attention_forward,
                                                      naive_attention)
    from bigdl_tpu_torch.parallel import make_sequence_parallel_attention
    device = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(0)
    b, h, d, dtype = 1, 8, 64, torch.bfloat16

    def qkv(t):
        return [torch.randn((b, h, t, d), generator=gen).to(device, dtype)
                for _ in range(3)]

    def fwd_flops(t):
        return 2 * b * h * t * t * d * 2 / 2

    def tflops(fl, ms):
        return fl / (ms * 1e-3) / 1e12

    out = {"batch": b, "heads": h, "head_dim": d, "dtype": "bfloat16",
           "causal": True, "reps": reps, "device": _device_name(device),
           "timer": "cuda_events" if device.type == "cuda"
           else "host_clock", "flash": [], "flash_fwd_bwd": [], "naive": []}
    for t in lengths:
        q, k, v = qkv(t)
        with torch.no_grad():
            ms = _median_ms(lambda: flash_attention_forward(
                q, k, v, causal=True), reps, device)
        out["flash"].append({"seq": t, "ms": ms,
                             "tflops": tflops(fwd_flops(t), ms)})
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        ms_bwd = _median_ms(lambda: torch.autograd.grad(
            flash_attention(qg, kg, vg, True).float().sum(), (qg, kg, vg)),
            reps, device)
        out["flash_fwd_bwd"].append({"seq": t, "ms": ms_bwd, "tflops":
                                     tflops(3.5 * fwd_flops(t), ms_bwd)})
        del qg, kg, vg
        if t <= naive_max:
            with torch.no_grad():
                nms = _median_ms(lambda: naive_attention(
                    q, k, v, causal=True), reps, device)
            out["naive"].append({"seq": t, "ms": nms,
                                 "tflops": tflops(fwd_flops(t), nms),
                                 "flash_speedup": nms / ms})

    mesh, sp = _sp_mesh(device, ring_len)
    q, k, v = qkv(sp["seq"])
    for scheme in ("ring", "zigzag"):
        fn = make_sequence_parallel_attention(mesh, scheme, causal=True)
        with torch.no_grad():
            ms = _median_ms(lambda: fn(q, k, v), reps, device)
        sp[scheme] = {"ms": ms, "tflops": tflops(fwd_flops(sp["seq"]), ms)}
    out["sequence_parallel"] = sp
    return out


#: kernel-name fragments of each kind in the profiles, tried in order
_KERNEL_KINDS = (
    ("flash_attention_fwd (csrc, kernel 1)",
     ("flash_fwd_kernel", "flash_fwd_tc_kernel")),
    ("flash_attention_carry (csrc, kernel 2)",
     ("flash_carry_kernel", "flash_carry_tc_kernel")),
    ("flash_attention_bwd_dq (csrc, kernel 3)",
     ("flash_attention_bwd_dq",)),
    ("flash_attention_bwd_dkv (csrc, kernel 4)",
     ("flash_attention_bwd_dkv",)),
    ("bn_relu (csrc)", ("bn_relu_fwd", "bn_relu_bwd")),
    ("stem_conv (csrc, kernel 5)", ("stem_conv_kernel",
                                    "stem_conv_tc_kernel")),
    ("convolution and matmul (cuDNN, cuBLAS)",
     ("conv", "xmma", "gemm", "nvjet", "cudnn", "cutlass", "dgrad", "wgrad",
      "fprop")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def _kind(name: str) -> str:
    low = name.lower()
    for kind, parts in _KERNEL_KINDS:
        if any(p in low for p in parts):
            return kind
    return "other"


def _profile(opt: DistriOptimizer, warmup: int, steps: int, top: int,
             device: torch.device) -> Dict:
    """Where the device time of `opt`'s training goes: after `warmup`
    steps, `steps` more under `torch.profiler`. Returns the device-busy
    and idle shares of the profiled wall time (host clock, from a drained
    device to a drained device), device ms per step by kind of kernel, and
    the `top` kernels by device time."""
    opt.set_sync_interval(warmup)
    opt.set_end_when(max_iteration(warmup))
    opt.optimize()
    torch.cuda.synchronize(device)
    opt.set_sync_interval(steps)
    opt.set_end_when(max_iteration(warmup + steps))
    return _profiled(opt.optimize, steps, top, device)


def _profiled(run, steps: int, top: int, device: torch.device) -> Dict:
    """Run `run()` (`steps` steps, the device drained before) under
    `torch.profiler` and summarise where its device time goes."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
    return {"steps": steps,
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


def _cuda_only(device, what: str) -> torch.device:
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"{what} measures the CUDA device")
    return device


def profile_resnet50(batch_size: int = 128, warmup: int = 8, steps: int = 8,
                     top: int = 15, device=None,
                     generator: Optional[torch.Generator] = None) -> Dict:
    """`_profile` of the ResNet-50 benchmark configuration."""
    from bigdl_tpu_torch.models.resnet import ResNet50
    device = _cuda_only(device, "profile_resnet50")
    model = ResNet50(class_num=1000, s2d_stem=True, device=device,
                     generator=generator)
    opt = _resident_optimizer(model, *_image_batch((224, 224, 3), 1000,
                                                   batch_size),
                              ClassNLLCriterion(), device)
    return {"batch_size": batch_size,
            **_profile(opt, warmup, steps, top, device)}


def _served_resnet50(batch_size: int, device: torch.device,
                     generator: Optional[torch.Generator]):
    """The served configuration: `ResNet50(class_num=1000, s2d_stem=True)`
    through a `LocalPredictor` (the converted copy: 52 BNs folded, the
    stem's kept), and one b`batch_size` image batch on `device`."""
    from bigdl_tpu_torch.models.resnet import ResNet50
    from bigdl_tpu_torch.optim.predictor import LocalPredictor
    model = ResNet50(class_num=1000, s2d_stem=True, device=device,
                     generator=generator)
    pred = LocalPredictor(model, batch_size=batch_size, device=device)
    x, _ = _image_batch((224, 224, 3), 1000, batch_size)
    return pred, torch.from_numpy(x).to(device)


@contextlib.contextmanager
def _serving_settings(stem_kernel: bool):
    """f32 convolutions without TF32, and the stem switch set or unset,
    for the block; both restored after."""
    saved = (os.environ.pop(STEM_ENV, None), torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    if stem_kernel:
        os.environ[STEM_ENV] = "1"
    try:
        yield
    finally:
        os.environ.pop(STEM_ENV, None)
        if saved[0] is not None:
            os.environ[STEM_ENV] = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]


def bench_resnet50_serving(batch_size: int = 32, reps: int = 20,
                           device=None,
                           generator: Optional[torch.Generator] = None
                           ) -> Dict:
    """Median ms of one forward of the served ResNet-50 (f32, TF32 off)
    with the stem switch unset (cuDNN stem) and set (the stem kernel)."""
    device = resolve_device(device)
    pred, x = _served_resnet50(batch_size, device, generator)
    out = {"batch_size": batch_size, "reps": reps,
           "device": _device_name(device),
           "timer": "cuda_events" if device.type == "cuda"
           else "host_clock"}
    for label, on in (("cudnn_stem_ms", False), ("stem_kernel_ms", True)):
        with _serving_settings(on):
            out[label] = _median_ms(lambda: pred._forward(x), reps, device)
    return out


def profile_resnet50_serving(batch_size: int = 32, forwards: int = 8,
                             top: int = 15, device=None,
                             generator: Optional[torch.Generator] = None
                             ) -> Dict:
    """`_profiled` of the served ResNet-50 with the stem kernel on (f32,
    TF32 off): `forwards` forwards after one warm-up; a "step" in the
    summary is one forward."""
    device = _cuda_only(device, "profile_resnet50_serving")
    pred, x = _served_resnet50(batch_size, device, generator)
    with _serving_settings(True):
        pred._forward(x)
        torch.cuda.synchronize(device)
        return {"batch_size": batch_size, **_profiled(
            lambda: [pred._forward(x) for _ in range(forwards)], forwards,
            top, device)}


def profile_transformer_lm(batch_size: int = 8, seq: int = 2048,
                           vocab: int = 1024, warmup: int = 4,
                           steps: int = 4, top: int = 15, device=None,
                           generator: Optional[torch.Generator] = None
                           ) -> Dict:
    """`_profile` of the TransformerLM benchmark configuration."""
    device = _cuda_only(device, "profile_transformer_lm")
    opt = _resident_optimizer(_lm(vocab, device, generator),
                              *_token_batch(vocab, seq, batch_size),
                              TimeDistributedCriterion(ClassNLLCriterion()),
                              device)
    return {"batch_size": batch_size, "seq": seq,
            **_profile(opt, warmup, steps, top, device)}


def _launch_us(run, part: str, device: torch.device) -> list:
    """Device time (us) of each launch of the kernels whose name contains
    `part` during one `run()`, in launch order."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize(device)
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and part in e.name),
                    key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() for e in events]


def profile_attention(seq: int = 8192, calls: int = 4, top: int = 8,
                      device=None,
                      generator: Optional[torch.Generator] = None) -> Dict:
    """`_profiled` of ring, zigzag and Ulysses attention at
    `bench_attention`'s sequence-parallel shape (B=1, H=8, D=64, bf16,
    causal, its mesh): `calls` calls of each after one warm-up call; a
    "step" in the summary is one call. For ring and zigzag also the
    device time of each kernel-2 launch (one hop) of one more call, in
    launch order."""
    from bigdl_tpu_torch.parallel import make_sequence_parallel_attention
    device = _cuda_only(device, "profile_attention")
    gen = generator or torch.Generator().manual_seed(0)
    mesh, out = _sp_mesh(device, seq)
    q, k, v = (torch.randn((1, 8, out["seq"], 64), generator=gen)
               .to(device, torch.bfloat16) for _ in range(3))
    for scheme in ("ring", "zigzag", "ulysses"):
        fn = make_sequence_parallel_attention(mesh, scheme, causal=True)
        with torch.no_grad():
            fn(q, k, v)
            torch.cuda.synchronize(device)
            out[scheme] = _profiled(
                lambda: [fn(q, k, v) for _ in range(calls)], calls, top,
                device)
            if scheme != "ulysses":
                out[scheme]["kernel2_launch_us"] = _launch_us(
                    lambda: fn(q, k, v), "flash_carry", device)
    return out


def main(argv=None) -> None:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", choices=("resnet50", "serve", "lm",
                                       "attention"), default="resnet50")
    p.add_argument("--profile", action="store_true",
                   help="device time by kind of kernel (torch.profiler)")
    args = p.parse_args(argv)
    if args.model == "attention":
        fn = profile_attention if args.profile else bench_attention
    elif args.model == "serve":
        fn = profile_resnet50_serving if args.profile \
            else bench_resnet50_serving
    elif args.model == "lm":
        fn = profile_transformer_lm if args.profile else bench_transformer_lm
    else:
        fn = profile_resnet50 if args.profile else bench_resnet50
    print(json.dumps(fn()))


if __name__ == "__main__":
    main()
