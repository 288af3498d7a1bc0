"""A/B the training loop's observability (`bigdl_tpu_torch.observability`)
against the plain loop: what the instrumentation costs a step.

Four configurations of the same optimizer, in turns (plain first), each
from the same weights (put back before every turn):

- "plain": no telemetry, tracer or monitor;
- "telemetry": `Telemetry(InMemorySink(), grad_norms=True)` and a
  `SpanTracer` (the step computes the two global norms);
- "skip": `NanGuard("skip", check_grads=False)` alone (the step flags a
  non-finite loss and reverts its update on the device);
- "full": the telemetry, the tracer, `NanGuard("skip")`,
  `StragglerDetector` and `ThroughputMonitor`.

Each turn is `tools/bench.py`'s timed run (ms a step: the median host
interval between drained-device points every `sync` steps after the
warm-up) or, with `--profile`, its profile (device busy ms, idle share
and launches a step; the spans' `record_function` ranges show there as
device events of the kind "other", which the busy figure leaves out).
Models: the LM (`--model lm`: b8, T=2048, clipped at 1.0, as
`chip_smoke.py` phase 11(d)) and ResNet-50 (`--model resnet50`: b128),
bf16 compute with f32 masters, SGD momentum 0.9, one resident batch.

    python -m bigdl_tpu_torch.tools.ab_observability [--model lm|resnet50]
        [--profile] [--turns 2] [--device cuda]

prints one JSON object. On a CPU device (`--device cpu`, a rehearsal)
the times are the host clock's and there is no profile.
"""

from __future__ import annotations

import json
from typing import Dict

import torch

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
from bigdl_tpu_torch.observability import (InMemorySink, NanGuard,
                                           SpanTracer, StragglerDetector,
                                           Telemetry, ThroughputMonitor)
from bigdl_tpu_torch.tools import bench

CONFIGS = ("plain", "telemetry", "skip", "full")


def instrument(opt, how: str) -> None:
    """Attach configuration `how`'s instrumentation to `opt`."""
    if how in ("telemetry", "full"):
        opt.set_telemetry(Telemetry(InMemorySink(), grad_norms=True))
        opt.set_tracer(SpanTracer(process_name=f"ab_observability {how}"))
    if how == "skip":
        opt.set_health_monitors(NanGuard("skip", check_grads=False))
    elif how == "full":
        opt.set_health_monitors(NanGuard("skip"), StragglerDetector(),
                                ThroughputMonitor())


def _model(name: str, device: torch.device):
    """(model, batch, criterion, clip) of the configuration `name`."""
    gen = torch.Generator().manual_seed(0)
    if name == "lm":
        return (bench._lm(1024, device, gen), bench._token_batch(1024, 2048, 8),
                TimeDistributedCriterion(ClassNLLCriterion()), 1.0)
    from bigdl_tpu_torch.models.resnet import ResNet50
    return (ResNet50(class_num=1000, s2d_stem=True, device=device,
                     generator=gen),
            bench._image_batch((224, 224, 3), 1000, 128),
            ClassNLLCriterion(), None)


def ab(model: str = "resnet50", turns: int = 2, profile: bool = False,
       warmup: int = 4, iters: int = 12, sync: int = 4,
       device=None) -> Dict:
    """`turns` rounds of the four configurations on `model`."""
    device = resolve_device(device)
    net, batch, crit, clip = _model(model, device)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    runs = []
    for _ in range(turns):
        for how in CONFIGS:
            with torch.no_grad():
                for k, v in net.state_dict().items():
                    v.copy_(start[k])
            opt = bench._resident_optimizer(net, *batch, crit, device)
            if clip is not None:
                opt.set_gradient_clipping_by_l2_norm(clip)
            instrument(opt, how)
            if profile:
                res = bench._profile(opt, warmup, iters, 8, device)
                other = res["ms_per_step_by_kind"].get("other", 0.0)
                runs.append({"how": how, "wall_ms": res["wall_ms_per_step"],
                             "device_busy_ms":
                                 res["device_busy_ms_per_step"] - other,
                             "launches": res["kernel_launches_per_step"],
                             "annotation_ms": other})
            else:
                window_s, losses = bench._timed_run(opt, warmup, iters,
                                                    sync)
                runs.append({"how": how, "ms": 1e3 * window_s / sync,
                             "last_loss": losses[-1]})
            del opt
    key = "wall_ms" if profile else "ms"
    mean = {how: sum(r[key] for r in runs if r["how"] == how) / turns
            for how in CONFIGS}
    return {"model": model, "device": bench._device_name(device),
            "warmup": warmup, "iters": iters, "sync": sync,
            "profile": profile, "runs": runs, f"mean_{key}": mean,
            "overhead_ms": {how: mean[how] - mean["plain"]
                            for how in CONFIGS[1:]}}


def main(argv=None) -> None:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", choices=("resnet50", "lm"), default="resnet50")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(json.dumps(ab(args.model, args.turns, args.profile,
                        device=args.device)))


if __name__ == "__main__":
    main()
