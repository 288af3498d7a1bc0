"""A/B the space-to-depth stem kernel against the cuDNN stem (counterpart
of `scripts/ab_stem.py`).

Two parts:

- a stem micro-benchmark: `SpaceToDepthStemConvolution(3, 64, 7)` at
  b128, 224x224x3, bf16, forward only, through the stem kernel
  (`pallas_stem=True`: the space-to-depth transform, the weight re-block
  and `csrc/stem_conv.cu`) against the cuDNN stride-2 convolution
  (`pallas_stem=False`), each the median of `iters` calls after a
  warm-up, timed with CUDA events;
- the full loop: `tools/bench.py`'s `bench_resnet50` (b128 bf16 training
  through `DistriOptimizer`) with `BIGDL_TPU_PALLAS_STEM` unset and then
  set, 24 warm-up and 72 timed steps by default, imgs/s for each.

    python -m bigdl_tpu_torch.tools.ab_stem [--micro-only] [--device cuda]

prints one JSON object. On a CPU device (`--device cpu`, for a rehearsal)
the times are the host clock's and carry the device name "cpu".
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.nn.conv import STEM_ENV, SpaceToDepthStemConvolution
from bigdl_tpu_torch.ops import stem_kernel
from bigdl_tpu_torch.tools import bench


def stem_micro(batch: int = 128, hw: int = 224, iters: int = 30,
               dtype: torch.dtype = torch.bfloat16, device=None) -> Dict:
    """The stem layer's forward through the kernel and through cuDNN, on
    the same weights and images (random from seed 0)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    kernel = SpaceToDepthStemConvolution(3, 64, 7, pallas_stem=True,
                                         device=device, generator=gen)
    cudnn = SpaceToDepthStemConvolution(3, 64, 7, pallas_stem=False,
                                        device=device)
    cudnn.load_state_dict(kernel.state_dict())
    kernel.to(dtype)
    cudnn.to(dtype)
    x = torch.from_numpy(np.random.RandomState(0).rand(
        batch, hw, hw, 3).astype(np.float32)).to(device, dtype)
    out = {"batch": batch, "hw": hw, "dtype": str(dtype)[6:],
           "iters": iters}
    with torch.inference_mode():
        before = stem_kernel.stem_conv_forward.launches
        out["kernel_ms"] = bench._median_ms(lambda: kernel(x), iters, device)
        out["kernel_launches"] = \
            stem_kernel.stem_conv_forward.launches - before
        out["cudnn_ms"] = bench._median_ms(lambda: cudnn(x), iters, device)
    out["cudnn_over_kernel"] = out["cudnn_ms"] / out["kernel_ms"]
    out["device"] = bench._device_name(device)
    return out


def full_loop(warmup: int = 24, iters: int = 72, batch_size: int = 128,
              device=None) -> Dict:
    """`bench_resnet50` with the stem switch unset, then set (restored
    afterwards), each on weights drawn from seed 0: imgs/s, ms/step and
    the stem kernel's launches of each."""
    device = resolve_device(device)
    saved = os.environ.pop(STEM_ENV, None)
    out = {}
    try:
        for label, env in (("cudnn", None), ("kernel", "1")):
            if env is not None:
                os.environ[STEM_ENV] = env
            before = stem_kernel.stem_conv_forward.launches
            res = bench.bench_resnet50(batch_size=batch_size, warmup=warmup,
                                 iters=iters, sync=warmup, device=device,
                                 generator=torch.Generator().manual_seed(0))
            out[label] = {k: res[k] for k in ("imgs_per_sec", "ms_per_step",
                                              "steps", "device")}
            out[label]["loss_first"] = res["losses"][0]
            out[label]["loss_last"] = res["losses"][-1]
            out[label]["stem_kernel_launches"] = \
                stem_kernel.stem_conv_forward.launches - before
    finally:
        os.environ.pop(STEM_ENV, None)
        if saved is not None:
            os.environ[STEM_ENV] = saved
    out["kernel_over_cudnn_imgs_per_sec"] = \
        out["kernel"]["imgs_per_sec"] / out["cudnn"]["imgs_per_sec"]
    return out


def main(argv=None) -> None:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--micro-only", action="store_true",
                   help="the stem micro-benchmark only, no training loop")
    p.add_argument("--device", default=None,
                   help="where to run (default: the current CUDA device)")
    args = p.parse_args(argv)
    out = {"stem": stem_micro(device=args.device)}
    if not args.micro_only:
        out["loop"] = full_loop(device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
