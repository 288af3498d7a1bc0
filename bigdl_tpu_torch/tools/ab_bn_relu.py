"""A/B the BN+ReLU kernels (kernels 6-7) of this checkout against another
one (for example the parent commit's tree, unpacked with `git archive`),
on the same card and the same inputs.

For each tree, in the order other, this, this, other, one process with
that tree's `bigdl_tpu_torch` on its path builds the two kernels from the
tree's sources and takes the device time (every kernel a call launches,
under `torch.profiler`, over 20 calls after a warm-up call) of
`bn_relu_forward` and `bn_relu_backward` with y and g bf16 and the ReLU:

- at each of ResNet-50 b128's eight distinct fused sites, with x bf16 and
  with x f32;
- at the zoo's three sites (Inception-v2 b32 7x7 C=352 and 28x28 C=96,
  VggForCifar10's [32, 512]), the backward's g a channel slice of a wider
  `Concat` gradient: where a tree's backward refuses a strided g, the call
  timed is the one its autograd Function makes, the copy and the kernel.

The backward's time is the whole call: where a tree sums the per-tile
partials with a second launch, that launch is in it. Inputs come from a
CUDA generator seeded 0 in every process, so both trees see the same bits;
each tree's y and dx at the sites are saved and compared with
`torch.equal`.

    python -m bigdl_tpu_torch.tools.ab_bn_relu --other DIR [--out DIR]

prints one JSON object. It needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

# (N, C) of the [N, C] view and launches a training step
RESNET50_SITES = ((128 * 112 * 112, 64, 1), (128 * 56 * 56, 64, 6),
                  (128 * 56 * 56, 128, 1), (128 * 28 * 28, 128, 7),
                  (128 * 28 * 28, 256, 1), (128 * 14 * 14, 256, 11),
                  (128 * 14 * 14, 512, 1), (128 * 7 * 7, 512, 5))
# label, N, C, the joined gradient's width and the slice's offset
ZOO_SITES = (("v2 7x7 C=352", 32 * 7 * 7, 352, 1024, 0),
             ("v2 28x28 C=96", 32 * 28 * 28, 96, 256, 64),
             ("cifar vgg [32, 512]", 32, 512, 1024, 256))
REPS = 20
# `_device_ms`'s spin kernels at a window's start, and its idle margins
MARKERS = 64
MARGIN_S = 0.01


def _device_ms(fn):
    """Device ms and device kernels of one call of `fn` (every kernel it
    launches, summed over REPS calls). A profile that lost a device event
    is taken again, up to 3 times in all. Each window opens with MARKERS
    spin kernels, left out of the count (as `tools.bench`'s
    `open_profile_window`, copied here because the other tree may lack
    it): every other window may lose its first 9-12 device records."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(MARKERS):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            time.sleep(MARGIN_S)
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
            time.sleep(MARGIN_S)
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "spin_kernel" not in e.name]
        if len(us) >= REPS and len(us) % REPS == 0:
            break
    return sum(us) / REPS / 1e3, len(us) / REPS


def _worker(save_path: str) -> None:
    """One tree's run: whichever `bigdl_tpu_torch` is on the path."""
    import torch
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import bn_relu_kernel as bk
    _build.build_kernels(["bn_relu_fwd", "bn_relu_bwd"])
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)

    def coeffs(c):
        return (torch.rand((c,), generator=gen, device="cuda") + 0.5,
                torch.randn((c,), generator=gen, device="cuda") * 0.5)

    def backward_call(x, s, b, g):
        try:
            bk.bn_relu_backward(x, s, b, g, True)
            return lambda: bk.bn_relu_backward(x, s, b, g, True)
        except ValueError:  # a tree that copies a strided g first
            return lambda: bk.bn_relu_backward(x, s, b, g.contiguous(),
                                               True)

    out, saved = {"resnet50": [], "zoo": []}, {}
    with torch.inference_mode():
        for n, c, per_step in RESNET50_SITES:
            x32 = torch.randn((n, c), generator=gen, device="cuda")
            s, b = coeffs(c)
            g = torch.randn((n, c), generator=gen, device="cuda").to(bf)
            for x in (x32.to(bf), x32):
                y = bk.bn_relu_forward(x, s, b, True, bf)
                dx = bk.bn_relu_backward(x, s, b, g, True)[0]
                if x.dtype == bf and n * c <= 1 << 24:
                    saved[f"{n}x{c}"] = (y.cpu(), dx.cpu())
                del y, dx
                fwd = _device_ms(lambda: bk.bn_relu_forward(x, s, b, True,
                                                            bf))
                bwd = _device_ms(backward_call(x, s, b, g))
                out["resnet50"].append({
                    "site": [n, c], "launches_per_step": per_step,
                    "x": str(x.dtype)[6:], "fwd_device_ms": fwd[0],
                    "bwd_device_ms": bwd[0],
                    "bwd_kernels_per_call": bwd[1]})
            del x32, g
        for label, n, c, width, offset in ZOO_SITES:
            x32 = torch.randn((n, c), generator=gen, device="cuda")
            s, b = coeffs(c)
            g = torch.randn((n, width), generator=gen, device="cuda").to(
                bf)[:, offset:offset + c]
            for x in (x32.to(bf), x32):
                fwd = _device_ms(lambda: bk.bn_relu_forward(x, s, b, True,
                                                            bf))
                bwd = _device_ms(backward_call(x, s, b, g))
                out["zoo"].append({
                    "site": label, "x": str(x.dtype)[6:],
                    "fwd_device_ms": fwd[0], "bwd_device_ms": bwd[0],
                    "bwd_kernels_per_call": bwd[1]})
    if not os.path.exists(save_path):
        torch.save(saved, save_path)
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))


def main(argv=None) -> None:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", help="root of the other checkout")
    p.add_argument("--out", default="build/ab_bn_relu",
                   help="where each tree's y and dx are saved")
    p.add_argument("--worker", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        _worker(args.worker)
        return
    if not args.other:
        p.error("--other is required")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ab_bn_relu needs a CUDA device")
    this = Path(__file__).resolve().parents[2]
    other = Path(args.other).resolve()
    out_dir = Path(args.out).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.glob("*.pt"):
        f.unlink()
    runs = []
    for label, root in (("other", other), ("this", this), ("this", this),
                        ("other", other)):
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(out_dir / f"{label}.pt")], cwd=root,
            env={**os.environ, "PYTHONPATH": str(root)},
            capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise SystemExit(f"the {label} tree's run failed:\n{res.stderr}")
        runs.append({"tree": label,
                     **json.loads(res.stdout.strip().splitlines()[-1])})
    a, b = (torch.load(out_dir / f"{x}.pt") for x in ("other", "this"))
    bitwise = {site: torch.equal(a[site][0], b[site][0])
               and torch.equal(a[site][1], b[site][1]) for site in a}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "other": str(other),
                      "y_dx_bitwise_equal": bitwise, "runs": runs}))


if __name__ == "__main__":
    main()
