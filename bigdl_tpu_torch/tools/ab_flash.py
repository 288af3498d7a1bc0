"""A/B the flash-attention kernels of this checkout against another one
(for example the parent commit's tree, unpacked with `git archive`), on
the same card and the same inputs.

For each tree, in the order other, this, this, other, one process with
that tree's `bigdl_tpu_torch` on its path builds the kernels from the
tree's sources and:

- runs kernel 1 (`flash_attention_forward`) in bf16 at three shapes: the
  LM training shape (B8 H8 T2048 D64 causal), the long-context shape (B1
  H8 T=8192 D64 causal) and a ragged one (B2 H4 Tq1000 Tk1100 D40 causal,
  q_offset 101), saves O and lse from its first run, and times each call;
- times kernel 2 (`flash_attention_carry`) in bf16 at the ring's and
  zigzag's hop shapes (B1 H8 D64: 2048x2048 below the diagonal and on it,
  a 1024x1024 non-causal chunk).

Times are the mean of 20 calls after 3 warm-up calls (CUDA events).
Inputs come from a CUDA generator seeded 0 in every process, so both trees
see the same bits. Kernel 1's O and lse of the two trees are compared
with `torch.equal`.

    python -m bigdl_tpu_torch.tools.ab_flash --other DIR [--out DIR]

prints one JSON object. It needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

# name, b, h, tq, tk, d, causal, q_offset, k_offset
KERNEL1_SHAPES = (
    ("LM B8 H8 T2048 D64 causal", 8, 8, 2048, 2048, 64, True, 0, 0),
    ("B1 H8 T8192 D64 causal", 1, 8, 8192, 8192, 64, True, 0, 0),
    ("B2 H4 Tq1000 Tk1100 D40 causal q_offset 101", 2, 4, 1000, 1100, 40,
     True, 101, 0))
# name, t, causal, q_offset, k_offset (B1 H8 D64)
HOPS = (("ring below-diagonal hop", 2048, True, 2048, 0),
        ("ring diagonal hop", 2048, True, 2048, 2048),
        ("zigzag chunk", 1024, False, 6144, 1024))
ITERS = 20


def _cuda_ms(fn):
    import torch
    for _ in range(3):
        fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(ITERS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / ITERS


def _worker(save_path: str) -> None:
    """One tree's run: whichever `bigdl_tpu_torch` is on the path."""
    import torch
    from bigdl_tpu_torch.ops import attention_kernel as ak
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen,
                           device="cuda").to(torch.bfloat16)

    out, saved = {"kernel1": [], "kernel2": []}, {}
    with torch.inference_mode():
        for name, b, h, tq, tk, d, causal, q_off, k_off in KERNEL1_SHAPES:
            q, k, v = rand(b, h, tq, d), rand(b, h, tk, d), rand(b, h, tk, d)
            kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
            o, lse = ak.flash_attention_forward(q, k, v, return_lse=True,
                                                **kw)
            saved[name] = (o.cpu(), lse.cpu())
            out["kernel1"].append({"case": name, "ms": _cuda_ms(
                lambda: ak.flash_attention_forward(q, k, v, **kw))})
        for name, t, causal, q_off, k_off in HOPS:
            q, k, v, k0, v0 = (rand(1, 8, t, 64) for _ in range(5))
            carry = ak.flash_attention_carry_plain(
                q, k0, v0, ak.attention_state_init(q))
            kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
            out["kernel2"].append({"case": name, "ms": _cuda_ms(
                lambda: ak.flash_attention_carry(q, k, v, carry, **kw))})
    if not os.path.exists(save_path):
        torch.save(saved, save_path)
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))


def main(argv=None) -> None:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", help="root of the other checkout")
    p.add_argument("--out", default="build/ab_flash",
                   help="where each tree's kernel-1 outputs are saved")
    p.add_argument("--worker", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        _worker(args.worker)
        return
    if not args.other:
        p.error("--other is required")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ab_flash needs a CUDA device")
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
    bitwise = {name: {"o": torch.equal(a[name][0], b[name][0]),
                      "lse": torch.equal(a[name][1], b[name][1])}
               for name in a}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "other": str(other),
                      "kernel1_bf16_bitwise_equal": bitwise, "runs": runs}))


if __name__ == "__main__":
    main()
