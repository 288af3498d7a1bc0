#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (`bigdl_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases:
1. device: print the card's name and power limit (`nvidia-smi`); no CUDA
   device is a failure;
2. build: compile every CUDA kernel of the port from `bigdl_tpu_torch/csrc`
   with `nvcc` (one process per source, started together); for the
   kernels with a bf16 tensor-core design beside the CUDA-core one (1, the
   flash forward; 2, the ring hop; 3-4, the flash backward; 5, the stem)
   print each
   compiled kernel's registers and spill bytes (ptxas) and its HMMA
   instructions (`cuobjdump -sass`), and check that the bf16 design has
   HMMA at every compiled width (DMAX 64 and 128; the stem's KT 2, 4, 6),
   spills nothing at D <= 64 (the stem: KT = 4), and that no CUDA-core
   kernel has HMMA;
3. kernel: hold the flash-attention forward kernel against its plain
   PyTorch version at the prefill shapes and edge cases (ragged, fully
   masked rows through k_offset, D = 128, non-causal D = 40), each in f32
   (the CUDA-core design) and bf16 (the tensor-core design), and bf16
   inputs 2 bytes past a 16-byte boundary (the same bits as aligned
   ones), with stated tolerances and a second launch bitwise equal; time
   it beside the plain version, `scaled_dot_product_attention` (a
   yardstick only; the port never calls it) and its bound;
4. generation: serve `TransformerLM(vocab 1024, embed 512, 4 layers,
   8 heads)` with random weights from a seed through `GenerationEngine`,
   check every stream, the kernel's launch count, and the greedy tokens
   against `greedy_decode_reference` on a twin without the kernel;
5. BN+ReLU kernels: hold the fused forward and backward kernels against
   their plain versions at ragged shapes and at the ResNet-50 sites (the
   stem, N = 128*112*112, C = 64; the last stage, N = 128*7*7, C = 512),
   for x f32 / out bf16, x f32 / out f32 and x bf16 / out bf16, with and
   without the ReLU: forward and dx bitwise, dscale/dshift within
   1e-5 * sum|terms| per channel; time each beside its plain version and
   its bound;
6. training: ResNet-50 (1000 classes, s2d stem, full width and depth,
   random weights from a seed). First an f32 parity pair at b8, 224x224:
   the model and a twin with the same weights under `fusion_scope(False)`
   (no kernel) take 3 SGD steps through `DistriOptimizer`; their losses
   agree to a relative 1e-4 and the model launches each kernel 33 times a
   step. Then the benchmark configuration (`bigdl_tpu_torch/tools/
   bench.py`: b128, bf16 compute with f32 masters, SGD momentum 0.9, one
   resident batch) for 8 warm-up and 24 timed steps, syncing every 8:
   imgs/s, ms/step, exactly 33 launches of each kernel a step, and a
   finite loss that falls from the first step to the last;
7. flash backward kernels: hold the dq and dk/dv kernels against their
   plain versions (causal T=2048 at B*H=64, ragged T=1000, non-causal
   Tq=1000 Tk=1500, D=128, rows fully masked through q_offset, each in
   f32, which runs on the CUDA cores, and in bf16, which runs on the
   tensor cores), per element within 1e-4 * max|plain| in f32 and one
   bf16 ulp (2**-7 * |plain|) more in bf16, and a second launch bitwise
   equal;
   kernel 1's O and lse in each case against its plain version with the
   tolerances of phase 3; time each beside its plain version, its bound
   and the backward of `scaled_dot_product_attention` (a yardstick only),
   and kernel 1 at the training shape;
8. LM training: `TransformerLM(vocab 1024, embed 512, 4 layers, 8 heads)`
   with random weights from a seed. (a) An f32 parity pair at b2, T=512:
   the model and a `use_flash=False` twin (no kernel) take 3 SGD steps
   through `DistriOptimizer` on the averaged per-token loss; their losses
   agree to a relative 1e-4, each of kernels 1, 3 and 4 launches 12 times
   and the twin none. (b) The benchmark configuration (`bigdl_tpu_torch/
   tools/bench.py --model lm`: b8, T=2048, bf16 compute with f32 masters,
   SGD momentum 0.9 on the loss summed over T, 12 warm-up + 36 timed
   steps, sync every 12): tokens/s, ms/step, exactly 4 launches of each
   kernel a step, and a finite first loss within [ln 1024, ln 1024 + 2]
   per token. The recipe's later losses diverge, in the reference as
   here, so no fall is required. (c) The example
   (`bigdl_tpu_torch/tools/transformer_lm.py`) at its defaults: AdamW with
   warm-up and cosine decay, a train-shard perplexity below 25, and the
   T=256 eval forward;
9. sequence parallelism: (a) hold the flash carry kernel (kernel 2, one
   ring hop) against its plain version in f32 and bf16 at D = 64, 128 and
   40: a two-hop continuation that, finished, matches kernel 1 over the
   whole K/V, ragged Tq/Tk, a diagonal hop, a hop wholly in the queries'
   past (equal bits to causal=False), a hop wholly in their future (the
   carry passes through bitwise), rows still fully masked (m = NEG_INF,
   l = 0 in and out), and a second launch (equal bits): acc within
   1e-5 * max|plain|, m and l within 1e-5 * max(|plain|, 1); bf16 runs
   the tensor-core design, f32 the CUDA-core one. Time it at the
   full-width hop shapes (the ring's B1 H8 T=2048 D64 bf16 diagonal and
   below-diagonal hops, zigzag's T=1024 chunk) beside its plain version,
   its bound and kernel 1 in bf16 at the same shape and offsets. (b) Ring,
   zigzag and Ulysses through `make_sequence_parallel_attention`, causal, B1 H8 T=8192 D64 bf16, over
   a mesh of every card (4 shards on the one card when there is one):
   each within one bf16 ulp of kernel 1 over the whole sequence
   (|d| <= 2**-7 |ref| + 1e-4 max|ref|), kernel 2 launched n^2, n(2n+1)
   and 0 times a call; timed beside kernel 1 (with its bound) and
   `scaled_dot_product_attention` (a yardstick only) over the whole
   sequence. (c) Ring and zigzag gradients of sum(out**2) for q, k and v,
   f32, T=2048, against `flash_attention` (kernels 1, 3, 4) on the whole
   sequence, within 1e-4 * max|ref|;
10. the space-to-depth stem (kernel 5). (a) Hold the stem kernel against
   its plain version in f32 and bf16, with and without the bias, for
   k = 3, 7, 11 and C_in = 1, 3 at a ragged x2 of 113x115 (a 226x230
   input), and at the served (b32, x2 [32, 112, 112, 12], O = 64, f32)
   and training (b128, bf16) shapes: per element within 1e-5 *
   max|plain|, plus one bf16 ulp (2**-7 * |plain|) in bf16, and a second
   launch bitwise equal; time it at the two full-width shapes beside its
   plain version, its bound and both cuDNN forms of the same function
   (`F.conv2d` 7x7/s2 on the channels_last image; the 4x4 stride-1
   convolution over the pre-padded 12-channel x2), yardsticks only.
   (b) Serve `ResNet50(class_num=1000, s2d_stem=True)` (224x224x3, random
   weights from seed 0, f32, TF32 off) through
   `InferenceEngine(max_batch_size=32, max_wait_ms=2)` with
   `BIGDL_TPU_PALLAS_STEM=1`, after `warmup`: a burst of 96 requests and a
   closed loop of 8 clients x 8 requests. Every request resolves, each row
   is within 1e-4 * max|twin row| of a `LocalPredictor` twin with the
   cuDNN stem and the same argmax wherever the twin's top-2 margin exceeds
   1e-3, and kernels 5 and 6 each launch exactly once a batch dispatched
   plus once a warm-up bucket; with the switch unset kernel 5 launches
   never. Requests/s, latency percentiles, batch-size p50, bucket hit
   rate, and the device ms of one b32 forward with kernel 5's share.
   (c) A plain-stem `ResNet50()` (randomized BN state) through
   `LocalPredictor` at b8: 0 BNs left, an s2d stem with a bias, outputs
   within 1e-4 * max|ref| of the unconverted model in eval mode, kernel 5
   once a batch. (d) Phase 6's f32 parity pair with the switch set against
   a twin with it unset (losses within a relative 1e-4, kernel 5 once a
   step), then `tools/ab_stem.py`: the stem micro-benchmark (b128 bf16)
   and a short full loop (8 warm-up + 24 timed steps) with and without
   kernel 5.

Prints a `{"kernels": [...]}` line (each row with the `design` its main
measure ran: `tensor_cores` or `cuda_cores_f32`), then as its last line
`{"ok": true, "device": {...}}`. Any failed phase exits non-zero.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FLOPS = {torch.float32: 67e12,     # f32 on the CUDA cores
              torch.bfloat16: 989e12}   # bf16 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
# |kernel - plain| limits. f32: both sum the same f32 terms in another
# order (2048 keys), ~1e-6 apart; a wrong mask or guard is off by >1e-2.
# bf16: O is rounded to bf16 (one ulp at |O| ~ 2 is 7.8e-3); lse stays f32.
TOL = {torch.float32: {"o": 1e-4, "lse": 1e-4},
       torch.bfloat16: {"o": 2e-2, "lse": 1e-4}}
# the greedy-token check compares log-probs instead where the top-2
# margin is below this
MARGIN_TOL = 1e-3

KERNEL_ROW = {"name": "flash_attention_fwd", "route": "cuda",
              "source": "bigdl_tpu_torch/csrc/flash_attention_fwd.cu",
              "replaces": "bigdl_tpu/ops/attention_kernel.py:186"}
BN_FWD_ROW = {"name": "bn_relu_fwd", "route": "cuda",
              "source": "bigdl_tpu_torch/csrc/bn_relu_fwd.cu",
              "replaces": "bigdl_tpu/ops/bn_relu_kernel.py:75"}
BN_BWD_ROW = {"name": "bn_relu_bwd", "route": "cuda",
              "source": "bigdl_tpu_torch/csrc/bn_relu_bwd.cu",
              "replaces": "bigdl_tpu/ops/bn_relu_kernel.py:118"}
DQ_ROW = {"name": "flash_attention_bwd_dq", "route": "cuda",
          "source": "bigdl_tpu_torch/csrc/flash_attention_bwd_dq.cu",
          "replaces": "bigdl_tpu/ops/attention_kernel.py:425"}
CARRY_ROW = {"name": "flash_attention_carry", "route": "cuda",
             "source": "bigdl_tpu_torch/csrc/flash_attention_carry.cu",
             "replaces": "bigdl_tpu/ops/attention_kernel.py:277"}
DKV_ROW = {"name": "flash_attention_bwd_dkv", "route": "cuda",
           "source": "bigdl_tpu_torch/csrc/flash_attention_bwd_dkv.cu",
           "replaces": "bigdl_tpu/ops/attention_kernel.py:469"}
# flash backward, per element and gradient: |kernel - plain| <=
# BWD_RTOL * |plain| + BWD_ATOL * max|plain|. Both sum the same f32 terms
# in another order (~2e-6 * max|plain| apart at T=2048); in bf16 each
# also rounds the gradient to nearest, which puts them at most one ulp,
# 2**-7 * |plain|, apart. That is tighter everywhere than 2e-2 * max|plain|.
BWD_RTOL = {torch.float32: 0.0, torch.bfloat16: 2 ** -7}
BWD_ATOL = 1e-4
# which design of kernels 1-4 a dtype runs (the .cu files' entry points
# dispatch by dtype): bf16 on the tensor cores, f32 on the CUDA cores.
# Kernels 6-7 have only the CUDA-core design; kernel 5 picks by its
# dtypes and width (`stem_design`).
DESIGN = {torch.float32: "cuda_cores_f32", torch.bfloat16: "tensor_cores"}
# the kernels with a bf16 tensor-core design beside a CUDA-core one
TC_KERNELS = ("flash_attention_fwd", "flash_attention_carry",
              "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
              "stem_conv")
# the LM: kernel launches of each of kernels 1, 3 and 4 a training step
LM_LAYERS = 4
# dscale/dshift: kernel and plain sum the same f32 terms in another order;
# the limit per channel is this times the sum of the terms' magnitudes
BN_SUM_RTOL = 1e-5
# ResNet-50: the stem's BN and bn1/bn2 of each of the 16 bottlenecks
BN_SITES = 33
# f32 kernel-vs-twin losses after 3 steps: the twin differs only in the
# summation order of dscale/dshift (~1e-7 relative a step)
PARITY_RTOL = 1e-4
# kernel 2 against its plain version: acc within CARRY_TOL * max|plain|,
# m and l within CARRY_TOL * max(|plain|, 1) per element. In f32 both sum
# the same f32 terms in another order. In bf16 both take S as exact
# products summed in f32; the kernel's P V carries P as bf16 hi + lo
# (~2**-17 of P), 0.12-0.19 of this limit in a CPU emulation
# (tests/test_torch_attention_kernel.py). A wrong map or guard is off by
# far more.
CARRY_TOL = 1e-5
# sequence parallelism at full width against kernel 1 on the whole
# sequence, per element: one bf16 ulp of |ref| plus SP_ATOL * max|ref|;
# gradients (f32): SP_GRAD_ATOL * max|ref|
SP_ATOL = 1e-4
SP_GRAD_ATOL = 1e-4
STEM_ROW = {"name": "stem_conv", "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/stem_conv.cu",
            "replaces": "bigdl_tpu/ops/stem_kernel.py:61"}
# the stem kernel against its plain version, per element: STEM_ATOL *
# max|plain|, plus one bf16 ulp (2**-7 * |plain|) in bf16. Both sum the
# same f32 products (k*k*C_in of them) in another order, ~1e-7 apart; a
# wrong tap, pad or guard is off by far more.
STEM_ATOL = 1e-5
# served ResNet-50 rows against the cuDNN-stem twin, per element:
# SERVE_ATOL * max|twin row| (the stem's f32 sums in another order,
# carried through 53 layers); the argmax must agree wherever the twin's
# top-2 margin exceeds MARGIN_TOL
SERVE_ATOL = 1e-4
STEM_ENV = "BIGDL_TPU_PALLAS_STEM"
# the served configuration: images, engine batch, burst size, closed-loop
# clients x requests each
SERVE_HW = 224
SERVE_BATCH = 32
SERVE_BURST = 96
SERVE_CLIENTS = 8
SERVE_PER_CLIENT = 8


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters):
    """Mean device time of `fn()` over `iters` back-to-back calls, after
    three warm-up calls, from CUDA events."""
    for _ in range(3):
        fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def unmasked_pairs(tq, tk, causal, q_offset, k_offset):
    """(query, key) pairs that attention computes for these inputs."""
    if not causal:
        return tq * tk
    rows = np.arange(tq) + q_offset - k_offset + 1
    return int(np.clip(rows, 0, tk).sum())


def roofline(flops, nbytes, dtype):
    """(least ms, what bounds it) for `flops` operations in `dtype` and
    `nbytes` moved, at the card's published peaks."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        ("operations" if t_ops >= t_bytes else "bytes")


def attention_bound(b, h, tq, tk, d, causal, q_offset, k_offset, dtype):
    """Least time (ms) the card could take for this call, and what bounds
    it: q, k, v read once, O and lse written once; 4*D operations per
    unmasked (query, key) pair (QK^T and PV), counted for these inputs."""
    pairs = unmasked_pairs(tq, tk, causal, q_offset, k_offset)
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = b * h * d * (2 * tq + 2 * tk) * elem + b * h * tq * 4
    return roofline(4.0 * b * h * d * pairs, nbytes, dtype)


def attention_bwd_bound(kernel, b, h, tq, tk, d, causal, q_offset, k_offset,
                        dtype):
    """Least time (ms) of one backward kernel, and what bounds it. dq:
    q, dO, k, v, lse, delta read once, dq written once; 3 products (S, dP,
    dQ). dk/dv: q, dO, k, v, lse, delta read once, dk, dv written once; 4
    products (S, dP, dV, dK). 2*D operations per unmasked pair a product,
    counted for these inputs."""
    pairs = unmasked_pairs(tq, tk, causal, q_offset, k_offset)
    elem = torch.tensor([], dtype=dtype).element_size()
    rows = 2 * b * h * tq * 4  # lse and delta, f32
    if kernel == "dq":
        products, nbytes = 3, b * h * d * (3 * tq + 2 * tk) * elem + rows
    else:
        products, nbytes = 4, b * h * d * (2 * tq + 4 * tk) * elem + rows
    return roofline(2.0 * products * b * h * d * pairs, nbytes, dtype)


def bwd_error(got, ref, dtype):
    """(max |got - ref|, the largest share of its per-element limit) of a
    flash backward gradient against its plain version."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    lim = BWD_RTOL[dtype] * ref.abs() + BWD_ATOL * ref.abs().max()
    return float(err.max()), float((err / lim).max())


def _offset_view(x):
    """x's values in a contiguous view that starts 2 bytes past a 16-byte
    boundary (a bf16 buffer one element longer)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:].copy_(x.reshape(-1))
    out = buf[1:].view(x.shape)
    check(out.data_ptr() % 16 == 2, "the offset view is not 2 bytes past "
                                    "a 16-byte boundary")
    return out


def kernel_phase(ak):
    """Kernel vs plain version at the prefill shapes (B=4, H=8, D=64) and
    a few edge cases, each in f32 (the CUDA-core design) and bf16 (the
    tensor-core design), and bf16 inputs 2 bytes past a 16-byte boundary
    (the element-copy path: the same bits as the aligned inputs). Every
    case also launches twice and wants the same bits. Returns the row for
    the main-path shape."""
    shapes = [  # name, b, h, tq, tk, d, causal, q_off, k_off
        ("causal T=128", 4, 8, 128, 128, 64, True, 0, 0),
        ("causal T=1000 (ragged)", 4, 8, 1000, 1000, 64, True, 0, 0),
        ("causal T=2048", 4, 8, 2048, 2048, 64, True, 0, 0),
        ("non-causal Tq=1000 Tk=1500 (ragged)", 4, 8, 1000, 1500, 64, False,
         0, 0),
        ("causal k_offset=64: rows 0-63 fully masked", 2, 4, 128, 128, 64,
         True, 0, 64),
        ("causal T=512 D=128", 2, 8, 512, 512, 128, True, 0, 0),
        ("non-causal T=300 D=40", 2, 4, 300, 300, 40, False, 0, 0),
    ]
    cases = [  # name, b, h, tq, tk, d, causal, q_off, k_off, dtype, offset
        (name + (" bf16" if dtype == torch.bfloat16 else ""), *shape, dtype,
         False)
        for dtype in (torch.float32, torch.bfloat16)
        for name, *shape in shapes]
    cases += [("causal T=1000 bf16, inputs 2 bytes past 16-byte alignment",
               4, 8, 1000, 1000, 64, True, 0, 0, torch.bfloat16, True),
              ("non-causal T=300 D=40 bf16, inputs 2 bytes past 16-byte "
               "alignment", 2, 4, 300, 300, 40, False, 0, 0, torch.bfloat16,
               True)]
    main_row = None
    for (name, b, h, tq, tk, d, causal, q_off, k_off, dtype,
         offset) in cases:
        # the same seed for a shape in every dtype and alignment
        gen = torch.Generator(device="cuda").manual_seed(tq * 7 + tk + d)
        q = torch.randn((b, h, tq, d), generator=gen, device="cuda"
                        ).to(dtype)
        k, v = (torch.randn((b, h, tk, d), generator=gen, device="cuda"
                            ).to(dtype) for _ in range(2))
        kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
        aligned = None
        with torch.inference_mode():
            if offset:
                aligned = ak.flash_attention_forward(q, k, v,
                                                     return_lse=True, **kw)
                q, k, v = (_offset_view(x) for x in (q, k, v))
            o, lse = ak.flash_attention_forward(q, k, v, return_lse=True,
                                                **kw)
            o2, lse2 = ak.flash_attention_forward(q, k, v, return_lse=True,
                                                  **kw)
            torch.cuda.synchronize()
            o_ref, lse_ref = ak.flash_attention_forward_plain(q, k, v, **kw)
        check(bool(torch.isfinite(o).all() and torch.isfinite(lse).all()),
              f"{name}: non-finite kernel output")
        err_o = float((o.float() - o_ref.float()).abs().max())
        err_lse = float((lse - lse_ref).abs().max())
        tol = TOL[dtype]
        bitwise = torch.equal(o, o2) and torch.equal(lse, lse2)
        ok = err_o <= tol["o"] and err_lse <= tol["lse"] and bitwise
        if aligned is not None:
            ok = ok and torch.equal(o, aligned[0]) \
                and torch.equal(lse, aligned[1])
        if k_off > q_off:
            dead = k_off - q_off
            ok = ok and bool((o[:, :, :dead] == 0).all()
                             and (lse[:, :, :dead] == 0).all())
        iters = 20 if tq * tk >= 1 << 20 else 50
        with torch.inference_mode():
            ms = cuda_ms(lambda: ak.flash_attention_forward(
                q, k, v, return_lse=True, **kw), iters)
            plain_ms = cuda_ms(lambda: ak.flash_attention_forward_plain(
                q, k, v, **kw), iters)
            library_ms = None
            if q_off == k_off == 0:
                library_ms = cuda_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, is_causal=causal), iters)
        bound_ms, bound_by = attention_bound(b, h, tq, tk, d, causal,
                                             q_off, k_off, dtype)
        row = {"case": name, "shape": [b, h, tq, tk, d],
               "dtype": str(dtype).replace("torch.", ""),
               "design": DESIGN[dtype],
               "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
               "tol_o": tol["o"], "tol_lse": tol["lse"],
               "bitwise_repeat": bitwise,
               "equal_to_aligned": None if aligned is None else bool(
                   torch.equal(o, aligned[0])
                   and torch.equal(lse, aligned[1])),
               "ok": ok, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "share_of_bound": bound_ms / ms}
        print("kernel case " + json.dumps(row), flush=True)
        check(ok, f"{name}: kernel disagrees with its plain version "
                  f"(O {err_o:.3e} > {tol['o']} or lse {err_lse:.3e} > "
                  f"{tol['lse']}), a second launch or the aligned inputs "
                  "give other bits, or a fully masked row is not 0")
        if name == "causal T=2048":
            main_row = {"max_abs_err": err_o, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": library_ms,
                        "design": DESIGN[dtype]}
        del q, k, v, o, o2, lse, lse2, o_ref, lse_ref, aligned
    torch.cuda.empty_cache()
    return main_row


def check_tokens(model, twin, prompt, got, greedy_decode_reference):
    """The engine's greedy tokens against the full-recompute reference on
    the twin without the kernel. At a step whose reference top-2 margin is
    below MARGIN_TOL the two paths may rightly pick different tokens:
    there the two models' log-probs are compared instead, and the check
    stops (the trajectories may part after a near tie)."""
    ref = greedy_decode_reference(twin, prompt, len(got))
    for i, (a, r) in enumerate(zip(got, ref)):
        if a == r:
            continue
        prefix = torch.tensor(np.concatenate([prompt, got[:i]])[None],
                              device="cuda")
        with torch.inference_mode():
            lp_ref = twin(prefix)[0, -1]
            lp_got = model(prefix)[0, -1]
        top2 = lp_ref.topk(2).values
        margin = float(top2[0] - top2[1])
        err = float((lp_got - lp_ref).abs().max())
        check(margin < MARGIN_TOL and err < MARGIN_TOL,
              f"prompt of {prompt.size}: token {i} is {a}, reference {r} "
              f"(top-2 margin {margin:.2e}, log-prob error {err:.2e})")
        print(f"prompt of {prompt.size}: near tie at token {i} (margin "
              f"{margin:.2e}); log-probs agree to {err:.2e}", flush=True)
        return i
    return len(got)


def generation_phase(ak):
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.serving import (GenerationEngine,
                                         greedy_decode_reference)

    cfg = dict(vocab_size=1024, embed_dim=512, n_layer=4, n_head=8)
    model = TransformerLM(**cfg, device="cuda",
                          generator=torch.Generator().manual_seed(0))
    twin = TransformerLM(**cfg, use_flash=False, device="cuda")
    twin.load_state_dict(model.state_dict())
    n_new = 32
    lengths = [3, 9, 17, 40, 100, 250, 500, 900, 1300, 1900]
    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, cfg["vocab_size"] + 1, size=n).astype(np.int32)
               for n in lengths]
    results = [None] * len(prompts)
    with GenerationEngine(model, slots=8, max_len=2048, prefill_batch=4,
                          max_new_tokens=n_new, device="cuda") as eng:
        t0 = time.perf_counter()
        shapes = eng.warmup()
        torch.cuda.synchronize()
        print(f"warmup: {shapes} shapes in {time.perf_counter() - t0:.2f} s",
              flush=True)

        def client(i):
            s = eng.generate(prompts[i], max_new_tokens=n_new)
            toks = []
            try:
                toks = s.result(timeout=600)
            except Exception as e:  # reported below with the stream status
                print(f"request {i}: {e!r}", file=sys.stderr)
            results[i] = (s.status, len(toks), toks)

        # the main path's run: counts start at 0 here and are read after
        ak.flash_attention_forward.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = ak.flash_attention_forward.launches
        stats = eng.generation_stats()
    for i, r in enumerate(results):
        check(r is not None and r[0] == "ok" and r[1] == n_new,
              f"request {i} (prompt {lengths[i]}): {r and r[:2]}")
    check(launches == stats["prefill_batches"] * cfg["n_layer"] > 0,
          f"flash kernel launches {launches} != prefill batches "
          f"{stats['prefill_batches']} x {cfg['n_layer']} layers")
    tokens = sum(r[1] for r in results)
    gen = {"requests": len(prompts), "tokens": tokens, "wall_s": wall,
           "tokens_per_sec": tokens / wall,
           "prefill_batches": stats["prefill_batches"],
           "prefill_ms_per_batch":
               1e3 * stats["prefill_s_total"] / stats["prefill_batches"],
           "decode_steps": stats["decode_steps"],
           "decode_ms_per_step":
               1e3 * stats["decode_s_total"] / stats["decode_steps"],
           "decode_occupancy": stats["decode_occupancy"],
           "kernel_launches": launches}
    print("generation " + json.dumps(gen), flush=True)

    for i in (0, len(prompts) - 1):  # shortest and longest prompt
        n = check_tokens(model, twin, prompts[i], results[i][2],
                         greedy_decode_reference)
        print(f"prompt of {lengths[i]}: {n}/{n_new} tokens equal the "
              "reference", flush=True)
    return launches


def bn_relu_bound(n, c, x_dtype, y_dtype, backward):
    """Least time (ms) for one call and what bounds it. Forward: x read,
    y written, scale/shift read; 3 f32 operations an element (multiply,
    add, max). Backward: x and g read, dx written, scale/shift read,
    dscale/dshift written; 7 f32 operations an element (the recomputed
    multiply-add, the mask, dx, and the two sums)."""
    xe = torch.tensor([], dtype=x_dtype).element_size()
    ye = torch.tensor([], dtype=y_dtype).element_size()
    if backward:
        nbytes, ops = n * c * (xe + ye + 4) + 4 * c * 4, 7.0 * n * c
    else:
        nbytes, ops = n * c * (xe + ye) + 2 * c * 4, 3.0 * n * c
    t_ops = ops / PEAK_FLOPS[torch.float32]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        ("operations" if t_ops >= t_bytes else "bytes")


def bn_relu_phase(bk):
    """Both BN+ReLU kernels against their plain versions. Returns the rows
    for the main path's stem site (x f32, y and g bf16, ReLU)."""
    shapes = [("7x5", 7, 5), ("1x129", 1, 129), ("16x130", 16, 130),
              ("stem", 128 * 112 * 112, 64), ("last stage", 128 * 7 * 7, 512)]
    dtypes = [(torch.float32, torch.bfloat16), (torch.float32, torch.float32),
              (torch.bfloat16, torch.bfloat16)]
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for label, n, c in shapes:
        x32 = torch.randn((n, c), generator=gen, device="cuda")
        scale = torch.rand((c,), generator=gen, device="cuda") + 0.5
        shift = torch.randn((c,), generator=gen, device="cuda") * 0.5
        g32 = torch.randn((n, c), generator=gen, device="cuda")
        for x_dt, y_dt in dtypes:
            x, g = x32.to(x_dt), g32.to(y_dt)
            for relu in (True, False):
                name = (f"{label} [{n}x{c}] x {str(x_dt)[6:]} y "
                        f"{str(y_dt)[6:]} relu={relu}")
                y = bk.bn_relu_forward(x, scale, shift, relu, y_dt)
                dx, ds, db = bk.bn_relu_backward(x, scale, shift, g, relu)
                torch.cuda.synchronize()
                y_ref = bk.bn_relu_forward_plain(x, scale, shift, relu, y_dt)
                dx_ref, ds_ref, db_ref = bk.bn_relu_backward_plain(
                    x, scale, shift, g, relu)
                gm = g.float()
                if relu:
                    pre = (x * scale + shift).to(y_dt)
                    gm = torch.where(pre > 0, gm, 0.0)
                lim_ds = BN_SUM_RTOL * (gm * x.float()).abs().sum(0)
                lim_db = BN_SUM_RTOL * gm.abs().sum(0)
                err_y = float((y.float() - y_ref.float()).abs().max())
                err_dx = float((dx - dx_ref).abs().max())
                ok = (y.dtype == y_dt and torch.equal(y, y_ref)
                      and torch.equal(dx, dx_ref)
                      and bool(((ds - ds_ref).abs() <= lim_ds).all())
                      and bool(((db - db_ref).abs() <= lim_db).all()))
                iters = 20 if n * c > 1 << 22 else 50
                fwd_ms = cuda_ms(lambda: bk.bn_relu_forward(
                    x, scale, shift, relu, y_dt), iters)
                fwd_plain_ms = cuda_ms(lambda: bk.bn_relu_forward_plain(
                    x, scale, shift, relu, y_dt), iters)
                bwd_ms = cuda_ms(lambda: bk.bn_relu_backward(
                    x, scale, shift, g, relu), iters)
                bwd_plain_ms = cuda_ms(lambda: bk.bn_relu_backward_plain(
                    x, scale, shift, g, relu), iters)
                fwd_bound = bn_relu_bound(n, c, x_dt, y_dt, False)
                bwd_bound = bn_relu_bound(n, c, x_dt, y_dt, True)
                row = {"case": name, "ok": ok, "max_abs_err_y": err_y,
                       "max_abs_err_dx": err_dx,
                       "max_abs_err_dscale": float((ds - ds_ref).abs().max()),
                       "max_abs_err_dshift": float((db - db_ref).abs().max()),
                       "fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain_ms,
                       "fwd_bound_ms": fwd_bound[0],
                       "bwd_ms": bwd_ms, "bwd_plain_ms": bwd_plain_ms,
                       "bwd_bound_ms": bwd_bound[0],
                       "fwd_share_of_bound": fwd_bound[0] / fwd_ms,
                       "bwd_share_of_bound": bwd_bound[0] / bwd_ms}
                print("bn_relu case " + json.dumps(row), flush=True)
                check(ok, f"{name}: a BN+ReLU kernel disagrees with its "
                          f"plain version (y {err_y:.3e}, dx {err_dx:.3e}, "
                          "or dscale/dshift beyond "
                          f"{BN_SUM_RTOL} * sum|terms|)")
                if label == "stem" and x_dt == torch.float32 \
                        and y_dt == torch.bfloat16 and relu:
                    rows["fwd"] = {"max_abs_err": err_y, "ms": fwd_ms,
                                   "plain_ms": fwd_plain_ms,
                                   "bound_ms": fwd_bound[0],
                                   "bound_by": fwd_bound[1],
                                   "library_ms": None}
                    rows["bwd"] = {"max_abs_err": err_dx, "ms": bwd_ms,
                                   "plain_ms": bwd_plain_ms,
                                   "bound_ms": bwd_bound[0],
                                   "bound_by": bwd_bound[1],
                                   "library_ms": None}
        del x32, g32, x, g
    return rows


def _reset_bn_counts(bk):
    bk.bn_relu_forward.launches = 0
    bk.bn_relu_backward.launches = 0
    bk.BnReluFunction.g_copies = 0


def training_phase(bk):
    from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
    from bigdl_tpu_torch.models import ResNet50
    from bigdl_tpu_torch.nn import ClassNLLCriterion, fusion_scope
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer, max_iteration
    from bigdl_tpu_torch.tools.bench import bench_resnet50

    # f32 parity: the model against a twin without the kernel
    torch.backends.cudnn.deterministic = True
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(8, 224, 224, 3).astype(np.float32))
    y = torch.from_numpy((rs.randint(0, 1000, size=8) + 1).astype(np.int32))
    batch = MiniBatch(x.cuda(), y.cuda())
    model = ResNet50(class_num=1000, s2d_stem=True, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    twin = ResNet50(class_num=1000, s2d_stem=True, device="cuda")
    twin.load_state_dict(model.state_dict())

    def train3(m):
        losses = []
        opt = DistriOptimizer(m, LocalDataSet([batch]), ClassNLLCriterion(),
                              devices=["cuda"])
        opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
        opt.set_end_when(max_iteration(3))
        opt.set_iteration_hook(lambda st: losses.append(st["loss"]))
        opt.optimize()
        return losses

    _reset_bn_counts(bk)
    got = train3(model)
    launches = (bk.bn_relu_forward.launches, bk.bn_relu_backward.launches)
    with fusion_scope(False):
        ref = train3(twin)
    twin_launches = (bk.bn_relu_forward.launches,
                     bk.bn_relu_backward.launches)
    rel = [abs(a - b) / abs(b) for a, b in zip(got, ref)]
    print("training parity " + json.dumps({
        "batch": batch.size(), "steps": 3, "dtype": "float32", "losses": got,
        "twin_losses": ref, "rel_diff": rel, "launches": launches}),
        flush=True)
    check(all(np.isfinite(got)) and max(rel) <= PARITY_RTOL,
          f"f32 losses {got} vs twin {ref}: relative {max(rel):.2e} > "
          f"{PARITY_RTOL}")
    check(launches == (3 * BN_SITES, 3 * BN_SITES),
          f"BN+ReLU launches {launches} != {3 * BN_SITES} each in 3 steps")
    check(twin_launches == launches, "the twin without fusion launched a "
                                     "BN+ReLU kernel")
    del model, twin, batch
    torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()

    # the benchmark configuration: the main path's run
    warmup, iters, sync = 8, 24, 8
    torch.cuda.reset_peak_memory_stats()
    _reset_bn_counts(bk)
    res = bench_resnet50(batch_size=128, warmup=warmup, iters=iters,
                         sync=sync, device="cuda",
                         generator=torch.Generator().manual_seed(0))
    steps = warmup + iters
    launches = {"bn_relu_fwd": bk.bn_relu_forward.launches,
                "bn_relu_bwd": bk.bn_relu_backward.launches}
    g_copies = bk.BnReluFunction.g_copies
    losses = res["losses"]
    out = {k: res[k] for k in ("imgs_per_sec", "ms_per_step", "batch_size",
                               "steps", "warmup", "sync", "device")}
    out.update({"precision": "bfloat16 compute, f32 masters",
                "loss_first": losses[0], "loss_last": losses[-1],
                "launches": launches, "launches_per_step": {
                    k: v / steps for k, v in launches.items()},
                "g_copies_per_step": g_copies / steps,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    print("training " + json.dumps(out), flush=True)
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"non-finite or missing losses: {losses}")
    check(losses[-1] < losses[0],
          f"the loss did not fall: first {losses[0]}, last {losses[-1]}")
    for k, v in launches.items():
        check(v == BN_SITES * steps,
              f"{k} launched {v} times in {steps} steps, not "
              f"{BN_SITES} x {steps}")
    return launches


def _kernel_label(mangled):
    """"tensor_cores DMAX=64", "cuda_cores_f32 KT=4 x=f32 w=bf16" and the
    like, from a kernel's mangled name: `_tc_kernel` is a bf16
    tensor-core design; the flash kernels take DMAX, the stem kernels KT
    (and the CUDA-core stem kernels x's and wk's types)."""
    m = re.search(r"kernelI(\w*?)Li(\d+)E", mangled)
    if not m:
        return mangled
    design = "tensor_cores" if "_tc_kernel" in mangled else "cuda_cores_f32"
    label = f"{design} {'KT' if 'stem' in mangled else 'DMAX'}={m[2]}"
    types = []
    for tok in re.findall(r"13__nv_bfloat16|f|S\d*_", m[1]):
        # S<n>_ names a type seen before: here always the previous one
        types.append(types[-1] if tok.startswith("S") else
                     "f32" if tok == "f" else "bf16")
    if len(types) == 2:
        label += f" x={types[0]} w={types[1]}"
    return label


def build_report(_build, name):
    """Per kernel of library `name`: ptxas's registers and spill bytes
    (nvcc -Xptxas -v) and the HMMA instructions in its SASS
    (cuobjdump -sass)."""
    out, label = {}, None
    for line in _build.build_log(name).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            label = _kernel_label(m.group(1))
            out.setdefault(label, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and label:
            out[label].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m and label:
            out[label]["registers"] = int(m[1])
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", str(_build.build_kernels([name])[0])],
        capture_output=True, text=True, timeout=120, check=True).stdout
    label = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            label = _kernel_label(m.group(1))
            out.setdefault(label, {})["hmma"] = 0
        elif label and re.search(r"\bHMMA\b", line):
            out[label]["hmma"] += 1
    return out


def build_phase(_build):
    """The bf16 designs of kernels 1-5 run on the tensor cores
    (HMMA in their SASS) and spill nothing at the main paths' widths
    (D <= 64; the stem's KT = 4); the CUDA-core designs have no HMMA."""
    report = {name: build_report(_build, name) for name in TC_KERNELS}
    print("tensor-core kernels build " + json.dumps(report), flush=True)
    for name, kernels in report.items():
        key, sizes, main = (("KT", (2, 4, 6), 4) if name == "stem_conv"
                            else ("DMAX", (64, 128), 64))
        for size in sizes:
            tc = kernels.get(f"tensor_cores {key}={size}", {})
            check(tc.get("hmma", 0) > 0,
                  f"{name}: no HMMA instruction in the bf16 kernel at "
                  f"{key} {size}: {tc}")
        tc = kernels[f"tensor_cores {key}={main}"]
        check(tc.get("spill_stores") == tc.get("spill_loads") == 0,
              f"{name}: the bf16 kernel at {key} {main} spills: {tc}")
        for label, k in kernels.items():
            check(not label.startswith("cuda_cores") or k.get("hmma") == 0,
                  f"{name}: the CUDA-core kernel {label} has HMMA: {k}")
    return report


def flash_backward_phase(ak):
    """Kernels 3 and 4 against their plain versions, and kernel 1 (whose O
    and lse they take) against its own. Returns the rows for the main
    path's shape (the LM's attention: B=8, H=8, T=2048, D=64, causal, bf16)
    and kernel 1's error and time there."""
    shapes = [  # name, b, h, tq, tk, d, causal, q_off, k_off
        ("causal T=1000 (ragged)", 4, 8, 1000, 1000, 64, True, 0, 0),
        ("non-causal Tq=1000 Tk=1500 (ragged)", 4, 8, 1000, 1500, 64, False,
         0, 0),
        ("causal T=512 D=128", 2, 8, 512, 512, 128, True, 0, 0),
        ("causal q_offset=-64: rows 0-63 fully masked", 2, 4, 256, 256, 64,
         True, -64, 0),
    ]
    cases = [  # name, b, h, tq, tk, d, causal, q_off, k_off, dtype
        ("causal T=2048", 8, 8, 2048, 2048, 64, True, 0, 0, torch.float32),
        ("causal T=2048 bf16 (training shape)", 8, 8, 2048, 2048, 64, True,
         0, 0, torch.bfloat16),
        *((name + (" bf16" if dtype == torch.bfloat16 else ""), *shape,
           dtype)
          for dtype in (torch.float32, torch.bfloat16)
          for name, *shape in shapes),
    ]
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = None
    for (name, b, h, tq, tk, d, causal, q_off, k_off, dtype) in cases:
        q, do = (torch.randn((b, h, tq, d), generator=gen, device="cuda"
                             ).to(dtype) for _ in range(2))
        k, v = (torch.randn((b, h, tk, d), generator=gen, device="cuda"
                            ).to(dtype) for _ in range(2))
        kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
        with torch.inference_mode():
            o, lse = ak.flash_attention_forward(q, k, v, return_lse=True,
                                                **kw)
            delta = ak.attention_delta(o, do)
            args = (q, k, v, do, lse, delta)
            dq = ak.flash_attention_backward_dq(*args, **kw)
            dk, dv = ak.flash_attention_backward_dkv(*args, **kw)
            torch.cuda.synchronize()
            dq2 = ak.flash_attention_backward_dq(*args, **kw)
            dk2, dv2 = ak.flash_attention_backward_dkv(*args, **kw)
            sm = d ** -0.5
            pargs = (*args, causal, sm, q_off, k_off)
            ref_dq = ak.flash_attention_backward_dq_plain(*pargs)
            ref_dk, ref_dv = ak.flash_attention_backward_dkv_plain(*pargs)
            o_ref, lse_ref = ak.flash_attention_forward_plain(q, k, v, **kw)
        check(bool(torch.isfinite(o).all() and torch.isfinite(lse).all()),
              f"{name}: non-finite kernel 1 output")
        err_o = float((o.float() - o_ref.float()).abs().max())
        err_lse = float((lse - lse_ref).abs().max())
        fwd_ok = err_o <= TOL[dtype]["o"] and err_lse <= TOL[dtype]["lse"]
        errs, shares = {}, {}
        for key, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                              ("dv", dv, ref_dv)):
            check(got.dtype == dtype and bool(torch.isfinite(got).all()),
                  f"{name}: {key} is not finite {dtype}")
            errs[key], shares[key] = bwd_error(got, ref, dtype)
        bitwise = (torch.equal(dq, dq2) and torch.equal(dk, dk2)
                   and torch.equal(dv, dv2))
        ok = fwd_ok and bitwise and all(v <= 1 for v in shares.values())
        if k_off > q_off:
            ok = ok and bool((dq[:, :, :k_off - q_off] == 0).all())
        iters = 10 if tq * tk >= 1 << 20 else 30
        with torch.inference_mode():
            dq_ms = cuda_ms(lambda: ak.flash_attention_backward_dq(
                *args, **kw), iters)
            dkv_ms = cuda_ms(lambda: ak.flash_attention_backward_dkv(
                *args, **kw), iters)
            bwd_ms = cuda_ms(lambda: ak.flash_attention_backward(
                q, k, v, o, lse, do, **kw), iters)
            dq_plain_ms = cuda_ms(
                lambda: ak.flash_attention_backward_dq_plain(*pargs), iters)
            dkv_plain_ms = cuda_ms(
                lambda: ak.flash_attention_backward_dkv_plain(*pargs), iters)
            fwd_ms = cuda_ms(lambda: ak.flash_attention_forward(
                q, k, v, return_lse=True, **kw), iters)
            fwd_plain_ms = cuda_ms(lambda: ak.flash_attention_forward_plain(
                q, k, v, **kw), iters)
        library_ms = fwd_library_ms = None
        if q_off == k_off == 0:  # SDPA's backward, the yardstick for 3+4
            qg, kg, vg = (x.detach().clone().requires_grad_()
                          for x in (q, k, v))
            out = torch.nn.functional.scaled_dot_product_attention(
                qg, kg, vg, is_causal=causal)
            library_ms = cuda_ms(lambda: torch.autograd.grad(
                out, (qg, kg, vg), do, retain_graph=True), iters)
            del out, qg, kg, vg
            with torch.inference_mode():  # and its forward, for kernel 1
                fwd_library_ms = cuda_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, is_causal=causal), iters)
        dq_bound = attention_bwd_bound("dq", b, h, tq, tk, d, causal, q_off,
                                       k_off, dtype)
        dkv_bound = attention_bwd_bound("dkv", b, h, tq, tk, d, causal,
                                        q_off, k_off, dtype)
        fwd_bound = attention_bound(b, h, tq, tk, d, causal, q_off, k_off,
                                    dtype)
        row = {"case": name, "shape": [b, h, tq, tk, d],
               "dtype": str(dtype).replace("torch.", ""),
               "design": DESIGN[dtype], "ok": ok,
               "fwd_max_abs_err_o": err_o, "fwd_max_abs_err_lse": err_lse,
               "fwd_tol_o": TOL[dtype]["o"], "fwd_tol_lse": TOL[dtype]["lse"],
               "bitwise_repeat": bitwise, "max_abs_err": errs,
               "max_share_of_limit": shares, "rtol": BWD_RTOL[dtype],
               "atol_of_max": BWD_ATOL, "dq_ms": dq_ms, "dkv_ms": dkv_ms,
               "backward_ms": bwd_ms, "dq_plain_ms": dq_plain_ms,
               "dkv_plain_ms": dkv_plain_ms,
               "sdpa_backward_ms": library_ms,
               "dq_bound_ms": dq_bound[0], "dkv_bound_ms": dkv_bound[0],
               "dq_share_of_bound": dq_bound[0] / dq_ms,
               "dkv_share_of_bound": dkv_bound[0] / dkv_ms,
               "fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain_ms,
               "fwd_bound_ms": fwd_bound[0],
               "sdpa_forward_ms": fwd_library_ms}
        print("flash backward case " + json.dumps(row), flush=True)
        check(ok, f"{name}: kernel 1 disagrees with its plain version (O "
                  f"{err_o:.3e} > {TOL[dtype]['o']} or lse {err_lse:.3e} > "
                  f"{TOL[dtype]['lse']}), a flash backward kernel disagrees "
                  f"with its plain version (share of the per-element limit "
                  f"{shares} > 1), is not bitwise repeatable, or a fully "
                  "masked row's dq is not 0")
        if dtype == torch.bfloat16 and tq == 2048:
            lib = {"library_ms": library_ms,
                   "library_call": "scaled_dot_product_attention backward "
                                   "(dq, dk, dv together)",
                   "backward_ms": bwd_ms}
            rows = {
                "dq": {"max_abs_err": errs["dq"], "ms": dq_ms,
                       "plain_ms": dq_plain_ms, "bound_ms": dq_bound[0],
                       "bound_by": dq_bound[1], **lib},
                "dkv": {"max_abs_err": max(errs["dk"], errs["dv"]),
                        "ms": dkv_ms, "plain_ms": dkv_plain_ms,
                        "bound_ms": dkv_bound[0], "bound_by": dkv_bound[1],
                        **lib},
                "fwd_training_shape": {"max_abs_err": err_o,
                                       "max_abs_err_lse": err_lse,
                                       "ms": fwd_ms,
                                       "plain_ms": fwd_plain_ms,
                                       "bound_ms": fwd_bound[0],
                                       "bound_by": fwd_bound[1],
                                       "library_ms": fwd_library_ms}}
        del q, k, v, do, o, lse, delta, args, dq, dk, dv, dq2, dk2, dv2, \
            o_ref, lse_ref
    torch.cuda.empty_cache()
    return rows


LM_CFG = dict(vocab_size=1024, embed_dim=512, n_layer=LM_LAYERS, n_head=8)


def _flash_counts(ak):
    return (ak.flash_attention_forward.launches,
            ak.flash_attention_backward_dq.launches,
            ak.flash_attention_backward_dkv.launches)


def _reset_flash_counts(ak):
    ak.flash_attention_forward.launches = 0
    ak.flash_attention_backward_dq.launches = 0
    ak.flash_attention_backward_dkv.launches = 0


def lm_training_phase(ak):
    from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer, max_iteration
    from bigdl_tpu_torch.tools import transformer_lm
    from bigdl_tpu_torch.tools.bench import bench_transformer_lm

    # (a) f32 parity: the model against a twin without the kernels
    rs = np.random.RandomState(0)
    toks = rs.randint(1, LM_CFG["vocab_size"] + 1, (2, 513)).astype(np.int32)
    batch = MiniBatch(torch.from_numpy(toks[:, :-1]).cuda(),
                      torch.from_numpy(toks[:, 1:]).cuda())
    model = TransformerLM(**LM_CFG, device="cuda",
                          generator=torch.Generator().manual_seed(0))
    twin = TransformerLM(**LM_CFG, use_flash=False, device="cuda")
    twin.load_state_dict(model.state_dict())

    def train3(m):
        losses = []
        opt = DistriOptimizer(m, LocalDataSet([batch]),
                              TimeDistributedCriterion(ClassNLLCriterion(),
                                                       size_average=True),
                              devices=["cuda"])
        opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
        opt.set_end_when(max_iteration(3))
        opt.set_iteration_hook(lambda st: losses.append(st["loss"]))
        opt.optimize()
        return losses

    _reset_flash_counts(ak)
    got = train3(model)
    launches = _flash_counts(ak)
    ref = train3(twin)
    twin_launches = tuple(a - b for a, b in zip(_flash_counts(ak),
                                                launches))
    rel = [abs(a - b) / abs(b) for a, b in zip(got, ref)]
    print("lm training parity " + json.dumps({
        "batch": 2, "seq": 512, "steps": 3, "dtype": "float32",
        "losses": got, "twin_losses": ref, "rel_diff": rel,
        "launches_fwd_dq_dkv": launches,
        "twin_launches": twin_launches}), flush=True)
    check(all(np.isfinite(got)) and max(rel) <= PARITY_RTOL,
          f"f32 LM losses {got} vs twin {ref}: relative {max(rel):.2e} > "
          f"{PARITY_RTOL}")
    check(launches == (3 * LM_LAYERS,) * 3,
          f"flash launches (fwd, dq, dkv) {launches} != {3 * LM_LAYERS} "
          "each in 3 steps")
    check(twin_launches == (0, 0, 0), "the use_flash=False twin launched a "
                                      "flash kernel")
    del model, twin, batch
    torch.cuda.empty_cache()

    # (b) the benchmark configuration: the main path's run
    warmup, iters, sync, seq = 12, 36, 12, 2048
    torch.cuda.reset_peak_memory_stats()
    _reset_flash_counts(ak)
    res = bench_transformer_lm(batch_size=8, seq=seq, vocab=1024,
                               warmup=warmup, iters=iters, sync=sync,
                               device="cuda",
                               generator=torch.Generator().manual_seed(0))
    counts = _flash_counts(ak)
    steps = warmup + iters
    losses = res["losses"]
    launches = dict(zip(("flash_attention_fwd", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv"), counts))
    out = {k: res[k] for k in ("tokens_per_sec", "ms_per_step", "batch_size",
                               "seq", "steps", "warmup", "sync", "device")}
    out.update({"precision": "bfloat16 compute, f32 masters",
                "loss_per_token_first": losses[0] / seq,
                "synced_losses": {i + 1: losses[i]
                                  for i in range(sync - 1, steps, sync)},
                "losses_every_step": losses,
                "launches": launches, "launches_per_step": {
                    k: v / steps for k, v in launches.items()},
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    print("lm training " + json.dumps(out), flush=True)
    check(len(losses) == steps, f"{len(losses)} losses for {steps} steps")
    lo = math.log(LM_CFG["vocab_size"])
    check(math.isfinite(losses[0]) and lo <= losses[0] / seq <= lo + 2,
          f"first loss per token {losses[0] / seq} outside "
          f"[{lo:.3f}, {lo + 2:.3f}]")
    for k, v in launches.items():
        check(v == LM_LAYERS * steps,
              f"{k} launched {v} times in {steps} steps, not "
              f"{LM_LAYERS} x {steps}")

    # (c) the example recipe at its defaults
    t0 = time.perf_counter()
    ppl = transformer_lm.main([])
    print(f"lm example: perplexity {ppl:.3f} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(math.isfinite(ppl) and ppl < 25,
          f"the example's train-shard perplexity {ppl} is not below 25")
    return launches


def carry_bound(b, h, tq, tk, d, causal, q_offset, k_offset, dtype):
    """Least time (ms) of one ring hop and what bounds it: q, k, v read
    once, the f32 carry (acc, m, l) read once and written once; 4*D
    operations per unmasked (query, key) pair, counted for these
    inputs."""
    pairs = unmasked_pairs(tq, tk, causal, q_offset, k_offset)
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = b * h * d * (tq + 2 * tk) * elem \
        + 2 * b * h * tq * (d + 2) * 4
    return roofline(4.0 * b * h * d * pairs, nbytes, dtype)


def carry_error(got, want):
    """(max |acc - plain|, the largest share of the per-element limit over
    acc, m and l, and each one's share) of a carry against its plain
    version."""
    err_acc = float((got[0] - want[0]).abs().max())
    shares = {"acc": err_acc / (CARRY_TOL * float(want[0].abs().max()))}
    for name, a, b in zip("ml", got[1:], want[1:]):
        lim = CARRY_TOL * b.abs().clamp(min=1.0)
        shares[name] = float(((a - b).abs() / lim).max())
    return err_acc, max(shares.values()), shares


def _random_carry(ak, q, k0, v0, masked_rows=0):
    """A carried (acc, m, l) from the plain hop over k0, v0 (non-causal),
    with the first `masked_rows` rows still fully masked."""
    acc, m, l = ak.flash_attention_carry_plain(
        q, k0, v0, ak.attention_state_init(q))
    acc[:, :, :masked_rows] = 0
    m[:, :, :masked_rows] = ak.NEG_INF
    l[:, :, :masked_rows] = 0
    return acc, m, l


def carry_phase(ak):
    """9(a): kernel 2 against its plain version, then timed at the
    full-width hop shapes. Returns the row for the ring's below-diagonal
    hop, the hop that most of a causal ring's work runs in."""
    gen = torch.Generator(device="cuda").manual_seed(9)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 128, 40):
            tag = f"{str(dtype)[6:]} D={d}"
            q, k, v, k0, v0 = (rand(2, 4, 384, d, dtype=dtype)
                               for _ in range(5))
            # a two-hop continuation from a fresh state, finished, against
            # kernel 1 over the whole K/V
            with torch.inference_mode():
                state = ak.attention_state_init(q)
                shares, bitwise = [], True
                for k_off in (0, 192):
                    sl = slice(k_off, k_off + 192)
                    ks, vs = k[:, :, sl].contiguous(), v[:, :, sl].contiguous()
                    kw = dict(causal=True, k_offset=k_off)
                    got = ak.flash_attention_carry(q, ks, vs, state, **kw)
                    again = ak.flash_attention_carry(q, ks, vs, state, **kw)
                    torch.cuda.synchronize()
                    want = ak.flash_attention_carry_plain(q, ks, vs, state,
                                                          **kw)
                    shares.append(carry_error(got, want)[1])
                    bitwise &= all(torch.equal(a, b)
                                   for a, b in zip(got, again))
                    state = got
                fin = ak.attention_state_finish(*state).to(dtype)
                o1 = ak.flash_attention_forward(q, k, v, causal=True)
            err_o = float((fin.float() - o1.float()).abs().max())
            lim_o = 1e-5 * float(o1.float().abs().max())
            if dtype == torch.bfloat16:  # both round to bf16: one ulp
                lim_o += 2 ** -7 * float(o1.float().abs().max())
            row = {"case": f"two-hop continuation {tag}",
                   "max_share_of_limit": max(shares),
                   "bitwise_repeat": bitwise,
                   "finished_vs_kernel1_max_abs_err": err_o,
                   "finished_bitwise_equal_kernel1": torch.equal(fin, o1)}
            print("carry case " + json.dumps(row), flush=True)
            check(max(shares) <= 1 and bitwise and err_o <= lim_o,
                  f"carry {tag}: continuation disagrees with its plain "
                  f"version (share {max(shares):.3f}), is not bitwise "
                  f"repeatable, or finished differs from kernel 1 by "
                  f"{err_o:.3e} > {lim_o:.3e}")

            cases = [  # name, tq, tk, causal, q_off, k_off, masked rows
                ("ragged Tq=200 Tk=136", 200, 136, True, 300, 200, 0),
                ("diagonal", 256, 256, True, 256, 256, 0),
                ("rows still fully masked", 128, 128, True, 0, 16, 32),
                ("non-causal ragged", 100, 70, False, 0, 0, 0)]
            for name, tq, tk, causal, q_off, k_off, masked in cases:
                q, k, v, k0, v0 = (rand(2, 4, t, d, dtype=dtype) for t in
                                   (tq, tk, tk, tk, tk))
                kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
                with torch.inference_mode():
                    carry = _random_carry(ak, q, k0, v0, masked)
                    got = ak.flash_attention_carry(q, k, v, carry, **kw)
                    again = ak.flash_attention_carry(q, k, v, carry, **kw)
                    torch.cuda.synchronize()
                    want = ak.flash_attention_carry_plain(q, k, v, carry,
                                                          **kw)
                err, share, _ = carry_error(got, want)
                bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
                ok = share <= 1 and bitwise
                if masked:  # rows 0-15 see no key here either
                    ok = ok and bool((got[1][:, :, :16] == ak.NEG_INF).all()
                                     and (got[2][:, :, :16] == 0).all()
                                     and (got[0][:, :, :16] == 0).all())
                row = {"case": f"{name} {tag}", "max_abs_err_acc": err,
                       "max_share_of_limit": share,
                       "bitwise_repeat": bitwise, "ok": ok}
                print("carry case " + json.dumps(row), flush=True)
                check(ok, f"carry {name} {tag}: disagrees with its plain "
                          f"version (share {share:.3f} of the limit), is "
                          "not bitwise repeatable, or a masked row moved")

            # wholly in the past (causal equals non-causal, bitwise) and
            # wholly in the future (the carry passes through, bitwise)
            q, k, v, k0, v0 = (rand(2, 4, 192, d, dtype=dtype)
                               for _ in range(5))
            with torch.inference_mode():
                carry = _random_carry(ak, q, k0, v0)
                past = ak.flash_attention_carry(q, k, v, carry, causal=True,
                                                q_offset=192, k_offset=0)
                full = ak.flash_attention_carry(q, k, v, carry, causal=False)
                future = ak.flash_attention_carry(q, k, v, carry,
                                                  causal=True, q_offset=0,
                                                  k_offset=192)
                torch.cuda.synchronize()
            ok_past = all(torch.equal(a, b) for a, b in zip(past, full))
            ok_future = all(torch.equal(a, b) for a, b in zip(future, carry))
            print("carry case " + json.dumps({
                "case": f"past and future shards {tag}",
                "past_equals_non_causal_bitwise": ok_past,
                "future_passes_through_bitwise": ok_future}), flush=True)
            check(ok_past and ok_future,
                  f"carry {tag}: a past shard differs from causal=False or "
                  "a future shard did not pass the carry through bitwise")

    # timing at the full-width hop shapes (B1 H8 D64 bf16)
    hops = [("ring below-diagonal hop", 2048, 2048, 0),
            ("ring diagonal hop", 2048, 2048, 2048),
            ("zigzag chunk (q_high vs A)", 1024, 1024 * 6, 1024)]
    main_row = None
    for name, t, q_off, k_off in hops:
        causal = "zigzag" not in name
        q, k, v = (rand(1, 8, t, 64, dtype=torch.bfloat16)
                   for _ in range(3))
        kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
        with torch.inference_mode():
            carry = _random_carry(ak, q, *(rand(1, 8, t, 64,
                                                dtype=torch.bfloat16)
                                           for _ in range(2)))
            got = ak.flash_attention_carry(q, k, v, carry, **kw)
            torch.cuda.synchronize()
            want = ak.flash_attention_carry_plain(q, k, v, carry, **kw)
            err, share, parts = carry_error(got, want)
            ms = cuda_ms(lambda: ak.flash_attention_carry(q, k, v, carry,
                                                          **kw), 20)
            plain_ms = cuda_ms(lambda: ak.flash_attention_carry_plain(
                q, k, v, carry, **kw), 20)
            k1_ms = cuda_ms(lambda: ak.flash_attention_forward(q, k, v,
                                                               **kw), 20)
        bound_ms, bound_by = carry_bound(1, 8, t, t, 64, causal, q_off,
                                         k_off, torch.bfloat16)
        row = {"case": name, "shape": [1, 8, t, t, 64], "dtype": "bfloat16",
               "q_offset": q_off, "k_offset": k_off, "causal": causal,
               "max_abs_err": err, "max_share_of_limit": share,
               "share_of_limit": parts, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "share_of_bound": bound_ms / ms,
               "kernel1_ms": k1_ms, "vs_kernel1": ms / k1_ms}
        print("carry timing " + json.dumps(row), flush=True)
        check(share <= 1, f"carry {name}: disagrees with its plain version "
                          f"(share {share:.3f} of the limit)")
        if main_row is None:
            main_row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None, "hop_shape": name,
                        "kernel1_ms": k1_ms}
        else:
            main_row.setdefault("other_hops", []).append(
                {"case": name, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "kernel1_ms": k1_ms})
    return main_row


def sp_mesh_devices():
    """Every card when there are two or more, else 4 shards on the one."""
    n = torch.cuda.device_count()
    if n >= 2:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * 4


def sequence_parallel_phase(ak):
    """9(b) and 9(c). Returns kernel 2's launches in the full-width run
    and kernel 1's row at the long-context shape."""
    from bigdl_tpu_torch.parallel import (build_mesh,
                                          make_sequence_parallel_attention)
    devices = sp_mesh_devices()
    n = len(devices)
    mesh = build_mesh(data=n, devices=devices)
    want_launches = {"ring": n * n, "zigzag": n * (2 * n + 1), "ulysses": 0}
    fns = {s: make_sequence_parallel_attention(mesh, s, causal=True)
           for s in ("ring", "zigzag", "ulysses")}
    gen = torch.Generator(device="cuda").manual_seed(10)
    t = 8192
    q, k, v = (torch.randn((1, 8, t, 64), generator=gen, device="cuda"
                           ).to(torch.bfloat16) for _ in range(3))
    with torch.inference_mode():
        ref = ak.flash_attention_forward(q, k, v, causal=True).float()
    lim = 2 ** -7 * ref.abs() + SP_ATOL * ref.abs().max()

    # the main path's run: counts start at 0 here and are read after
    _reset_flash_counts(ak)
    ak.flash_attention_carry.launches = 0
    outs, launches = {}, {}
    with torch.inference_mode():
        for scheme, fn in fns.items():
            before = ak.flash_attention_carry.launches
            outs[scheme] = fn(q, k, v)
            torch.cuda.synchronize()
            launches[scheme] = ak.flash_attention_carry.launches - before
    total = ak.flash_attention_carry.launches
    other = _flash_counts(ak)
    check(other == (0, 0, 0), f"the sequence-parallel run launched kernels "
                              f"1, 3, 4 {other} times")
    rows = {}
    with torch.inference_mode():
        k1_ms = cuda_ms(lambda: ak.flash_attention_forward(q, k, v,
                                                           causal=True), 10)
        k1_plain_ms = cuda_ms(lambda: ak.flash_attention_forward_plain(
            q, k, v, causal=True), 3)
        sdpa_ms = cuda_ms(lambda: torch.nn.functional
                          .scaled_dot_product_attention(q, k, v,
                                                        is_causal=True), 10)
        for scheme, fn in fns.items():
            out = outs[scheme]
            ok_shape = out.shape == q.shape and out.dtype == q.dtype
            err = (out.float() - ref).abs()
            share = float((err / lim).max())
            rows[scheme] = {"launches": launches[scheme],
                            "max_abs_err": float(err.max()),
                            "max_share_of_limit": share,
                            "ms": cuda_ms(lambda: fn(q, k, v), 5)}
            check(ok_shape and bool(torch.isfinite(out).all()),
                  f"{scheme}: output {out.dtype} {tuple(out.shape)} is not "
                  "finite bf16 of q's shape")
            check(share <= 1, f"{scheme}: {share:.3f} of the limit from "
                              "kernel 1 over the whole sequence")
            check(launches[scheme] == want_launches[scheme],
                  f"{scheme}: kernel 2 launched {launches[scheme]} times, "
                  f"not {want_launches[scheme]}")
    k1_bound = attention_bound(1, 8, t, t, 64, True, 0, 0, torch.bfloat16)
    k1_row = {"shape": [1, 8, t, t, 64], "design": DESIGN[torch.bfloat16],
              "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
              "bound_by": k1_bound[1],
              "library_ms": sdpa_ms}
    print("sequence parallel " + json.dumps({
        "shape": [1, 8, t, 64], "dtype": "bfloat16", "causal": True,
        "shards": n, "mesh": [str(x) for x in devices],
        "kernel1_ms": k1_ms, "kernel1_bound_ms": k1_bound[0],
        "sdpa_ms": sdpa_ms, "schemes": rows,
        "carry_launches": total}), flush=True)
    del q, k, v, ref, lim, outs

    # 9(c): gradients, f32 at T=2048, against kernels 1, 3 and 4
    t = 2048
    base = [torch.randn((1, 8, t, 64), generator=gen, device="cuda")
            for _ in range(3)]
    ref_in = [x.clone().requires_grad_() for x in base]
    (ak.flash_attention(*ref_in, True) ** 2).sum().backward()
    grads = {}
    for scheme in ("ring", "zigzag"):
        xs = [x.clone().requires_grad_() for x in base]
        (fns[scheme](*xs) ** 2).sum().backward()
        shares = {}
        for name, x, r in zip("qkv", xs, ref_in):
            shares[f"d{name}"] = float((x.grad - r.grad).abs().max()
                                       / (SP_GRAD_ATOL * r.grad.abs().max()))
        grads[scheme] = shares
        check(max(shares.values()) <= 1,
              f"{scheme} gradients differ from flash_attention's: "
              f"{shares} of the limit")
    print("sequence parallel gradients " + json.dumps({
        "shape": [1, 8, t, 64], "dtype": "float32",
        "max_share_of_limit": grads}), flush=True)
    torch.cuda.empty_cache()
    return total, k1_row


def stem_bound(b, h2, w2, k, cin, n_out, dtype, with_bias):
    """Least time (ms) of one stem call and what bounds it: x2, wk and the
    bias read once, the output written once; 2 * k*k*C_in operations an
    output element (the function's own count: the s2d GEMM's zero-padded
    kernel does kt*kt*4*C_in, 64/49 more at k = 7)."""
    kt = (k + 1) // 2
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = (b * h2 * w2 * 4 * cin + kt * kt * 4 * cin * n_out
              + b * h2 * w2 * n_out) * elem + (4 * n_out if with_bias else 0)
    return roofline(2.0 * b * h2 * w2 * k * k * cin * n_out, nbytes, dtype)


def stem_design(x_dtype, w_dtype, n_out):
    """Which design of kernel 5 runs (csrc/stem_conv.cu's entry point
    dispatches by dtype and O): bf16 x2 and wk with O % 8 == 0 on the
    tensor cores, everything else on the CUDA cores."""
    tc = x_dtype == w_dtype == torch.bfloat16 and n_out % 8 == 0
    return "tensor_cores" if tc else "cuda_cores_f32"


def stem_kernel_phase(sk):
    """10(a): kernel 5 against its plain version; times at the served and
    training shapes. Returns the row for the served shape."""
    from bigdl_tpu_torch.nn.conv import s2d_kernel, space_to_depth
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = [(f"ragged 113x115 k={k} C_in={cin} {str(dt)[6:]} "
              f"bias={bias}", 2, 226, 230, cin, k, 64, dt, bias)
             for k in (3, 7, 11) for cin in (1, 3)
             for dt in (torch.float32, torch.bfloat16)
             for bias in (False, True)]
    cases += [("served", SERVE_BATCH, SERVE_HW, SERVE_HW, 3, 7, 64,
               torch.float32, False),
              ("served with bias", SERVE_BATCH, SERVE_HW, SERVE_HW, 3, 7, 64,
               torch.float32, True),
              ("training", 128, SERVE_HW, SERVE_HW, 3, 7, 64,
               torch.bfloat16, False)]
    rows = {}
    for name, b, h, w, cin, k, n_out, dt, with_bias in cases:
        kt, pad = (k + 1) // 2, (k - 1) // 2
        front = (pad + 1) // 2
        x = torch.rand((b, h, w, cin), generator=gen, device="cuda").to(dt)
        w_oihw = (torch.randn((n_out, cin, k, k), generator=gen,
                              device="cuda") * 0.2).to(dt)
        bias = torch.randn((n_out,), generator=gen, device="cuda") \
            if with_bias else None
        x2, wk = space_to_depth(x), s2d_kernel(w_oihw)
        out = sk.stem_conv_forward(x2, wk, bias, front, kt - 1 - front)
        again = sk.stem_conv_forward(x2, wk, bias, front, kt - 1 - front)
        torch.cuda.synchronize()
        ref = sk.stem_conv_forward_plain(x2, wk, bias, front,
                                         kt - 1 - front).float()
        err = (out.float() - ref).abs()
        lim = (2 ** -7 if dt == torch.bfloat16 else 0) * ref.abs() \
            + STEM_ATOL * ref.abs().max()
        share = float((err / lim).max())
        bitwise = torch.equal(out, again)
        row = {"case": name, "x2": list(x2.shape), "k": k, "O": n_out,
               "dtype": str(dt)[6:], "design": stem_design(dt, dt, n_out),
               "max_abs_err": float(err.max()),
               "max_share_of_limit": share, "second_launch_equal": bitwise}
        if name in ("served", "training"):
            iters = 20
            row["ms"] = cuda_ms(lambda: sk.stem_conv_forward(
                x2, wk, bias, front, kt - 1 - front), iters)
            row["plain_ms"] = cuda_ms(lambda: sk.stem_conv_forward_plain(
                x2, wk, bias, front, kt - 1 - front), iters)
            bound = stem_bound(b, h // 2, w // 2, k, cin, n_out, dt,
                               with_bias)
            row["bound_ms"], row["bound_by"] = bound
            row["function_ops"] = 2 * b * (h // 2) * (w // 2) * k * k \
                * cin * n_out
            row["s2d_gemm_ops"] = 2 * b * (h // 2) * (w // 2) * kt * kt \
                * 4 * cin * n_out
            x_nchw = x.permute(0, 3, 1, 2)  # channels_last, no copy
            row["library_ms"] = cuda_ms(lambda: F.conv2d(
                x_nchw, w_oihw, bias, 2, pad), iters)
            xp = F.pad(x2, (0, 0, front, kt - 1 - front, front,
                            kt - 1 - front)).permute(0, 3, 1, 2)
            wk_oihw = wk.permute(3, 2, 0, 1).contiguous()
            row["library_s2d_ms"] = cuda_ms(lambda: F.conv2d(
                xp, wk_oihw, bias), iters)
            # the cuDNN 7x7/s2 convolution computes the same function
            lib = F.conv2d(x_nchw, w_oihw, bias, 2, pad).permute(
                0, 2, 3, 1).float()
            row["max_abs_diff_cudnn"] = float((out.float() - lib).abs().max())
            rows[name] = row
        print("stem case " + json.dumps(row), flush=True)
        check(share <= 1 and bitwise,
              f"{name}: the stem kernel disagrees with its plain version "
              f"({share:.3f} of the limit) or a second launch differs "
              f"(equal: {bitwise})")
        del x, x2, out, again, ref, err, lim
    torch.cuda.empty_cache()
    served = rows["served"]
    training = rows["training"]
    keys = ("design", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_s2d_ms")
    return {**{k: served[k] for k in keys},
            "training_shape": {k: training[k] for k in keys}}


def _stem_counts(sk, bk):
    return sk.stem_conv_forward.launches, bk.bn_relu_forward.launches


def _reset_stem_counts(sk, bk):
    sk.stem_conv_forward.launches = 0
    bk.bn_relu_forward.launches = 0


def _check_rows(got, ref, label):
    """Served rows against the twin's: per element within SERVE_ATOL *
    max|twin row|, argmax equal wherever the top-2 margin is clear."""
    got, ref = np.asarray(got), np.asarray(ref)
    check(got.shape == ref.shape and np.isfinite(got).all(),
          f"{label}: rows {got.shape} vs {ref.shape}, or not finite")
    lim = SERVE_ATOL * np.abs(ref).max(axis=1, keepdims=True)
    share = float((np.abs(got - ref) / lim).max())
    top2 = np.sort(ref, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > MARGIN_TOL
    same = np.argmax(got, 1)[clear] == np.argmax(ref, 1)[clear]
    check(share <= 1 and bool(same.all()),
          f"{label}: rows differ from the cuDNN-stem twin ({share:.3f} of "
          f"the limit) or an argmax differs ({int((~same).sum())} rows)")
    return share, int(clear.sum())


def _serve(model, images, ref, traffic, sk, bk):
    """One traffic through a fresh engine with the stem switch set; the
    counts are read around warm-up plus traffic. Returns the launches."""
    from bigdl_tpu_torch.serving import InferenceEngine
    n = len(images)
    got = [None] * n
    with InferenceEngine(model, max_batch_size=SERVE_BATCH, max_wait_ms=2.0,
                         device="cuda") as eng:
        _reset_stem_counts(sk, bk)
        eng.warmup(images[0])
        t0 = time.perf_counter()
        if traffic == "burst":
            futs = [eng.submit(images[i]) for i in range(n)]
            for i, f in enumerate(futs):
                got[i] = f.result(300)
        else:
            def client(c):
                for j in range(SERVE_PER_CLIENT):
                    i = c * SERVE_PER_CLIENT + j
                    got[i] = eng.predict(images[i], timeout=300)

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(SERVE_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = _stem_counts(sk, bk)
        stats = eng.stats()
        buckets = len(eng.buckets)
    check(all(g is not None for g in got),
          f"{traffic}: {sum(g is None for g in got)} requests unresolved")
    share, clear = _check_rows(np.stack(got), ref[:n], traffic)
    want = stats["batches"] + buckets
    out = {"traffic": traffic, "requests": n, "wall_s": wall,
           "requests_per_sec": n / wall,
           **{k: stats.get(k) for k in (
               "latency_ms_p50", "latency_ms_p95", "latency_ms_p99",
               "queue_wait_ms_p50", "batch_size_p50", "bucket_hit_rate",
               "batches", "completed", "failed", "timed_out")},
           "warmup_buckets": buckets,
           "launches": {"stem_conv": launches[0],
                        "bn_relu_fwd": launches[1]},
           "max_share_of_limit": share, "argmax_rows_checked": clear}
    print("stem serving " + json.dumps(out), flush=True)
    check(stats["completed"] == n and stats["failed"] == 0,
          f"{traffic}: completed {stats['completed']} of {n}")
    check(launches == (want, want),
          f"{traffic}: launches (stem, BN+ReLU) {launches} != batches "
          f"{stats['batches']} + warm-up buckets {buckets} each")
    return launches[0]


def _randomize_bn_state(model, seed):
    """BN gammas U(0.5, 1.5) (U(0.05, 0.15) where zero-initialized), betas
    N(0, 0.1), running means N(0, 0.1), variances U(0.5, 1.5): the init's
    1 / 0 / 0 / 1 would make every fold the identity."""
    from bigdl_tpu_torch.nn import BatchNormalization
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNormalization):
                n = m.n_output
                scale = 1.0 if bool(m.weight.any()) else 0.1
                m.weight.copy_((torch.rand(n, generator=gen) + 0.5) * scale)
                m.bias.copy_(torch.randn(n, generator=gen) * 0.1)
                m.mean.copy_(torch.randn(n, generator=gen) * 0.1)
                m.var.copy_(torch.rand(n, generator=gen) + 0.5)


def stem_serving_phase(sk, bk, stem_ms):
    """10(b) and 10(c). Returns kernel 5's launches on the serving path."""
    from bigdl_tpu_torch.models import ResNet50
    from bigdl_tpu_torch.nn import BatchNormalization
    from bigdl_tpu_torch.nn import SpaceToDepthStemConvolution as S2D
    from bigdl_tpu_torch.optim import LocalPredictor

    n = max(SERVE_BURST, SERVE_CLIENTS * SERVE_PER_CLIENT)
    images = np.random.RandomState(0).rand(
        n, SERVE_HW, SERVE_HW, 3).astype(np.float32)
    model = ResNet50(class_num=1000, s2d_stem=True, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    os.environ.pop(STEM_ENV, None)
    twin = LocalPredictor(model, batch_size=SERVE_BATCH, device="cuda")
    twin.model.get_submodule("0_conv1").pallas_stem = False
    ref = np.stack(twin.predict(images))
    bns = sum(isinstance(m, BatchNormalization) for m in twin.model.modules())
    check(bns == 1, f"the served model kept {bns} BNs, not the stem's one")

    # with the switch unset, kernel 5 never launches
    off = LocalPredictor(model, batch_size=SERVE_BATCH, device="cuda")
    _reset_stem_counts(sk, bk)
    off.predict(images[:SERVE_BATCH])
    check(_stem_counts(sk, bk) == (0, 1),
          f"switch unset: (stem, BN+ReLU) launches {_stem_counts(sk, bk)} "
          "!= (0, 1)")

    os.environ[STEM_ENV] = "1"
    try:
        launches = 0
        for traffic in ("burst", "closed loop"):
            m = SERVE_BURST if traffic == "burst" \
                else SERVE_CLIENTS * SERVE_PER_CLIENT
            launches += _serve(model, images[:m], ref, traffic, sk, bk)
        # device time of one b32 forward, and kernel 5's share of it
        on = LocalPredictor(model, batch_size=SERVE_BATCH, device="cuda")
        x = torch.from_numpy(images[:SERVE_BATCH]).cuda()
        fwd_ms = cuda_ms(lambda: on._forward(x), 10)
        twin_fwd_ms = cuda_ms(lambda: twin._forward(x), 10)
        print("stem serving forward " + json.dumps({
            "batch": SERVE_BATCH, "forward_ms": fwd_ms,
            "cudnn_stem_forward_ms": twin_fwd_ms, "stem_kernel_ms": stem_ms,
            "stem_kernel_share": stem_ms / fwd_ms}), flush=True)

        # 10(c): the plain stem, all 53 BNs folded, the s2d stem with a bias
        plain = ResNet50(class_num=1000, device="cuda",
                         generator=torch.Generator().manual_seed(1))
        _randomize_bn_state(plain, 2)
        x8 = torch.from_numpy(images[:8]).cuda()
        with torch.inference_mode():
            want = plain.eval()(x8).cpu().numpy()
        sk.stem_conv_forward.launches = 0
        pred = LocalPredictor(plain, batch_size=8, device="cuda")
        got = np.stack(pred.predict(images[:8]))
        stem = pred.model.get_submodule("0_conv1")
        left = sum(isinstance(m, BatchNormalization)
                   for m in pred.model.modules())
        err = float(np.abs(got - want).max())
        plain_out = {"batch": 8, "bns_left": left,
                     "stem": type(stem).__name__,
                     "stem_bias": stem.bias is not None,
                     "max_abs_err": err,
                     "limit": SERVE_ATOL * float(np.abs(want).max()),
                     "launches": sk.stem_conv_forward.launches}
        print("stem plain-stem branch " + json.dumps(plain_out), flush=True)
        check(left == 0 and type(stem) is S2D and stem.bias is not None,
              f"plain stem: {left} BNs left, stem {type(stem).__name__}, "
              f"bias {stem.bias is not None}")
        check(err <= plain_out["limit"] and np.isfinite(got).all(),
              f"plain stem: converted outputs off by {err:.3e}")
        check(plain_out["launches"] == 1,
              f"plain stem: kernel 5 launched {plain_out['launches']} "
              "times for one batch")
    finally:
        os.environ.pop(STEM_ENV, None)
    del model, twin, off, on, plain, pred
    torch.cuda.empty_cache()
    return launches


def stem_training_phase(sk):
    """10(d): training with the stem kernel."""
    from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
    from bigdl_tpu_torch.models import ResNet50
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer, max_iteration
    from bigdl_tpu_torch.tools import ab_stem

    torch.backends.cudnn.deterministic = True
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(8, 224, 224, 3).astype(np.float32))
    y = torch.from_numpy((rs.randint(0, 1000, size=8) + 1).astype(np.int32))
    batch = MiniBatch(x.cuda(), y.cuda())
    model = ResNet50(class_num=1000, s2d_stem=True, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    twin = ResNet50(class_num=1000, s2d_stem=True, device="cuda")
    twin.load_state_dict(model.state_dict())

    def train3(m):
        losses = []
        opt = DistriOptimizer(m, LocalDataSet([batch]), ClassNLLCriterion(),
                              devices=["cuda"])
        opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
        opt.set_end_when(max_iteration(3))
        opt.set_iteration_hook(lambda st: losses.append(st["loss"]))
        opt.optimize()
        return losses

    try:
        os.environ[STEM_ENV] = "1"
        sk.stem_conv_forward.launches = 0
        got = train3(model)
        launches = sk.stem_conv_forward.launches
    finally:
        os.environ.pop(STEM_ENV, None)
    ref = train3(twin)
    twin_launches = sk.stem_conv_forward.launches - launches
    rel = [abs(a - b) / abs(b) for a, b in zip(got, ref)]
    print("stem training parity " + json.dumps({
        "batch": 8, "steps": 3, "dtype": "float32", "losses": got,
        "twin_losses": ref, "rel_diff": rel, "launches": launches,
        "twin_launches": twin_launches}), flush=True)
    check(all(np.isfinite(got)) and max(rel) <= PARITY_RTOL,
          f"stem kernel f32 losses {got} vs twin {ref}: relative "
          f"{max(rel):.2e} > {PARITY_RTOL}")
    check(launches == 3 and twin_launches == 0,
          f"stem kernel launches {launches} (3 expected) and "
          f"{twin_launches} in the twin (0 expected)")
    del model, twin, batch
    torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()

    micro = ab_stem.stem_micro(device="cuda")
    print("stem ab micro " + json.dumps(micro), flush=True)
    check(micro["kernel_launches"] > 0, "the micro-benchmark launched no "
                                        "stem kernel")
    loop = ab_stem.full_loop(warmup=8, iters=24, device="cuda")
    print("stem ab loop " + json.dumps(loop), flush=True)
    for label, want in (("cudnn", 0), ("kernel", 32)):
        res = loop[label]
        check(res["stem_kernel_launches"] == want
              and np.isfinite(res["loss_last"]),
              f"ab loop {label}: {res['stem_kernel_launches']} stem kernel "
              f"launches (want {want}), last loss {res['loss_last']}")
    # the same weights and batch: the first bf16 losses differ only by the
    # stem's roundings
    first = (loop["cudnn"]["loss_first"], loop["kernel"]["loss_first"])
    check(abs(first[0] - first[1]) <= 1e-2 * abs(first[0]),
          f"ab loop first losses {first} differ by more than 1%")
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import attention_kernel as ak
    from bigdl_tpu_torch.ops import bn_relu_kernel as bk
    from bigdl_tpu_torch.ops import stem_kernel as sk

    # 2. build
    t0 = time.perf_counter()
    _build.build_kernels()
    print(f"build: {len(_build.KERNELS)} kernel(s) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    tc_build = build_phase(_build)

    # 3. kernel
    main_row = kernel_phase(ak)

    # 4. generation
    launches = generation_phase(ak)

    # 5. BN+ReLU kernels
    bn_rows = bn_relu_phase(bk)

    # 6. training
    bn_launches = training_phase(bk)

    # 7. flash backward kernels
    bwd_rows = flash_backward_phase(ak)

    # 8. LM training
    lm_launches = lm_training_phase(ak)

    # 9. sequence parallelism
    carry_row = carry_phase(ak)
    carry_launches, long_context = sequence_parallel_phase(ak)

    # 10. the space-to-depth stem
    stem_row = stem_kernel_phase(sk)
    stem_launches = stem_serving_phase(sk, bk, stem_row["ms"])
    stem_training_phase(sk)

    print(json.dumps({"kernels": [
        {**KERNEL_ROW, "launches": launches, **main_row, "status": "ok",
         "launches_lm_training": lm_launches["flash_attention_fwd"],
         "training_shape": {**bwd_rows["fwd_training_shape"],
                            "design": DESIGN[torch.bfloat16]},
         "long_context_shape": long_context,
         "build": tc_build["flash_attention_fwd"]},
        {**CARRY_ROW, "launches": carry_launches, **carry_row,
         "design": DESIGN[torch.bfloat16],
         "build": tc_build["flash_attention_carry"], "status": "ok"},
        {**DQ_ROW, "launches": lm_launches["flash_attention_bwd_dq"],
         **bwd_rows["dq"], "design": DESIGN[torch.bfloat16],
         "build": tc_build["flash_attention_bwd_dq"], "status": "ok"},
        {**DKV_ROW, "launches": lm_launches["flash_attention_bwd_dkv"],
         **bwd_rows["dkv"], "design": DESIGN[torch.bfloat16],
         "build": tc_build["flash_attention_bwd_dkv"], "status": "ok"},
        {**BN_FWD_ROW, "launches": bn_launches["bn_relu_fwd"],
         **bn_rows["fwd"], "design": "cuda_cores_f32", "status": "ok"},
        {**BN_BWD_ROW, "launches": bn_launches["bn_relu_bwd"],
         **bn_rows["bwd"], "design": "cuda_cores_f32", "status": "ok"},
        {**STEM_ROW, "launches": stem_launches, **stem_row,
         "build": tc_build["stem_conv"], "status": "ok"}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
