"""Normalization layers (counterpart of `bigdl_tpu/nn/normalization.py`).

Ported: `BatchNormalization`, `SpatialBatchNormalization` (NHWC) and
`LayerNormalization`.

BatchNorm keeps the reference's semantics exactly (`_stats_scale_shift`,
shared by the plain tail `forward` and the fused one
`forward_with_activation`):
- statistics in f32, also under bf16 input; the normalize runs in f32 and
  is cast back to the input's dtype;
- the biased variance normalizes, the unbiased one feeds the running stat;
- running stats `new = (1 - m) * old + m * batch` (m = `momentum`, 0.1),
  kept as f32 buffers `mean` and `var` (the JAX state's keys);
- the affine is folded into `scale = weight * rsqrt(var + eps)` and
  `shift = bias - mean * scale`, which the fused tail consumes as they are;
  with `affine=False` there is no weight and no bias, and `scale =
  rsqrt(var + eps)`, `shift = -mean * scale`;
- eval mode normalizes with the running stats;
- inside a data-parallel training step over several ranks
  (`parallel.collectives.data_parallel_step`, which the optimizer opens)
  the statistics are the global batch's, as under the reference's SPMD
  step, where XLA turns the batch-axis mean into a global reduction: the
  per-channel f32 sums and the element count are all-reduced and divided
  into the mean, then the sums of (x - mean)^2 are all-reduced and
  divided into the biased variance (two passes, as `x.var`; never
  E[x^2] - mean^2), and the running variance's unbiased correction uses
  the global count. The all-reduces are differentiable (their backward
  sums the gradient over the ranks), so autograd carries kernel 7's
  dscale/dshift through the global statistics, as SyncBatchNorm does;
  the fused tail stays kernel 6/7.
`F.batch_norm` is not used: its normalize is another function than the one
the fused kernel replaces.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.nn.module import Module, check_nhwc
from bigdl_tpu_torch.parallel import collectives


def _global_moments(x, axes):
    """(mean, biased variance, element count) of `x` over `axes` and over
    every rank of the data-parallel step: the sums and the count go in
    one all-reduce, the squared deviations from the global mean in a
    second."""
    n_local = math.prod(x.shape[a] for a in axes)
    s = x.sum(axes)
    total = collectives.all_reduce_sum(
        torch.cat([s, s.new_full((1,), n_local)]), "bn")
    n = total[-1].detach()
    mean = total[:-1] / n
    d = x - mean
    var = collectives.all_reduce_sum((d * d).sum(axes), "bn") / n
    return mean, var, n


class BatchNormalization(Module):
    """BN over the last axis of [B, C] input (reference 1-D BN)."""

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 name: Optional[str] = None, *, device=None):
        super().__init__(name)
        device = resolve_device(device)
        self.n_output = n_output
        self.eps, self.momentum, self.affine = eps, momentum, affine
        if affine:
            self.weight = nn.Parameter(torch.ones(n_output, device=device))
            self.bias = nn.Parameter(torch.zeros(n_output, device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("mean", torch.zeros(n_output, device=device))
        self.register_buffer("var", torch.ones(n_output, device=device))
        self._axes = (0,)  # the axes reduced over; subclasses override

    def _stats_scale_shift(self, x):
        """(x_f32, scale, shift, out_dtype): the statistics (updating the
        running stats in training mode) and the folded coefficients, shared
        by the plain and the fused tails."""
        out_dtype = x.dtype
        if x.is_floating_point() and torch.finfo(x.dtype).bits < 32:
            x = x.float()
        if self.training:
            if collectives.step_world() > 1:
                mean, var, n = _global_moments(x, self._axes)
                n_less_1 = torch.clamp(n - 1.0, min=1.0)
            else:
                mean = x.mean(self._axes)
                var = x.var(self._axes, correction=0)
                n = math.prod(x.shape[a] for a in self._axes)
                n_less_1 = max(n - 1.0, 1.0)
            m = self.momentum
            with torch.no_grad():
                unbiased = var * n / n_less_1
                self.mean.copy_((1 - m) * self.mean + m * mean)
                self.var.copy_((1 - m) * self.var + m * unbiased)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps)
        if self.affine:
            scale = self.weight.to(x.dtype) * inv
            shift = self.bias.to(x.dtype) - mean * scale
        else:
            scale, shift = inv, -mean * inv
        return x, scale, shift, out_dtype

    def forward(self, x):
        x, scale, shift, out_dtype = self._stats_scale_shift(x)
        return (x * scale + shift).to(out_dtype)

    def forward_with_activation(self, x, relu: bool = True):
        """BN + activation as one fused tail (`ops/bn_relu_kernel.py`): on
        the card one kernel each way instead of a normalize pass and a ReLU
        pass. Statistics, state updates and the folded coefficients are
        those of `forward`. The kernel reads x as an [N, C] matrix, so a
        non-NHWC-contiguous x is made contiguous first. It reads x in its
        own dtype: a bf16 x goes to the kernels as it is (`source=`), and
        its f32 copy, which the statistics use, stays the differentiable
        input, so autograd joins the kernel's dx with the statistics'
        gradient in f32 before the one cast back."""
        from bigdl_tpu_torch.ops.bn_relu_kernel import bn_relu
        if not x.is_contiguous():
            x = x.contiguous()
        x32, scale, shift, out_dtype = self._stats_scale_shift(x)
        return bn_relu(x32, scale, shift, relu, out_dtype,
                       source=None if x32 is x else x)


class SpatialBatchNormalization(BatchNormalization):
    """BN over the trailing channel axis of NHWC [B, H, W, C] input;
    `data_format="NCHW"` is not ported."""

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 data_format: str = "NHWC", name: Optional[str] = None, *,
                 device=None):
        check_nhwc(data_format, type(self).__name__)
        super().__init__(n_output, eps, momentum, affine, name,
                         device=device)
        self._axes = (0, 1, 2)


class LayerNormalization(Module):
    """Layer norm over the last axis with population variance:
    `(x - mean) * rsqrt(var + eps) * weight + bias`."""

    def __init__(self, hidden_size: int, eps: float = 1e-5,
                 name: Optional[str] = None, *, device=None):
        super().__init__(name)
        self.hidden_size, self.eps = hidden_size, eps
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device))
        self.bias = nn.Parameter(torch.zeros(hidden_size, device=device))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, unbiased=False, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias
