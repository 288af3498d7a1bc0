"""Int8 post-training quantized inference layers (counterpart of
`bigdl_tpu/nn/quantized.py`).

The reference's scheme (`DL/nn/quantized/`, the whitepaper's "2x speed / 4x
size at <0.1% accuracy drop", docs/docs/whitepaper.md:192-196): int8
weights with per-output-channel max-abs scales, and activations quantized
dynamically per sample. Inference only, as the reference's.

Layouts and parameters. The int8 `weight` keeps the JAX layout, HWIO for
the convolutions and [in, out] for the linears, so a JAX tree carries over
with no permute (`interop/jax_params.py`) and the full-int8 GEMM's B
operand of a convolution is `weight.reshape(kh * kw * C_in / g, O)` with no
copy. The int8 `weight`, the f32 `scale` ([1, out] or [1, 1, 1, out]) and
the `bias` are `nn.Parameter(requires_grad=False)`: the carry and the
checkpoint walk `named_parameters`, and see the tree the JAX package has.
The quantized convolutions are not `SpatialConvolution`s (nor are the
reference's), so the carry never permutes their weight.

Full int8 (`QuantizedLinear`, `QuantizedSpatialConvolution`): the int8 x
int8 -> int32 product is `torch._int_mm` (cuBLASLt IMMA on the card, the
int8 tensor cores; the same call on the CPU), through `int8_mm`, which
zero-pads to the card's shape limits (M > 16, K and N multiples of 8;
integer sums stay exact). The reference computes this product in
`lax.dot_general` / `lax.conv_general_dilated` outside any Pallas kernel.
A convolution is an int8 im2col: the quantized input zero-padded (q(0) =
0, so this equals quantizing the padded input; the per-sample scale is
over the unpadded x, as in the reference), kh * kw strided slices at the
dilated offsets joined in (kh, kw, c) order to match HWIO, one `_int_mm`
per group. A 1x1 stride-1 unpadded convolution is the activation's own
[N*H*W, C] view. The epilogue is the reference's `acc.float() * xs * scale
(+ bias)`, in its order and dtype promotion (a bf16 x gives a bf16 `xs`,
and f32 * bf16 -> f32).

Weight-only (`WeightOnlyQuantizedLinear`,
`WeightOnlyQuantizedSpatialConvolution`): `w.to(x.dtype) *
scale.to(x.dtype)`, then `x @ w` or `F.conv2d` on the channels_last view,
plus the bias in x's dtype: cuBLAS or cuDNN in x's dtype on the card, as
the reference's matmul and convolution are XLA's.

`int8_mm.launches` counts the `_int_mm` calls and `float_product.launches`
the weight-only layers' cuBLAS / cuDNN calls, on every device.
"""

from __future__ import annotations

import copy
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.nn.conv import PadT, explicit_pads
from bigdl_tpu_torch.nn.module import Module


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> [M, N] int32 through
    `torch._int_mm`. On the card `_int_mm` takes M > 16, K and N multiples
    of 8 and contiguous operands: a and b are zero-padded (M to 32 when M
    <= 16) and made contiguous, which leaves the integer sums exact, and
    the result is cut back to [M, N]. Counts its calls in
    `int8_mm.launches`."""
    m, k = a.shape
    n = b.shape[1]
    if b.shape[0] != k:
        raise ValueError(f"int8_mm: a is [{m}, {k}], b is {list(b.shape)}")
    mp, kp, np_ = (m if m > 16 else 32), _round8(k), _round8(n)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    int8_mm.launches += 1
    out = torch._int_mm(a.contiguous(), b.contiguous())
    return out if (mp, np_) == (m, n) else out[:m, :n]


int8_mm.launches = 0


def float_product(fn, *args):
    """`fn(*args)`: a weight-only layer's matmul or convolution (cuBLAS or
    cuDNN on the card), counted in `float_product.launches`."""
    float_product.launches += 1
    return fn(*args)


float_product.launches = 0


def _quantize_activation(x: torch.Tensor, dims):
    """Symmetric int8 of `x` with one max-abs scale over `dims` (per
    sample for an activation): (q int8 in x's layout, scale in x's dtype
    with x's rank). The scale is `max(amax, 1e-8) / 127` as a true
    division: CUDA divides by a Python scalar as a product with its
    reciprocal, one bit off the reference's on some values."""
    amax = x.abs().amax(dim=dims, keepdim=True)
    scale = amax.clamp_min(1e-8) / amax.new_full((), 127.0)
    q = torch.round(x / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def _quantize_weight(w: torch.Tensor, channel_axis: int):
    """Symmetric per-output-channel int8 (the reference's local scheme):
    (q int8 contiguous, scale f32 with w's rank, 1 off `channel_axis`)."""
    dims = tuple(d for d in range(w.dim()) if d != channel_axis)
    q, scale = _quantize_activation(w.contiguous(), dims)
    return q, scale.float()


def _layout_params(module, params: Optional[Mapping]):
    """A float layer's {"weight", "bias"} in the JAX layout (conv weights
    HWIO, linear [in, out]) as tensors on the layer's device: `params`
    (tensors or numpy arrays) if given, else the layer's own."""
    device = module.weight.device
    if params is None:
        w = module.weight.detach()
        if w.dim() == 4:  # OIHW -> HWIO
            w = w.permute(2, 3, 1, 0)
        params = {"weight": w}
        if module.bias is not None:
            params["bias"] = module.bias.detach()
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
                v, torch.Tensor) else v).to(device)
            for k, v in params.items()}


def _fill(q, w: torch.Tensor, channel_axis: int, bias):
    """Sets `q`'s int8 weight and scale from the float weight `w` and
    its bias (copied) from `bias`; returns `q` in eval mode."""
    wq, scale = _quantize_weight(w, channel_axis)
    q.weight, q.scale = _frozen(wq), _frozen(scale)
    if q.with_bias:
        q.bias = _frozen(bias.detach().clone())
    return q.eval()


def _dequantize(acc, xs, scale, bias):
    """The full-int8 epilogue, in the reference's order: `acc.float() * xs
    * scale (+ bias)`."""
    out = acc.float().mul_(xs).mul_(scale)
    return out if bias is None else out.add_(bias)


class QuantizedLinear(Module):
    """Full-int8 Linear (reference `QuantizedLinear`,
    DL/nn/quantized/Linear.scala). Parameters: int8 `weight` [in, out], f32
    `scale` [1, out], optional `bias`; leading axes beyond one are
    flattened and restored. Each row of x is quantized with its own
    scale."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, name: Optional[str] = None, *,
                 device=None):
        super().__init__(name)
        device = resolve_device(device)
        self.input_size, self.output_size = input_size, output_size
        self.with_bias = with_bias
        # a fresh PTQ layer means nothing; zeros keep the shapes
        self.weight = _frozen(torch.zeros(input_size, output_size,
                                          dtype=torch.int8, device=device))
        self.scale = _frozen(torch.ones(1, output_size, device=device))
        self.bias = _frozen(torch.zeros(output_size, device=device)) \
            if with_bias else None

    @classmethod
    def from_float(cls, module, params: Optional[Mapping] = None):
        """The quantized twin of a float `Linear`, in eval mode. `params`:
        the layer's {"weight" [in, out], "bias"} (tensors or numpy
        arrays); None means the module's own."""
        p = _layout_params(module, params)
        q = cls(module.input_size, module.output_size, module.with_bias,
                name=f"Quantized{module.name}", device=p["weight"].device)
        return _fill(q, p["weight"], 1, p.get("bias"))

    def accumulate(self, x):
        """(the int32 product [rows, out], x's per-row scale [rows, 1])
        of the flattened x."""
        xq, xs = _quantize_activation(x.reshape(-1, x.shape[-1]), (1,))
        return int8_mm(xq, self.weight), xs

    def forward(self, x):
        out = _dequantize(*self.accumulate(x), self.scale, self.bias)
        return out.reshape(*x.shape[:-1], self.output_size)


class WeightOnlyQuantizedLinear(QuantizedLinear):
    """Weight-only int8 Linear: the int8 weight dequantized at the matmul
    in x's dtype; activations and compute stay bf16 / f32 (the reference's
    TPU serving mode, 4x smaller weights)."""

    def forward(self, x):
        w = self.weight.to(x.dtype) * self.scale.to(x.dtype)
        out = float_product(torch.matmul, x, w)
        if self.bias is not None:
            out = out + self.bias.to(x.dtype)
        return out


def _int8_conv(xq, w, stride, pads, dilation, groups):
    """The int32 convolution of an NHWC int8 x with an HWIO int8 w: an
    im2col in (kh, kw, c) order, K zero-padded to a multiple of 8 inside
    the one copy, and one `int8_mm` per group. Returns [N, Ho, Wo, O]."""
    sh, sw = stride
    dh, dw = dilation
    top, bottom, left, right = pads
    kh, kw, cg, o = w.shape
    if any(pads):
        xq = F.pad(xq, (0, 0, left, right, top, bottom))
    n, hp, wp, _ = xq.shape
    ho = (hp - (kh - 1) * dh - 1) // sh + 1
    wo = (wp - (kw - 1) * dw - 1) // sw + 1
    m, k, og = n * ho * wo, kh * kw * cg, o // groups
    kp = _round8(k)
    taps = [xq[:, i * dh:i * dh + (ho - 1) * sh + 1:sh,
               j * dw:j * dw + (wo - 1) * sw + 1:sw]
            for i in range(kh) for j in range(kw)]
    wmat = w.reshape(k, o)
    if kp != k:
        wmat = F.pad(wmat, (0, 0, 0, kp - k))
    outs = []
    for g in range(groups):
        cols = [t[..., g * cg:(g + 1) * cg] for t in taps]
        if len(cols) == 1 and kp == k and cols[0].is_contiguous():
            a = cols[0].reshape(m, k)  # 1x1 stride 1: x's own view
        else:
            if kp != k:
                cols.append(xq.new_zeros(1, 1, 1, kp - k).expand(
                    n, ho, wo, kp - k))
            a = torch.cat(cols, dim=3).reshape(m, kp)
        outs.append(int8_mm(a, wmat[:, g * og:(g + 1) * og]))
    acc = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return acc.reshape(n, ho, wo, o)


class QuantizedSpatialConvolution(Module):
    """Full-int8 NHWC convolution (reference
    `QuantizedSpatialConvolution`, DL/nn/quantized/SpatialConvolution.scala).
    Parameters: int8 `weight` HWIO, f32 `scale` [1, 1, 1, out], optional
    `bias`. Each image is quantized with its own scale over (H, W, C).
    `pad_h` / `pad_w` of -1 or "SAME" mean TF-style SAME over the dilated
    kernel."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: PadT = 0, pad_h: PadT = 0,
                 n_group: int = 1, with_bias: bool = True,
                 dilation_w: int = 1, dilation_h: int = 1,
                 name: Optional[str] = None, *, device=None):
        super().__init__(name)
        device = resolve_device(device)
        self.n_in, self.n_out = n_input_plane, n_output_plane
        self.kw, self.kh = kernel_w, kernel_h
        self.sw, self.sh = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.groups = n_group
        self.with_bias = with_bias
        self.dw, self.dh = dilation_w, dilation_h
        self.weight = _frozen(torch.zeros(
            kernel_h, kernel_w, n_input_plane // n_group, n_output_plane,
            dtype=torch.int8, device=device))
        self.scale = _frozen(torch.ones(1, 1, 1, n_output_plane,
                                        device=device))
        self.bias = _frozen(torch.zeros(n_output_plane, device=device)) \
            if with_bias else None

    @classmethod
    def from_float(cls, module, params: Optional[Mapping] = None,
                   dilation_w: int = 1, dilation_h: int = 1):
        """The quantized twin of a float `SpatialConvolution` (or
        `SpatialDilatedConvolution`, whose dilation it takes), in eval
        mode. `params`: the layer's {"weight" HWIO, "bias"} (tensors or
        numpy arrays); None means the module's own."""
        p = _layout_params(module, params)
        q = cls(module.n_in, module.n_out, module.kw, module.kh, module.sw,
                module.sh, module.pad_w, module.pad_h, module.groups,
                module.with_bias,
                dilation_w=getattr(module, "dil_w", dilation_w),
                dilation_h=getattr(module, "dil_h", dilation_h),
                name=f"Quantized{module.name}", device=p["weight"].device)
        return _fill(q, p["weight"], 3, p.get("bias"))

    def _pads(self, x):
        return explicit_pads(x.shape[1], x.shape[2], self.kh, self.kw,
                             self.sh, self.sw, self.pad_h, self.pad_w,
                             self.dh, self.dw)

    def accumulate(self, x):
        """(the int32 convolution [N, Ho, Wo, O], x's per-image scale
        [N, 1, 1, 1])."""
        xq, xs = _quantize_activation(x, (1, 2, 3))
        return _int8_conv(xq, self.weight, (self.sh, self.sw), self._pads(x),
                          (self.dh, self.dw), self.groups), xs

    def forward(self, x):
        return _dequantize(*self.accumulate(x), self.scale, self.bias)


class QuantizedSpatialDilatedConvolution(QuantizedSpatialConvolution):
    """The reference's alias (DL/nn/quantized/SpatialDilatedConvolution.
    scala): dilation is already an argument of the base class."""


class WeightOnlyQuantizedSpatialConvolution(QuantizedSpatialConvolution):
    """Weight-only int8 NHWC convolution: see `WeightOnlyQuantizedLinear`.
    The dequantized HWIO weight runs as OIHW through `F.conv2d` on the
    channels_last view of x, as `SpatialConvolution` does."""

    def forward(self, x):
        w = self.weight.to(x.dtype) * self.scale.to(x.dtype)
        top, bottom, left, right = self._pads(x)
        x = x.permute(0, 3, 1, 2)
        if (top, left) != (bottom, right):
            x = F.pad(x, (left, right, top, bottom))
            top = left = 0
        out = float_product(F.conv2d, x, w.permute(3, 2, 0, 1), None,
                            (self.sh, self.sw), (top, left),
                            (self.dh, self.dw), self.groups)
        out = out.permute(0, 2, 3, 1)
        if self.bias is not None:
            out = out + self.bias.to(x.dtype)
        return out


class Quantizer:
    """Walks a trained model and swaps its supported layers for int8 ones
    (reference `Quantizer`, user surface `Module.quantize()`).

    Example:
        >>> import torch
        >>> from bigdl_tpu_torch.nn import Linear, Quantizer
        >>> m = Linear(4, 2, device="cpu")
        >>> q = Quantizer.quantize(m)  # m stays f32 and trainable
        >>> type(q).__name__
        'QuantizedLinear'
        >>> q(torch.ones(3, 4)).shape
        torch.Size([3, 2])
    """

    @staticmethod
    def quantize(module: nn.Module, weight_only: bool = False) -> nn.Module:
        """A NEW quantized module; the caller's float model is left intact
        (the reference clones before converting). Exactly `Linear`,
        `SpatialConvolution` and `SpatialDilatedConvolution` convert (by
        type: `SpaceToDepthStemConvolution` stays float); a converted
        container child's key becomes `"<i>_Quantized<name>"`, in place
        (a graph node keeps its key).
        A convertible top-level layer comes back converted.
        `weight_only=True` stores int8 weights and keeps the compute in
        x's dtype (`WeightOnlyQuantizedLinear`)."""
        module = copy.deepcopy(module)
        q = Quantizer._convert(module, None, weight_only)
        if q is not None:
            return q
        Quantizer._walk(module, weight_only)
        return module

    @staticmethod
    def _convert(module: nn.Module, params: Optional[Mapping] = None,
                 weight_only: bool = False) -> Optional[Module]:
        from bigdl_tpu_torch.nn.conv import (SpatialConvolution,
                                             SpatialDilatedConvolution)
        from bigdl_tpu_torch.nn.linear import Linear
        if type(module) is Linear:
            cls = WeightOnlyQuantizedLinear if weight_only \
                else QuantizedLinear
            return cls.from_float(module, params)
        if type(module) in (SpatialConvolution, SpatialDilatedConvolution):
            cls = WeightOnlyQuantizedSpatialConvolution if weight_only \
                else QuantizedSpatialConvolution
            return cls.from_float(module, params)
        return None

    @staticmethod
    def _walk(container, weight_only: bool = False) -> None:
        """Converts `container`'s children in place, recursing into child
        containers; a converted child is re-keyed `"<i>_<its name>"` at
        its position, except in a `Graph`, where the node keeps its key
        (the reference's: graph keys are written to model files)."""
        from bigdl_tpu_torch.nn.containers import Container, Graph
        if isinstance(container, Graph):
            for i, node in enumerate(container.exec_order):
                q = Quantizer._convert(node.module, None, weight_only)
                if q is not None:
                    container.set_node_module(i, q)
                elif isinstance(node.module, Container):
                    Quantizer._walk(node.module, weight_only)
            return
        children = list(container._modules.items())
        container._modules.clear()
        for i, (key, child) in enumerate(children):
            q = Quantizer._convert(child, None, weight_only)
            if q is not None:
                key, child = f"{i}_{q.name}", q
            elif isinstance(child, Container):
                Quantizer._walk(child, weight_only)
            container._modules[key] = child
