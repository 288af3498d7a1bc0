"""The space-to-depth stem convolution and its CUDA kernel for Hopper.

Counterpart of `bigdl_tpu/ops/stem_kernel.py`. After the 2x2
space-to-depth restatement (`nn/conv.py` `SpaceToDepthStemConvolution`) a
stride-2 k x k stem is a stride-1 kt x kt convolution (kt = (k + 1) / 2)
over C2 = 4 * C_in channels, with the asymmetric padding
`pad_front + pad_rear == kt - 1`:

    x2 [B, H2, W2, C2] (f32 or bf16), wk [kt, kt, C2, O], bias [O] or None
    out[b, i, j, o] = bias[o] + sum_{dy, dx, c} xp[b, i+dy, j+dx, c]
                                                * wk[dy, dx, c, o]

where xp is x2 zero-padded by (pad_front, pad_rear) on H and W. The sum
runs in f32; the output takes x2's dtype. For ResNet-50: x2
[b, 112, 112, 12], kt = 4, O = 64, pads 2 / 1.

- `stem_conv_forward`: the CUDA kernel `csrc/stem_conv.cu` on a CUDA
  tensor (bf16 x2 and wk with O % 8 == 0 on the tensor cores, anything
  else on the CUDA cores), its plain version `stem_conv_forward_plain` on
  a CPU tensor. It
  never falls back: a CUDA tensor launches the kernel or raises. It counts
  its launches (`.launches`).
- `StemConvFunction`: the `torch.autograd.Function` around it, the
  counterpart of the reference's `jax.custom_vjp` `stem_conv`. The forward
  is the kernel; the backward is the gradient of the plain convolution
  (the reference's `_stem_xla`): x2 padded explicitly, a stride-1
  convolution's input, weight and bias gradients.
- `stem_conv`: the entry point `nn/conv.py` calls.

The reference's Mosaic workarounds (the stack of dx-shifted pre-padded
copies, `_pick_tile_w`) are not carried over: the kernel stages the input
halo itself and masks the padding and the ragged edge.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.observability import costs

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: what the kernel takes: C2 = 4 * C_in channels (C_in <= 4, the
#: restatement's eligibility) and kt = (k + 1) / 2 for k = 3, 7, 11
MAX_C2 = 16
KT_SIZES = (2, 4, 6)


def _pad_nhwc(x2, pad_front: int, pad_rear: int):
    return F.pad(x2, (0, 0, pad_front, pad_rear, pad_front, pad_rear))


def stem_conv_forward_plain(x2, wk, bias, pad_front: int, pad_rear: int):
    """The plain PyTorch version of the kernel: pad x2, gather the kt*kt
    taps into [B, H2, W2, kt*kt*C2] patches in (dy, dx, c) order (the
    order of `wk.reshape(-1, O)`), one f32 matmul, the bias, the cast to
    x2's dtype."""
    b, h, w, c2 = x2.shape
    kt, n_out = wk.shape[0], wk.shape[3]
    xp = _pad_nhwc(x2.float(), pad_front, pad_rear)
    patches = torch.cat([xp[:, dy:dy + h, dx:dx + w, :]
                         for dy in range(kt) for dx in range(kt)], dim=-1)
    acc = patches.reshape(-1, kt * kt * c2) @ wk.float().reshape(-1, n_out)
    if bias is not None:
        acc = acc + bias.float()
    return acc.reshape(b, h, w, n_out).to(x2.dtype)


# --------------------------------------------------------------------------
# The CUDA kernel (csrc/stem_conv.cu), via ctypes
# --------------------------------------------------------------------------

_FN = []


def _kernel_fn():
    if not _FN:
        from bigdl_tpu_torch.ops._build import load_kernel
        lib = load_kernel("stem_conv")
        fn = lib.stem_conv
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = lib.stem_conv_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _FN.append((fn, err))
    return _FN[0]


def _check(x2, wk, bias, pad_front: int, pad_rear: int):
    if x2.dim() != 4 or wk.dim() != 4:
        raise ValueError(f"x2 must be [B, H2, W2, C2] and wk [kt, kt, C2, "
                         f"O], got {tuple(x2.shape)} and {tuple(wk.shape)}")
    kt, kt2, c2, n_out = wk.shape
    if kt != kt2 or x2.shape[3] != c2:
        raise ValueError(f"wk {tuple(wk.shape)} does not fit x2 "
                         f"{tuple(x2.shape)}")
    if min(x2.shape) < 1 or n_out < 1:
        raise ValueError(f"empty input: x2 {tuple(x2.shape)}, wk "
                         f"{tuple(wk.shape)}")
    if pad_front < 0 or pad_rear < 0 or pad_front + pad_rear != kt - 1:
        raise ValueError(f"pads ({pad_front}, {pad_rear}) must be >= 0 and "
                         f"sum to kt - 1 = {kt - 1}")
    for name, t in (("x2", x2), ("wk", wk)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (strides "
                             f"{t.stride()}); the kernel never reinterprets "
                             "strides")
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x2 on {x2.device}")
    if bias is not None and (bias.shape != (n_out,)
                             or bias.device != x2.device):
        raise ValueError(f"bias must be [{n_out}] on {x2.device}, got "
                         f"{tuple(bias.shape)} on {bias.device}")


def stem_flops(x2, wk) -> int:
    """FLOPs of one launch: 2*k*k*C_in an output element, the count of
    the k x k convolution the s2d GEMM restates (k = 2*kt - 1, C_in =
    C2 / 4; the GEMM's zero-padded taps are not counted)."""
    b, h, w, c2 = x2.shape
    kt, n_out = wk.shape[0], wk.shape[3]
    k = 2 * kt - 1
    return 2 * k * k * (c2 // 4) * b * h * w * n_out


def stem_conv_forward(x2, wk, bias, pad_front: int, pad_rear: int):
    """The stem convolution over x2 [B, H2, W2, C2] (f32 or bf16,
    contiguous) with wk [kt, kt, C2, O] (f32 or bf16, contiguous) and
    bias [O] or None: the CUDA kernel on a CUDA tensor, its plain version
    on a CPU tensor. The kernel takes C2 <= 16 and kt in (2, 4, 6) and
    raises on anything else. `stem_conv_forward.launches` counts kernel
    launches."""
    _check(x2, wk, bias, pad_front, pad_rear)

    def flops():
        return stem_flops(x2, wk)

    if x2.device.type == "cpu":
        return costs.plain_route(flops, stem_conv_forward_plain, x2, wk, bias,
                                 pad_front, pad_rear)
    if x2.device.type == "meta" and costs.counting():
        costs.tally_kernel(flops)
        return x2.new_empty((*x2.shape[:3], wk.shape[3]))
    if x2.device.type != "cuda":
        raise NotImplementedError(
            f"no stem convolution for device type {x2.device.type!r}")
    b, h, w, c2 = x2.shape
    kt, n_out = wk.shape[0], wk.shape[3]
    if c2 > MAX_C2 or kt not in KT_SIZES:
        raise ValueError(f"the stem kernel takes C2 <= {MAX_C2} and kt in "
                         f"{KT_SIZES}, got C2 = {c2}, kt = {kt}")
    out = torch.empty((b, h, w, n_out), dtype=x2.dtype, device=x2.device)
    b32 = bias.float().contiguous() if bias is not None else None
    fn, err_str = _kernel_fn()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        code = fn(x2.data_ptr(), wk.data_ptr(),
                  b32.data_ptr() if b32 is not None else None,
                  out.data_ptr(), b, h, w, c2, n_out, kt, pad_front,
                  _DTYPE_CODES[x2.dtype], _DTYPE_CODES[wk.dtype],
                  int(b32 is not None), stream)
    if code != 0:
        raise RuntimeError(f"stem_conv launch failed: "
                           f"{err_str(code).decode()} (cudaError {code})")
    stem_conv_forward.launches += 1
    costs.tally_kernel(flops)
    return out


stem_conv_forward.launches = 0


def _nchw(t):
    return t.permute(0, 3, 1, 2)


class StemConvFunction(torch.autograd.Function):
    """`stem_conv_forward` with the plain convolution's gradients: the
    backward pads x2 explicitly (the padding is asymmetric, which
    `F.conv2d`'s `padding` cannot say) and takes a stride-1 convolution's
    input, weight and bias gradients (`aten.convolution_backward`, cuDNN
    on the card)."""

    @staticmethod
    def forward(ctx, x2, wk, bias, pad_front: int, pad_rear: int):
        ctx.save_for_backward(x2, wk, bias)
        ctx.pads = (pad_front, pad_rear)
        return stem_conv_forward(x2, wk, bias, pad_front, pad_rear)

    @staticmethod
    def backward(ctx, g):
        x2, wk, bias = ctx.saved_tensors
        front, rear = ctx.pads
        h, w = x2.shape[1], x2.shape[2]
        xp = _nchw(_pad_nhwc(x2, front, rear))
        w_oihw = wk.to(x2.dtype).permute(3, 2, 0, 1).contiguous()
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        gx, gw, gb = torch.ops.aten.convolution_backward(
            _nchw(g.to(x2.dtype)), xp, w_oihw,
            [wk.shape[3]] if bias is not None else None,
            [1, 1], [0, 0], [1, 1], False, [0, 0], 1,
            [need_x, need_w, need_b and bias is not None])
        if gx is not None:
            gx = gx.permute(0, 2, 3, 1)[:, front:front + h, front:front + w]
        if gw is not None:
            gw = gw.permute(2, 3, 1, 0).to(wk.dtype)
        if gb is not None:
            gb = gb.to(bias.dtype)
        return gx, gw, gb, None, None


def stem_conv(x2, wk, bias: Optional[torch.Tensor], pad_front: int,
              pad_rear: int):
    """The s2d stem convolution, the layer's entry point: with grad on and
    an input that requires it, `StemConvFunction` (the kernel forward, the
    plain convolution's gradients); otherwise the forward alone. CUDA
    tensors run the kernel, CPU tensors its plain version."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x2, wk, bias)):
        return StemConvFunction.apply(x2, wk, bias, pad_front, pad_rear)
    return stem_conv_forward(x2, wk, bias, pad_front, pad_rear)
