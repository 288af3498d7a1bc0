"""Convolution layers (counterpart of `bigdl_tpu/nn/conv.py`).

Ported: `SpatialConvolution` (and its alias `SpatialShareConvolution`),
`SpatialDilatedConvolution` and `SpaceToDepthStemConvolution` (with the
route to the stem kernel, `ops/stem_kernel.py`).

Layout. Like the JAX package, the layers take and return NHWC tensors.
The weight is stored OIHW (PyTorch's layout; the carry from the JAX HWIO
kernel is a permute, `interop/jax_params.py`). A contiguous NHWC tensor
permuted to NCHW is a `torch.channels_last` tensor with no copy, so the
convolution runs on channels_last input, its output comes back
channels_last, and permuting it back gives a contiguous NHWC tensor: the
`[N*H*W, C]` view the fused BN+ReLU kernel reads is the activation's own
storage.

Both of the reference's branches of `SpatialConvolution` (im2col + GEMM for
C_in <= 4, the XLA convolution otherwise) compute the same convolution;
here one `F.conv2d` (cuDNN on the card) serves both. The JAX package also
leaves its convolutions to the compiler, outside any Pallas kernel.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.nn.initialization import (InitializationMethod, Xavier,
                                               Zeros, default_generator)
from bigdl_tpu_torch.nn.module import Module, check_nhwc
from bigdl_tpu_torch.ops.stem_kernel import stem_conv

PadT = Union[int, str]

#: the environment switch that routes `SpaceToDepthStemConvolution` to the
#: stem kernel, under the reference's name
STEM_ENV = "BIGDL_TPU_PALLAS_STEM"


def _same(pad) -> bool:
    return pad in ("SAME", -1)


def same_pads(size: int, k: int, s: int):
    """(before, after) padding of TF-style SAME along one axis: output
    ceil(size / s), the odd pixel after."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def explicit_pads(h: int, w: int, kh: int, kw: int, sh: int, sw: int,
                  pad_h: PadT, pad_w: PadT, dh: int = 1, dw: int = 1):
    """(top, bottom, left, right) zero padding of a convolution over an
    H x W input: SAME from the dilated kernel's extent (k - 1) * d + 1, as
    XLA's SAME with `rhs_dilation`, else `pad_h` / `pad_w` on both
    sides."""
    if _same(pad_h):
        return (*same_pads(h, (kh - 1) * dh + 1, sh),
                *same_pads(w, (kw - 1) * dw + 1, sw))
    return int(pad_h), int(pad_h), int(pad_w), int(pad_w)


class SpatialConvolution(Module):
    """2-D convolution over NHWC input, weight stored OIHW (reference
    `SpatialConvolution`, `bigdl_tpu/nn/conv.py:43`). `pad_h`/`pad_w` of -1
    or "SAME" (both or neither) mean TF-style SAME; `n_group` is the group
    count. The weight is drawn in the JAX HWIO shape (same fans as the
    reference) and permuted."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: PadT = 0, pad_h: PadT = 0,
                 n_group: int = 1, with_bias: bool = True,
                 weight_init: Optional[InitializationMethod] = None,
                 bias_init: Optional[InitializationMethod] = None,
                 data_format: str = "NHWC", name: Optional[str] = None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        check_nhwc(data_format, type(self).__name__)
        super().__init__(name)
        if _same(pad_h) != _same(pad_w):
            raise ValueError("SAME padding must be set on both pad_h and "
                             "pad_w")
        device = resolve_device(device)
        g = default_generator(generator)
        self.n_in, self.n_out = n_input_plane, n_output_plane
        self.kw, self.kh = kernel_w, kernel_h
        self.sw, self.sh = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.groups = n_group
        self.with_bias = with_bias
        hwio = (kernel_h, kernel_w, n_input_plane // n_group, n_output_plane)
        w = (weight_init or Xavier())(g, hwio, device=device)
        self.weight = nn.Parameter(w.permute(3, 2, 0, 1).contiguous())
        self.bias = nn.Parameter((bias_init or Zeros())(
            g, (n_output_plane,), device=device)) if with_bias else None

    def _dilation(self):
        """(dilation_h, dilation_w) of the kernel's taps."""
        return 1, 1

    def _conv(self, x_nchw):
        dh, dw = self._dilation()
        if _same(self.pad_h):
            top, bottom, left, right = explicit_pads(
                x_nchw.shape[2], x_nchw.shape[3], self.kh, self.kw, self.sh,
                self.sw, self.pad_h, self.pad_w, dh, dw)
            x_nchw = F.pad(x_nchw, (left, right, top, bottom))
            padding = (0, 0)
        else:
            padding = (int(self.pad_h), int(self.pad_w))
        return F.conv2d(x_nchw, self.weight, self.bias, (self.sh, self.sw),
                        padding, (dh, dw), self.groups)

    def forward(self, x):
        return self._conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class SpatialDilatedConvolution(SpatialConvolution):
    """Atrous convolution (reference `SpatialDilatedConvolution`,
    `bigdl_tpu/nn/conv.py:213`): `SpatialConvolution` with its kernel taps
    `dilation_h` / `dilation_w` pixels apart, one `F.conv2d(...,
    dilation=)`. SAME padding covers the dilated extent. The keyword
    arguments go to `SpatialConvolution` (`n_group`, `with_bias`, the
    initializers, `name`, `device`, `generator`)."""

    def __init__(self, n_input_plane: int, n_output_plane: int, kw: int,
                 kh: int, dw: int = 1, dh: int = 1, pad_w: PadT = 0,
                 pad_h: PadT = 0, dilation_w: int = 1, dilation_h: int = 1,
                 **kw_args):
        super().__init__(n_input_plane, n_output_plane, kw, kh, dw, dh,
                         pad_w, pad_h, **kw_args)
        self.dil_w, self.dil_h = dilation_w, dilation_h

    def _dilation(self):
        return self.dil_h, self.dil_w


def space_to_depth(x):
    """The 2x2 space-to-depth of an NHWC tensor with even H and W:
    [B, H, W, C] -> [B, H/2, W/2, 4C], channel order (h_offset, w_offset,
    c), contiguous."""
    b, h, w, c = x.shape
    return (x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(b, h // 2, w // 2, 4 * c).contiguous())


def s2d_kernel(w_oihw):
    """An OIHW k x k weight re-blocked for the space-to-depth input: HWIO,
    the front of H and W zero-padded to an even k + 1, then tap
    (2i+a, 2j+b, c) moved to (i, j, a*2C + b*C + c): [kt, kt, 4C, O] with
    kt = (k + 1) / 2, contiguous."""
    o, c, k, _ = w_oihw.shape
    kt = (k + 1) // 2
    wk = F.pad(w_oihw.permute(2, 3, 1, 0), (0, 0, 0, 0, 1, 0, 1, 0))
    return (wk.reshape(kt, 2, kt, 2, c, o).permute(0, 2, 1, 3, 4, 5)
            .reshape(kt, kt, 4 * c, o).contiguous())


# the reference's alias: its memory-sharing variant computes the same
# convolution
SpatialShareConvolution = SpatialConvolution


class SpaceToDepthStemConvolution(SpatialConvolution):
    """The stride-2 k x k stem (k % 4 == 3, pad (k-1)//2, no groups) of
    `bigdl_tpu/nn/conv.py:121`, with the same parameter tree as the plain
    stem.

    The reference restates the convolution as a stride-1 kt x kt
    convolution (kt = (k+1)/2) over the 2x2 space-to-depth input (4 * C_in
    channels), and with `pallas_stem` (or `BIGDL_TPU_PALLAS_STEM`) runs it
    through its Pallas stem kernel. The port routes as the reference does
    (`bigdl_tpu/nn/conv.py:166-210`):

    - odd H or W: the plain stride-2 convolution (the reference's fallback);
    - `pallas_stem=True`: the space-to-depth restatement through
      `ops/stem_kernel.py` `stem_conv` (the CUDA stem kernel on a CUDA
      tensor, its plain version on a CPU tensor; the plain convolution's
      gradients);
    - `pallas_stem=False`: the plain stride-2 convolution (cuDNN on the
      card), which is the same function;
    - `pallas_stem=None` (default): `BIGDL_TPU_PALLAS_STEM` read at each
      forward; "1", "true" or "yes" means `stem_conv`, anything else the
      plain convolution.
    """

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel: int = 7, with_bias: bool = False,
                 weight_init: Optional[InitializationMethod] = None,
                 bias_init: Optional[InitializationMethod] = None,
                 pallas_stem: Optional[bool] = None,
                 name: Optional[str] = None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        if kernel % 4 != 3:
            raise ValueError("SpaceToDepthStemConvolution needs kernel % 4 "
                             f"== 3, got {kernel}")
        pad = (kernel - 1) // 2
        super().__init__(n_input_plane, n_output_plane, kernel, kernel, 2, 2,
                         pad_w=pad, pad_h=pad, with_bias=with_bias,
                         weight_init=weight_init, bias_init=bias_init,
                         name=name, device=device, generator=generator)
        self.pallas_stem = pallas_stem

    def uses_stem_kernel(self) -> bool:
        """Whether an even-sized input goes through `stem_conv`."""
        if self.pallas_stem is not None:
            return bool(self.pallas_stem)
        return os.environ.get(STEM_ENV, "").lower() in ("1", "true", "yes")

    def forward(self, x):
        if x.shape[1] % 2 or x.shape[2] % 2 or not self.uses_stem_kernel():
            return super().forward(x)
        kt = (self.kh + 1) // 2
        front = (self.pad_h + 1) // 2
        return stem_conv(space_to_depth(x), s2d_kernel(self.weight),
                         self.bias, front, kt - 1 - front)
