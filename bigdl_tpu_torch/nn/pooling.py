"""Pooling layers (counterpart of `bigdl_tpu/nn/pooling.py`), NHWC.

Ported: `SpatialMaxPooling` and `SpatialAveragePooling` (with `pad`,
`ceil_mode`, and for the average `count_include_pad` and `divide`), NHWC
only, and `Pooler`. Like the convolutions, the pools permute NHWC to a
channels_last NCHW view (no copy) and back.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.conv import same_pads
from bigdl_tpu_torch.nn.module import Module, check_nhwc


def _ceil_extra(i: int, k: int, s: int, p: int) -> int:
    """Padding added after the input in ceil mode so that the last window
    fits (the reference's `_pool_pad`)."""
    out = -(-(i + 2 * p - k) // s) + 1
    return max(0, (out - 1) * s + k - (i + 2 * p))


class _Pool2d(Module):
    """Window, stride and padding of the reference's 2-D pools, NHWC."""

    def __init__(self, kw: int, kh: int, dw: Optional[int], dh: Optional[int],
                 pad_w, pad_h, ceil_mode: bool, data_format: str,
                 name: Optional[str]):
        check_nhwc(data_format, type(self).__name__)
        super().__init__(name)
        self.kw, self.kh = kw, kh
        self.dw, self.dh = dw or kw, dh or kh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.ceil_mode = ceil_mode

    def _same(self) -> bool:
        return self.pad_h in (-1, "SAME")

    def _pads(self, h: int, w: int):
        """((top, bottom), (left, right)) padding."""
        if self._same():
            return (same_pads(h, self.kh, self.dh),
                    same_pads(w, self.kw, self.dw))
        ph, pw = int(self.pad_h), int(self.pad_w)
        if not self.ceil_mode:
            return (ph, ph), (pw, pw)
        return ((ph, ph + _ceil_extra(h, self.kh, self.dh, ph)),
                (pw, pw + _ceil_extra(w, self.kw, self.dw, pw)))

    def forward(self, x):
        return self._pool(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class SpatialMaxPooling(_Pool2d):
    """Max over kh x kw windows with stride (dh, dw), NHWC. Padding is
    -inf, as in the reference's `reduce_window`: `pad_h`/`pad_w` on both
    sides (-1 or "SAME": TF-style SAME), and in ceil mode extra padding
    after the input so that the last window fits."""

    def __init__(self, kw: int, kh: int, dw: Optional[int] = None,
                 dh: Optional[int] = None, pad_w: int = 0, pad_h: int = 0,
                 ceil_mode: bool = False, data_format: str = "NHWC",
                 name: Optional[str] = None):
        super().__init__(kw, kh, dw, dh, pad_w, pad_h, ceil_mode,
                         data_format, name)

    def _pool(self, x):
        (top, bottom), (left, right) = self._pads(x.shape[2], x.shape[3])
        k, s = (self.kh, self.kw), (self.dh, self.dw)
        if top == bottom <= self.kh // 2 and left == right <= self.kw // 2:
            # symmetric padding within half a window: PyTorch's own
            # implicit padding, which is -inf
            return F.max_pool2d(x, k, s, (top, left))
        x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
        return F.max_pool2d(x, k, s)


class SpatialAveragePooling(_Pool2d):
    """Mean over kh x kw windows with stride (dh, dw), NHWC, with the
    reference's padding: zeros, `pad_h`/`pad_w` on both sides (-1 or
    "SAME": TF-style SAME) and in ceil mode extra after the input. The sum
    is divided by kh * kw when `count_include_pad` (SAME excepted), else
    by the count of input elements in the window; `divide=False` gives the
    sum."""

    def __init__(self, kw: int, kh: int, dw: Optional[int] = None,
                 dh: Optional[int] = None, pad_w: int = 0, pad_h: int = 0,
                 ceil_mode: bool = False, count_include_pad: bool = True,
                 divide: bool = True, data_format: str = "NHWC",
                 name: Optional[str] = None):
        super().__init__(kw, kh, dw, dh, pad_w, pad_h, ceil_mode,
                         data_format, name)
        self.count_include_pad = count_include_pad
        self.divide = divide

    def _pool(self, x):
        (top, bottom), (left, right) = self._pads(x.shape[2], x.shape[3])
        k, s = (self.kh, self.kw), (self.dh, self.dw)
        if top == bottom == left == right == 0:
            return F.avg_pool2d(x, k, s) if self.divide \
                else F.avg_pool2d(x, k, s, divisor_override=1)
        pads = (left, right, top, bottom)
        total = F.avg_pool2d(F.pad(x, pads), k, s, divisor_override=1)
        if not self.divide:
            return total
        if self.count_include_pad and not self._same():
            return total / float(self.kh * self.kw)
        ones = torch.ones_like(x[:1, :1])
        return total / F.avg_pool2d(F.pad(ones, pads), k, s,
                                    divisor_override=1)


class Pooler(Module):
    """Global average pool, NHWC [B, H, W, C] -> [B, C]."""

    def forward(self, x):
        return x.mean(dim=(1, 2))
