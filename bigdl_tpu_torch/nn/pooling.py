"""Pooling layers (counterpart of `bigdl_tpu/nn/pooling.py`), NHWC.

Ported: `SpatialMaxPooling` (with `pad` and `ceil_mode`),
`SpatialAveragePooling` without padding (the CIFAR type-A shortcut's use)
and `Pooler`. Like the convolutions, the pools permute NHWC to a
channels_last NCHW view (no copy) and back.
"""

from __future__ import annotations

from typing import Optional

import torch.nn.functional as F

from bigdl_tpu_torch.nn.conv import same_pads
from bigdl_tpu_torch.nn.module import Module


def _ceil_extra(i: int, k: int, s: int, p: int) -> int:
    """Padding added after the input in ceil mode so that the last window
    fits (the reference's `_pool_pad`)."""
    out = -(-(i + 2 * p - k) // s) + 1
    return max(0, (out - 1) * s + k - (i + 2 * p))


class SpatialMaxPooling(Module):
    """Max over kh x kw windows with stride (dh, dw), NHWC. Padding is
    -inf, as in the reference's `reduce_window`: `pad_h`/`pad_w` on both
    sides (-1 or "SAME": TF-style SAME), and in ceil mode extra padding
    after the input so that the last window fits."""

    def __init__(self, kw: int, kh: int, dw: Optional[int] = None,
                 dh: Optional[int] = None, pad_w: int = 0, pad_h: int = 0,
                 ceil_mode: bool = False, name: Optional[str] = None):
        super().__init__(name)
        self.kw, self.kh = kw, kh
        self.dw, self.dh = dw or kw, dh or kh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.ceil_mode = ceil_mode

    def _pads(self, h: int, w: int):
        """((top, bottom), (left, right)) padding."""
        if self.pad_h in (-1, "SAME"):
            return (same_pads(h, self.kh, self.dh),
                    same_pads(w, self.kw, self.dw))
        ph, pw = int(self.pad_h), int(self.pad_w)
        if not self.ceil_mode:
            return (ph, ph), (pw, pw)
        return ((ph, ph + _ceil_extra(h, self.kh, self.dh, ph)),
                (pw, pw + _ceil_extra(w, self.kw, self.dw, pw)))

    def _pool(self, x):
        (top, bottom), (left, right) = self._pads(x.shape[2], x.shape[3])
        k, s = (self.kh, self.kw), (self.dh, self.dw)
        if top == bottom <= self.kh // 2 and left == right <= self.kw // 2:
            # symmetric padding within half a window: PyTorch's own
            # implicit padding, which is -inf
            return F.max_pool2d(x, k, s, (top, left))
        x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
        return F.max_pool2d(x, k, s)

    def forward(self, x):
        return self._pool(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class SpatialAveragePooling(Module):
    """Mean over kh x kw windows with stride (dh, dw), NHWC, no padding."""

    def __init__(self, kw: int, kh: int, dw: Optional[int] = None,
                 dh: Optional[int] = None, name: Optional[str] = None):
        super().__init__(name)
        self.kw, self.kh = kw, kh
        self.dw, self.dh = dw or kw, dh or kh

    def forward(self, x):
        y = F.avg_pool2d(x.permute(0, 3, 1, 2), (self.kh, self.kw),
                         (self.dh, self.dw))
        return y.permute(0, 2, 3, 1)


class Pooler(Module):
    """Global average pool, NHWC [B, H, W, C] -> [B, C]."""

    def forward(self, x):
        return x.mean(dim=(1, 2))
