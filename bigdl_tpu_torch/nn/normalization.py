"""Normalization layers (counterpart of `bigdl_tpu/nn/normalization.py`).

Only `LayerNormalization` is ported in this slice.
"""

from __future__ import annotations

import torch
from torch import nn


class LayerNormalization(nn.Module):
    """Layer norm over the last axis with population variance:
    `(x - mean) * rsqrt(var + eps) * weight + bias`."""

    def __init__(self, hidden_size: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.hidden_size, self.eps = hidden_size, eps
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device))
        self.bias = nn.Parameter(torch.zeros(hidden_size, device=device))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, unbiased=False, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias
