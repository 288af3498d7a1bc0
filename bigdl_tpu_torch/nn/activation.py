"""Activations (counterpart of `bigdl_tpu/nn/activation.py`).

Ported: `ReLU` and `LogSoftMax`, what the ResNets use.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.module import Module


class ReLU(Module):
    """max(x, 0), with a zero gradient at 0 as `jax.nn.relu` has. `ip` is
    accepted for API parity and ignored. A `ReLU` right after a
    `BatchNormalization` in a `Sequential` is fused into the BN's tail
    (`nn/fusion.py`)."""

    def __init__(self, ip: bool = False, name: Optional[str] = None):
        super().__init__(name)

    def forward(self, x):
        return torch.relu(x)


class LogSoftMax(Module):
    """log(softmax(x)) over the last axis."""

    def forward(self, x):
        return torch.log_softmax(x, dim=-1)
