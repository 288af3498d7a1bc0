"""Criteria (counterpart of `bigdl_tpu/nn/criterion.py`).

Ported: `ClassNLLCriterion`, the ResNet training loss.
"""

from __future__ import annotations

import torch
from torch import nn


class ClassNLLCriterion(nn.Module):
    """Negative log-likelihood over log-probabilities `[..., C]` (pair
    with `LogSoftMax`) and class targets, 1-based unless `zero_based`.
    `weights` rescales each class; with `size_average` the loss is the
    mean (weighted: the sum over the sum of the picked weights), else the
    sum."""

    def __init__(self, weights=None, size_average: bool = True,
                 zero_based: bool = False):
        super().__init__()
        self.weights = None if weights is None \
            else torch.as_tensor(weights, dtype=torch.float32)
        self.size_average = size_average
        self.zero_based = zero_based

    def forward(self, output, target):
        logp = output.reshape(-1, output.shape[-1])
        t = torch.as_tensor(target, device=logp.device).long().reshape(-1)
        if not self.zero_based:
            t = t - 1
        picked = logp.gather(1, t[:, None])[:, 0]
        if self.weights is not None:
            w = self.weights.to(logp.device)[t]
            losses = -picked * w
            return losses.sum() / w.sum() if self.size_average \
                else losses.sum()
        return -picked.mean() if self.size_average else -picked.sum()
