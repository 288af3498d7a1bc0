"""Criteria (counterpart of `bigdl_tpu/nn/criterion.py`).

Ported: `ClassNLLCriterion`, the classification loss, and
`TimeDistributedCriterion`, the per-time-step loss of the language models.
"""

from __future__ import annotations

import torch
from torch import nn


class ClassNLLCriterion(nn.Module):
    """Negative log-likelihood over log-probabilities `[..., C]` (pair
    with `LogSoftMax`) and class targets, 1-based unless `zero_based`.
    With `logProbAsInput=False` the input is probabilities, taken as
    `log(p + 1e-8)` first, as the reference does. `weights` rescales each
    class; with `size_average` the loss is the mean (weighted: the sum
    over the sum of the picked weights), else the sum."""

    def __init__(self, weights=None, size_average: bool = True,
                 logProbAsInput: bool = True, zero_based: bool = False):
        super().__init__()
        self.weights = None if weights is None \
            else torch.as_tensor(weights, dtype=torch.float32)
        self.size_average = size_average
        self.log_prob = logProbAsInput
        self.zero_based = zero_based

    def losses(self, output, target):
        """The loss of each group of rows at once: `output` [G, N, C]
        log-probs and `target` [G, N] classes give the [G] losses that
        `forward` would give for each group g of N rows."""
        if not self.log_prob:
            output = torch.log(output + 1e-8)
        t = torch.as_tensor(target, device=output.device).long()
        if not self.zero_based:
            t = t - 1
        picked = output.gather(-1, t[..., None])[..., 0]
        if self.weights is not None:
            w = self.weights.to(output.device)[t]
            total = (-picked * w).sum(-1)
            return total / w.sum(-1) if self.size_average else total
        return -picked.mean(-1) if self.size_average else -picked.sum(-1)

    def forward(self, output, target):
        logp = output.reshape(1, -1, output.shape[-1])
        t = torch.as_tensor(target, device=logp.device).reshape(1, -1)
        return self.losses(logp, t)[0]


class TimeDistributedCriterion(nn.Module):
    """Apply `critrn` at every step of `dimension` (default 1, the time
    axis of [B, T, ...]) and sum over the steps; with `size_average`,
    divide by the number of steps.

    The reference loops over the steps in Python, which XLA fuses under
    `jit`; in eager PyTorch that loop would cost a few launches per step,
    tens of thousands a training step at T = 2048. So an inner criterion
    with a `losses(output [G, N, C], target [G, N])` method (every one
    ported: `ClassNLLCriterion`) takes all steps in one call: the steps
    become the groups, each reduced as the inner criterion reduces a step,
    then summed. The same value, summed in another order. Any other inner
    criterion gets the reference's loop."""

    def __init__(self, critrn: nn.Module, size_average: bool = False,
                 dimension: int = 1):
        super().__init__()
        self.critrn = critrn
        self.size_average = size_average
        self.dimension = dimension

    def forward(self, output, target):
        dim = self.dimension
        target = torch.as_tensor(target, device=output.device)
        steps = output.shape[dim]
        if hasattr(self.critrn, "losses"):
            out = output.movedim(dim, 0)
            total = self.critrn.losses(
                out.reshape(steps, -1, out.shape[-1]),
                target.movedim(dim, 0).reshape(steps, -1)).sum()
        else:
            total = sum(self.critrn(output.select(dim, t),
                                    target.select(dim, t))
                        for t in range(steps))
        return total / steps if self.size_average else total
