"""Criteria (counterpart of `bigdl_tpu/nn/criterion.py`).

Ported: `ClassNLLCriterion`, the classification loss,
`TimeDistributedCriterion`, the per-time-step loss of the language models,
`TimeDistributedMaskCriterion`, its padding-aware form for ragged text,
and `MSECriterion`, the autoencoder's loss.

Inside a data-parallel step over W ranks (`parallel.collectives`), a loss
whose denominator depends on the data (the weighted mean of
`ClassNLLCriterion`, the kept positions of `TimeDistributedMaskCriterion`)
divides by the global denominator over W, all-reduced
(`collectives.dp_denominator`): the mean of the
ranks' losses, and of their gradients, is then the global batch's, as
the reference's SPMD step computes it. A fixed denominator (the rows, the
steps) needs nothing: the ranks' shards are equal.
"""

from __future__ import annotations

import torch
from torch import nn

from bigdl_tpu_torch.parallel import collectives


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
            if not self.size_average:
                return total
            return total / collectives.dp_denominator(w.sum(-1))
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


class MSECriterion(nn.Module):
    """Squared error: its mean with `size_average`, else its sum."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def forward(self, output, target):
        d = output - torch.as_tensor(target, device=output.device)
        return (d * d).mean() if self.size_average else (d * d).sum()


class TimeDistributedMaskCriterion(nn.Module):
    """The mean negative log-likelihood over the time steps whose target
    is not `padding_value`: `output` [..., C] and 1-based targets [...]
    are flattened, the padded positions masked out, and the picked
    log-probabilities averaged over the positions kept (at least one).
    The output is taken as log-probabilities when `critrn` is a
    `ClassNLLCriterion` and as logits (log-softmax first) otherwise; the
    inner criterion's other settings (weights, `size_average`,
    `zero_based`) play no part, as in the reference."""

    def __init__(self, critrn: nn.Module, padding_value: int = 0):
        super().__init__()
        self.critrn = critrn
        self.padding_value = padding_value

    def forward(self, output, target):
        o = output.reshape(-1, output.shape[-1])
        t = torch.as_tensor(target, device=output.device).reshape(-1)
        mask = (t != self.padding_value).to(o.dtype)
        safe_t = torch.where(mask > 0, t, torch.ones_like(t))
        logp = o if isinstance(self.critrn, ClassNLLCriterion) \
            else torch.log_softmax(o, dim=-1)
        picked = logp.gather(1, (safe_t.long() - 1)[:, None])[:, 0]
        kept = collectives.dp_denominator(mask.sum(), min_value=1.0)
        return -(picked * mask).sum() / kept
