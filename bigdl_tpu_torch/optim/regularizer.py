"""Regularizers (counterpart of `bigdl_tpu/optim/regularizer.py`): L1,
L2 and L1L2 penalties. `grad_update(param, grad)` returns the gradient
with the penalty's gradient added, `loss(param)` the penalty. As in the
reference, the training loop does not attach them on its own; L2 is
usually the optimization method's `weight_decay`."""

from __future__ import annotations

import torch


class Regularizer:
    """The base penalty: none."""

    def grad_update(self, param, grad):
        return grad

    def loss(self, param):
        return 0.0


class L1L2Regularizer(Regularizer):
    """l1 * sum|p| + l2 / 2 * sum p^2; its gradient l1 * sign(p) + l2 * p."""

    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        self.l1, self.l2 = l1, l2

    def grad_update(self, param, grad):
        g = grad
        if self.l1:
            g = g + self.l1 * torch.sign(param)
        if self.l2:
            g = g + self.l2 * param
        return g

    def loss(self, param):
        out = 0.0
        if self.l1:
            out = out + self.l1 * torch.sum(torch.abs(param))
        if self.l2:
            out = out + 0.5 * self.l2 * torch.sum(param * param)
        return out


class L1Regularizer(L1L2Regularizer):
    """The L1 penalty alone."""

    def __init__(self, l1: float):
        super().__init__(l1=l1)


class L2Regularizer(L1L2Regularizer):
    """The L2 penalty alone."""

    def __init__(self, l2: float):
        super().__init__(l2=l2)
