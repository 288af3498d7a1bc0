"""Optimization methods (counterpart of `bigdl_tpu/optim/optim_method.py`).

Ported: the `OptimMethod` base (with the f32-master wrappers), `SGD`,
`Adam` and `AdamW`.

A method works on dicts of tensors keyed by parameter name:
`init_state(params)` makes the slot state (SGD's velocity, Adam's
moments), and
`update(grads, opt_state, params, lr)` applies one step. Where the JAX
package returns new trees, the port updates `params` and `opt_state` IN
PLACE (under `torch.no_grad`) and returns them, which saves a copy of
every parameter and slot per step; the arithmetic is the reference's.
The host-side bookkeeping (`state`: epoch, neval, ...) is the reference's.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from bigdl_tpu_torch.optim.schedules import Default, LearningRateSchedule

Tree = Dict[str, torch.Tensor]


class OptimMethod:
    """Base optimization method; `state` mirrors the reference's state
    table (epoch, neval, recordsProcessedThisEpoch, ...)."""

    _MASTER_KEY = "__f32_masters__"

    def __init__(self, learning_rate: float = 1e-3,
                 weight_decay: float = 0.0):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.state: Dict[str, Any] = {"epoch": 0, "neval": 0,
                                      "recordsProcessedThisEpoch": 0}

    def init_state(self, params: Tree) -> Any:
        return {}

    def update(self, grads: Tree, opt_state, params: Tree, lr: float):
        """One step, in place; returns (params, opt_state)."""
        raise NotImplementedError

    def _decay(self, grads: Tree, params: Tree) -> Tree:
        if self.weight_decay:
            wd = self.weight_decay
            return {k: g + wd * params[k] for k, g in grads.items()}
        return grads

    # -- f32 master weights for sub-f32 parameters ------------------------
    #
    # With bf16 parameters (not the compute cast of set_compute_precision,
    # whose masters are the f32 parameters themselves), a bare update loses
    # every lr*grad below half a bf16 ulp of the weight. The wrappers keep
    # f32 masters in opt_state, run the method's update on them (slots in
    # f32 too) and write each parameter back as its master cast to the
    # parameter's dtype. All-f32 parameters pass through untouched.

    @staticmethod
    def _has_low_precision(params: Tree) -> bool:
        return any(p.is_floating_point() and torch.finfo(p.dtype).bits < 32
                   for p in params.values())

    def init_state_with_masters(self, params: Tree):
        """`init_state`, plus f32 masters when any parameter is a sub-f32
        float. The optimizers call this and `update_with_masters`."""
        if not self._has_low_precision(params):
            return self.init_state(params)
        masters = {k: p.detach().float().clone() if p.is_floating_point()
                   else p for k, p in params.items()}
        return {self._MASTER_KEY: masters,
                "slots": self.init_state(masters)}

    def update_with_masters(self, grads: Tree, opt_state, params: Tree,
                            lr: float):
        """`update` against the f32 masters when opt_state holds them:
        gradients upcast, the update in f32, each parameter set to its new
        master cast to the parameter's dtype."""
        if not (isinstance(opt_state, dict)
                and self._MASTER_KEY in opt_state):
            return self.update(grads, opt_state, params, lr)
        masters = opt_state[self._MASTER_KEY]
        grads32 = {k: g.float() if g.is_floating_point() else g
                   for k, g in grads.items()}
        _, slots = self.update(grads32, opt_state["slots"], masters, lr)
        with torch.no_grad():
            for k, p in params.items():
                if p.is_floating_point():
                    p.copy_(masters[k])
        return params, {self._MASTER_KEY: masters, "slots": slots}

    def current_lr(self) -> float:
        return float(self.learning_rate)


class SGD(OptimMethod):
    """SGD with momentum, dampening, nesterov and weight decay, and a
    learning-rate schedule (reference `SGD`). Dampening defaults to
    `momentum` (the reference's rule, not `torch.optim.SGD`'s 0):
        g = grad + weight_decay * p
        v = momentum * v + (1 - dampening) * g
        p = p - lr * (g + momentum * v if nesterov else v)
    and with momentum 0, p = p - lr * g."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0, momentum: float = 0.0,
                 dampening: Optional[float] = None, nesterov: bool = False,
                 learning_rate_schedule: Optional[
                     LearningRateSchedule] = None):
        super().__init__(learning_rate, weight_decay)
        self.learning_rate_decay = learning_rate_decay
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        self.nesterov = nesterov
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError(
                "Nesterov momentum requires momentum > 0 and dampening = 0")
        self.schedule = learning_rate_schedule or Default()

    def init_state(self, params: Tree):
        if self.momentum > 0:
            return {"velocity": {k: torch.zeros_like(p)
                                 for k, p in params.items()}}
        return {}

    def current_lr(self) -> float:
        return self.schedule.compute(self)

    def update(self, grads: Tree, opt_state, params: Tree, lr: float):
        with torch.no_grad():
            grads = self._decay(grads, params)
            m = self.momentum
            for k, p in params.items():
                g = grads[k]
                if m > 0:
                    v = opt_state["velocity"][k]
                    v.mul_(m).add_((1 - self.dampening) * g)
                    step = g + m * v if self.nesterov else v
                else:
                    step = g
                p.sub_(lr * step)
        return params, opt_state


class Adam(OptimMethod):
    """Adam (reference `Adam`), with bias correction from the step count
    `t` kept in the slot state and any learning-rate schedule (`Default`,
    lr / (1 + neval * learning_rate_decay), unless given another):
        g = grad + weight_decay * p
        m = beta1 * m + (1 - beta1) * g
        v = beta2 * v + (1 - beta2) * g * g
        p = p - lr * (m / (1 - beta1^t)) / (sqrt(v / (1 - beta2^t)) + eps)
    `weight_decay` here is the L2 term added to the gradient; `AdamW`
    decouples it."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.0,
                 learning_rate_schedule: Optional[
                     LearningRateSchedule] = None):
        super().__init__(learning_rate, weight_decay)
        self.learning_rate_decay = learning_rate_decay
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule = learning_rate_schedule or Default()

    def init_state(self, params: Tree):
        return {"m": {k: torch.zeros_like(p) for k, p in params.items()},
                "v": {k: torch.zeros_like(p) for k, p in params.items()},
                "t": 0}

    def current_lr(self) -> float:
        return self.schedule.compute(self)

    def update(self, grads: Tree, opt_state, params: Tree, lr: float):
        b1, b2 = self.beta1, self.beta2
        with torch.no_grad():
            grads = self._decay(grads, params)
            t = opt_state["t"] = opt_state["t"] + 1
            # the bias corrections in f32, as the reference computes them
            # (1 - 0.999 differs by 1.3e-5 relative between f32 and f64)
            one, tf = np.float32(1.0), np.float32(t)
            bc1 = float(one - np.float32(b1) ** tf)
            bc2 = float(one - np.float32(b2) ** tf)
            for k, p in params.items():
                g, m, v = grads[k], opt_state["m"][k], opt_state["v"][k]
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                p.sub_(lr * (m / bc1) / ((v / bc2).sqrt() + self.epsilon))
        return params, opt_state


class AdamW(Adam):
    """Adam with decoupled weight decay: after the Adam step,
    p = p - lr * weight_decay * p_before, the decay taken from the
    parameter as it was before the step (reference `AdamW`)."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 1e-2,
                 learning_rate_schedule: Optional[
                     LearningRateSchedule] = None):
        super().__init__(learning_rate, learning_rate_decay, beta1, beta2,
                         epsilon, weight_decay=0.0,
                         learning_rate_schedule=learning_rate_schedule)
        self.decoupled_weight_decay = weight_decay

    def update(self, grads: Tree, opt_state, params: Tree, lr: float):
        wd = self.decoupled_weight_decay
        with torch.no_grad():
            decay = {k: lr * wd * p for k, p in params.items()} if wd \
                else {}
        super().update(grads, opt_state, params, lr)
        with torch.no_grad():
            for k, d in decay.items():
                params[k].sub_(d)
        return params, opt_state
