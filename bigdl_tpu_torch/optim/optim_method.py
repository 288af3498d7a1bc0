"""Optimization methods (counterpart of `bigdl_tpu/optim/optim_method.py`).

Ported: the `OptimMethod` base (with the f32-master wrappers), `SGD`,
`Adam`, `AdamW`, `LAMB`, `Adagrad`, `Adadelta`, `Adamax`, `RMSprop`,
`Ftrl`, `LBFGS` and `CompositeOptimMethod` (per-submodule methods).

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

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.optim.schedules import Default, LearningRateSchedule
from bigdl_tpu_torch.parallel import collectives

Tree = Dict[str, torch.Tensor]


def _bias_correction(beta: float, t):
    """1 - beta^t in f32, as the reference computes it: a float for a step
    count `t`, or a 0-d f32 tensor on t's device when `t` is a 0-d tensor
    (the step count a skipping NaN guard keeps on the device, so that a
    reverted step does not advance it and no step waits for the host)."""
    if isinstance(t, torch.Tensor):
        return 1.0 - torch.pow(
            torch.tensor(beta, dtype=torch.float32, device=t.device),
            t.float())
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(t))


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

    def _bias_corrections(self, opt_state):
        """Advance the step count t; (1 - beta1^t, 1 - beta2^t) in f32, as
        the reference computes them (1 - 0.999 differs by 1.3e-5 relative
        between f32 and f64)."""
        t = opt_state["t"] = opt_state["t"] + 1
        return _bias_correction(self.beta1, t), _bias_correction(self.beta2, t)

    def update(self, grads: Tree, opt_state, params: Tree, lr: float):
        b1, b2 = self.beta1, self.beta2
        with torch.no_grad():
            grads = self._decay(grads, params)
            bc1, bc2 = self._bias_corrections(opt_state)
            for k, p in params.items():
                g, m, v = grads[k], opt_state["m"][k], opt_state["v"][k]
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                p.sub_(lr * (m / bc1) / ((v / bc2).sqrt() + self.epsilon))
        return params, opt_state


#: the reference's `ParallelAdam` runs Adam's update loop over threads; a
#: device update is already data-parallel, so the name is Adam itself
ParallelAdam = Adam


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


class LAMB(Adam):
    """Layer-wise adaptive moments (reference `LAMB`): Adam's moments and
    bias corrections, then for each parameter tensor (the layer-wise
    unit)
        r = (m / bc1) / (sqrt(v / bc2) + eps) + weight_decay * p
        trust = ||p|| / ||r||  (1 where either norm is 0)
        p = p - lr * trust * r
    The decay is decoupled: it enters r, not the gradient. The norms are
    the whole parameter's: under tensor parallelism a shard's are summed
    over its model group (`collectives.whole_norms`)."""

    def __init__(self, learning_rate: float = 1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-6,
                 weight_decay: float = 0.0,
                 learning_rate_schedule: Optional[
                     LearningRateSchedule] = None):
        super().__init__(learning_rate, beta1=beta1, beta2=beta2,
                         epsilon=epsilon, weight_decay=0.0,
                         learning_rate_schedule=learning_rate_schedule)
        self.trust_weight_decay = weight_decay

    def update(self, grads: Tree, opt_state, params: Tree, lr: float):
        b1, b2 = self.beta1, self.beta2
        eps, wd = self.epsilon, self.trust_weight_decay
        with torch.no_grad():
            bc1, bc2 = self._bias_corrections(opt_state)
            rs = {}
            for k, p in params.items():
                g, m, v = grads[k], opt_state["m"][k], opt_state["v"][k]
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                r = (m / bc1) / ((v / bc2).sqrt() + eps)
                rs[k] = r + wd * p if wd else r
            norms = collectives.whole_norms(
                {k: (params[k], r) for k, r in rs.items()})
            for k, r in rs.items():
                p_norm, r_norm = norms[k]
                trust = torch.where((p_norm > 0) & (r_norm > 0),
                                    p_norm / torch.clamp(r_norm, min=1e-12),
                                    torch.ones_like(p_norm))
                params[k].sub_(lr * trust * r)
        return params, opt_state


def _decayed_lr(method) -> float:
    """lr / (1 + neval * learning_rate_decay), the reference's own rule
    for the methods that take no schedule."""
    n = method.state["neval"]
    return method.learning_rate / (1 + n * method.learning_rate_decay)


class Adagrad(OptimMethod):
    """Per-coordinate scaling by the accumulated squared gradient
    (reference `Adagrad`), lr / (1 + neval * learning_rate_decay):
        g = grad + weight_decay * p
        a = a + g * g
        p = p - lr * g / (sqrt(a) + 1e-10)"""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__(learning_rate, weight_decay)
        self.learning_rate_decay = learning_rate_decay

    def init_state(self, params: Tree):
        return {"accum": {k: torch.zeros_like(p) for k, p in params.items()}}

    def current_lr(self) -> float:
        return _decayed_lr(self)

    def update(self, grads: Tree, opt_state, params: Tree, lr: float):
        with torch.no_grad():
            grads = self._decay(grads, params)
            for k, p in params.items():
                g, a = grads[k], opt_state["accum"][k]
                a.add_(g * g)
                p.sub_(lr * g / (a.sqrt() + 1e-10))
        return params, opt_state


class Adadelta(OptimMethod):
    """Accumulated-delta adaptive steps (reference `Adadelta`; its
    learning rate is 1.0), with rho = `decay_rate`:
        g = grad + weight_decay * p
        a = rho * a + (1 - rho) * g * g
        s = g * sqrt(d + eps) / sqrt(a + eps)
        d = rho * d + (1 - rho) * s * s
        p = p - lr * s"""

    def __init__(self, decay_rate: float = 0.9, epsilon: float = 1e-10,
                 weight_decay: float = 0.0):
        super().__init__(1.0, weight_decay)
        self.rho, self.epsilon = decay_rate, epsilon

    def init_state(self, params: Tree):
        return {"accum": {k: torch.zeros_like(p) for k, p in params.items()},
                "delta_accum": {k: torch.zeros_like(p)
                                for k, p in params.items()}}

    def update(self, grads: Tree, opt_state, params: Tree, lr: float):
        rho, eps = self.rho, self.epsilon
        with torch.no_grad():
            grads = self._decay(grads, params)
            for k, p in params.items():
                g = grads[k]
                a, d = opt_state["accum"][k], opt_state["delta_accum"][k]
                a.mul_(rho).add_((1 - rho) * g * g)
                s = g * (d + eps).sqrt() / (a + eps).sqrt()
                d.mul_(rho).add_((1 - rho) * s * s)
                p.sub_(lr * s)
        return params, opt_state


class Adamax(OptimMethod):
    """Adam with an infinity-norm second moment (reference `Adamax`):
        g = grad + weight_decay * p
        m = beta1 * m + (1 - beta1) * g
        u = max(beta2 * u, |g| + epsilon)
        p = p - (lr / (1 - beta1^t)) * m / u
    with the bias correction in f32, as the reference computes it."""

    def __init__(self, learning_rate: float = 0.002, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-38,
                 weight_decay: float = 0.0):
        super().__init__(learning_rate, weight_decay)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, params: Tree):
        return {"m": {k: torch.zeros_like(p) for k, p in params.items()},
                "u": {k: torch.zeros_like(p) for k, p in params.items()},
                "t": 0}

    def update(self, grads: Tree, opt_state, params: Tree, lr: float):
        b1, b2 = self.beta1, self.beta2
        with torch.no_grad():
            grads = self._decay(grads, params)
            t = opt_state["t"] = opt_state["t"] + 1
            # lr / (1 - beta1^t) in f32, as the reference computes it
            bc = _bias_correction(b1, t)
            step = float(np.float32(lr) / np.float32(bc)) \
                if not isinstance(bc, torch.Tensor) \
                else torch.tensor(lr, dtype=torch.float32,
                                  device=bc.device) / bc
            for k, p in params.items():
                g, m, u = grads[k], opt_state["m"][k], opt_state["u"][k]
                m.mul_(b1).add_((1 - b1) * g)
                torch.maximum(b2 * u, g.abs() + self.epsilon, out=u)
                p.sub_(step * m / u)
        return params, opt_state


class RMSprop(OptimMethod):
    """Scaling by an EMA of squared gradients (reference `RMSprop`),
    lr / (1 + neval * learning_rate_decay), rho = `decay_rate`:
        g = grad + weight_decay * p
        a = rho * a + (1 - rho) * g * g
        p = p - lr * g / (sqrt(a) + epsilon)"""

    def __init__(self, learning_rate: float = 1e-2,
                 learning_rate_decay: float = 0.0, decay_rate: float = 0.99,
                 epsilon: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(learning_rate, weight_decay)
        self.learning_rate_decay = learning_rate_decay
        self.rho, self.epsilon = decay_rate, epsilon

    def init_state(self, params: Tree):
        return {"accum": {k: torch.zeros_like(p) for k, p in params.items()}}

    def current_lr(self) -> float:
        return _decayed_lr(self)

    def update(self, grads: Tree, opt_state, params: Tree, lr: float):
        rho = self.rho
        with torch.no_grad():
            grads = self._decay(grads, params)
            for k, p in params.items():
                g, a = grads[k], opt_state["accum"][k]
                a.mul_(rho).add_((1 - rho) * g * g)
                p.sub_(lr * g / (a.sqrt() + self.epsilon))
        return params, opt_state


class Ftrl(OptimMethod):
    """Follow-the-regularized-leader (reference `Ftrl`), per element with
    lp = `learning_rate_power`:
        gs = g + 2 * l2_shrinkage * p      (g itself without shrinkage)
        a' = a + g * g
        sigma = (a'^-lp - a^-lp) / lr
        lin = lin + gs - sigma * p
        p = (clip(lin, -l1, l1) - lin) / (a'^-lp / lr + 2 * l2)
    The accumulator starts at `initial_accumulator_value`."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_power: float = -0.5,
                 initial_accumulator_value: float = 0.1,
                 l1_regularization_strength: float = 0.0,
                 l2_regularization_strength: float = 0.0,
                 l2_shrinkage_regularization_strength: float = 0.0):
        super().__init__(learning_rate)
        self.lr_power = learning_rate_power
        self.init_accum = initial_accumulator_value
        self.l1 = l1_regularization_strength
        self.l2 = l2_regularization_strength
        self.l2_shrinkage = l2_shrinkage_regularization_strength

    def init_state(self, params: Tree):
        return {"accum": {k: torch.full_like(p, self.init_accum)
                          for k, p in params.items()},
                "linear": {k: torch.zeros_like(p)
                           for k, p in params.items()}}

    def update(self, grads: Tree, opt_state, params: Tree, lr: float):
        lp, l1, l2 = self.lr_power, self.l1, self.l2
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                a, lin = opt_state["accum"][k], opt_state["linear"][k]
                gs = g + 2 * self.l2_shrinkage * p if self.l2_shrinkage \
                    else g
                a2 = a + g * g
                sigma = (a2.pow(-lp) - a.pow(-lp)) / lr
                lin.copy_(lin + gs - sigma * p)
                quad = a2.pow(-lp) / lr + 2 * l2
                p.copy_((lin.clamp(-l1, l1) - lin) / quad)
                a.copy_(a2)
        return params, opt_state


class LBFGS(OptimMethod):
    """Limited-memory BFGS (reference `LBFGS`), with the reference's two
    entry points: inside a training step `update` is a plain gradient
    step, p = p - lr * g; `optimize_full_batch(loss_and_grad, params)`
    runs up to `max_iter` L-BFGS iterations (the two-loop recursion over
    the last `n_correction` pairs, a fixed step of `learning_rate`) on a
    full-batch objective. `max_eval` is accepted and ignored, as in the
    reference. The training loops call only `update`, which is elementwise,
    so under tensor parallelism no shard reaches the recursion's dot
    products: `optimize_full_batch` takes whole tensors."""

    def __init__(self, max_iter: int = 20, max_eval: Optional[float] = None,
                 tol_fun: float = 1e-5, tol_x: float = 1e-9,
                 n_correction: int = 100, learning_rate: float = 1.0):
        super().__init__(learning_rate)
        self.max_iter = max_iter
        self.tol_fun, self.tol_x = tol_fun, tol_x
        self.n_correction = n_correction

    def init_state(self, params: Tree):
        return {"history": []}

    def update(self, grads: Tree, opt_state, params: Tree, lr: float):
        with torch.no_grad():
            for k, p in params.items():
                p.sub_(lr * grads[k])
        return params, opt_state

    def optimize_full_batch(self, loss_and_grad, params: Tree) -> Tree:
        """`loss_and_grad(params) -> (loss, grads)` over dicts of tensors
        keyed as `params`; returns the new parameters (new tensors; the
        given ones are not changed)."""
        keys = list(params)
        shapes = [params[k].shape for k in keys]

        def pack(tree):
            return torch.cat([tree[k].detach().reshape(-1) for k in keys])

        def unpack(vec):
            out, off = {}, 0
            for k, s in zip(keys, shapes):
                n = math.prod(s)
                out[k] = vec[off:off + n].reshape(s)
                off += n
            return out

        x = pack(params)
        s_hist: List[torch.Tensor] = []
        y_hist: List[torch.Tensor] = []
        f_prev = None
        for _ in range(self.max_iter):
            loss, grads = loss_and_grad(unpack(x))
            g = pack(grads)
            if f_prev is not None and abs(float(loss) - f_prev) \
                    < self.tol_fun:
                break
            f_prev = float(loss)
            q = g
            alphas = []
            for s, y in reversed(list(zip(s_hist, y_hist))):
                rho = 1.0 / (torch.dot(y, s) + 1e-10)
                a = rho * torch.dot(s, q)
                q = q - a * y
                alphas.append((rho, a))
            if y_hist:
                gamma = torch.dot(s_hist[-1], y_hist[-1]) / (
                    torch.dot(y_hist[-1], y_hist[-1]) + 1e-10)
                q = gamma * q
            for (s, y), (rho, a) in zip(zip(s_hist, y_hist),
                                        reversed(alphas)):
                b = rho * torch.dot(y, q)
                q = q + (a - b) * s
            d = -q
            step = self.learning_rate
            x_new = x + step * d
            _, g_new = loss_and_grad(unpack(x_new))
            s_vec, y_vec = x_new - x, pack(g_new) - g
            if float(torch.dot(s_vec, y_vec)) > 1e-10:
                s_hist.append(s_vec)
                y_hist.append(y_vec)
                if len(s_hist) > self.n_correction:
                    s_hist.pop(0)
                    y_hist.pop(0)
            if float((step * d).abs().max()) < self.tol_x:
                x = x_new
                break
            x = x_new
        return unpack(x)


class CompositeOptimMethod(OptimMethod):
    """Per-submodule optimization methods (reference
    `CompositeOptimMethod`, built by `set_optim_methods`): each top-level
    child of the model named in `methods` (by its `name`) trains under its
    own method, with its own learning rate, schedule and slots. A child
    with parameters must be covered. `current_lr()` returns one rate per
    top-level child (0.0 for an uncovered one), which `update` unpacks.
    Parameters are grouped by their top-level child's key, the first
    component of their name."""

    def __init__(self, model, methods: Dict[str, "OptimMethod"]):
        super().__init__()
        self.methods = dict(methods)
        children = list(model.named_children())
        self._keys = [key for key, _ in children]
        self._method_of: Dict[str, Optional[OptimMethod]] = {}
        unused = set(methods)
        for key, child in children:
            m = methods.get(child.name)
            self._method_of[key] = m
            if m is not None:
                unused.discard(child.name)
        if unused:
            raise ValueError(
                f"set_optim_methods: no top-level submodule named "
                f"{sorted(unused)}; children are "
                f"{[c.name for _, c in children]}")

    @staticmethod
    def _split(tree: Tree) -> Dict[str, Tree]:
        """A dict keyed by parameter name, grouped by top-level key."""
        out: Dict[str, Tree] = {}
        for name, v in tree.items():
            out.setdefault(name.split(".", 1)[0], {})[name] = v
        return out

    def _pairs(self, groups: Dict[str, Tree]):
        for key in groups:
            m = self._method_of.get(key)
            if m is None:
                raise ValueError(
                    f"submodule '{key}' has parameters but no optim "
                    "method; cover every trainable top-level child")
            yield key, m

    def init_state(self, params: Tree):
        groups = self._split(params)
        return {k: m.init_state(groups[k]) for k, m in self._pairs(groups)}

    def _sync_counters(self):
        """The loop's counters copied into every sub-method's state, so
        their schedules see the training progress."""
        for m in self.methods.values():
            for key in ("neval", "epoch", "recordsProcessedThisEpoch",
                        "loss", "score"):
                if key in self.state:
                    m.state[key] = self.state[key]

    def current_lr(self):
        self._sync_counters()
        return tuple(m.current_lr() if m else 0.0
                     for m in (self._method_of.get(k) for k in self._keys))

    @property
    def schedule(self):
        """Validation scores reach the sub-methods' `Plateau`-style
        schedules through this proxy (the loop calls
        `optim_method.schedule.record(score, method)`)."""
        methods = self.methods

        class _Proxy:
            def record(self, score, _method):
                for m in methods.values():
                    sched = getattr(m, "schedule", None)
                    if sched is not None and hasattr(sched, "record"):
                        sched.record(score, m)

        return _Proxy()

    def update(self, grads: Tree, opt_state, params: Tree, lr):
        lrs = dict(zip(self._keys, lr))
        g_groups, p_groups = self._split(grads), self._split(params)
        for k, m in self._pairs(g_groups):
            m.update(g_groups[k], opt_state[k], p_groups[k], lrs[k])
        return params, opt_state
