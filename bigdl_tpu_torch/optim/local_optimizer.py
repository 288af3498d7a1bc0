"""Single-device training loop (counterpart of
`bigdl_tpu/optim/local_optimizer.py`).

`BaseOptimizer` holds what the local and the distributed loops share: the
fluent setters, the train step and the training loop (end trigger, learning
rate schedule, loss sync every `sync_interval` steps, throughput over sync
windows, epoch bookkeeping, the iteration hook). `LocalOptimizer` trains on
one device.

The step is the reference's `_build_step` on one device, eager: forward in
training mode, `ClassNLLCriterion`-style loss, `torch.autograd.grad` over
the parameters, the optimizer's in-place update. Under
`set_compute_precision("bfloat16")` it is the reference's mixed precision,
written out rather than `torch.autocast`: the f32 parameters stay the
autograd leaves (the masters); the model runs on bf16 copies of them and
on the bf16 cast of the float input, with the casts inside the
differentiated function so the gradients arrive in f32; BN statistics and
running stats stay f32 (the BN layer upcasts); the loss is taken on the
model's output upcast to f32.

Not ported (not on this path; `ROADMAP.md` lists them): validation,
checkpoints and resume, gradient clipping, gradient accumulation,
telemetry and tracing, summaries, NaN/step guards, prefetch, preemption,
graph optimisation, and the donation the JAX step uses (the port updates
in place instead).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.optim.metrics import Metrics, Timer
from bigdl_tpu_torch.optim.optim_method import OptimMethod, SGD
from bigdl_tpu_torch.optim.trigger import Trigger, every_epoch

logger = logging.getLogger("bigdl_tpu_torch.optim")

#: compute precisions `set_compute_precision` takes: f32, or bf16 compute
#: with f32 masters
_PRECISIONS = (None, "float32", "highest", "bfloat16")


def _to_device(x, device: torch.device):
    """A batch's inputs or targets as tensors on `device`: numpy arrays are
    copied there, tensors moved (no copy when already there)."""
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return [_to_device(v, device) for v in x]
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def _cast_floats(x, dtype: torch.dtype):
    """Float tensors (or lists of them) cast to `dtype`; integer tensors
    (labels, indices) left alone."""
    if isinstance(x, (list, tuple)):
        return [_cast_floats(v, dtype) for v in x]
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(dtype)
    return x


class BaseOptimizer:
    """Shared training-loop machinery of the local and distributed loops."""

    def __init__(self, model: torch.nn.Module, dataset, criterion, *,
                 device=None):
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.device = resolve_device(device)
        self.optim_method: OptimMethod = SGD()
        self.end_trigger: Trigger = every_epoch()
        self.metrics = Metrics()
        self.compute_precision: Optional[str] = None
        self.sync_interval: int = 1
        self.iteration_hook: Optional[Callable[[Dict], None]] = None
        #: the newest step's loss as a 0-d tensor on the device, read
        #: without a sync (the loop state's "loss" is the last synced one)
        self.last_loss: Optional[torch.Tensor] = None

    # fluent setters
    def set_optim_method(self, method: OptimMethod):
        self.optim_method = method
        return self

    def set_end_when(self, trigger: Trigger):
        self.end_trigger = trigger
        return self

    def set_compute_precision(self, precision: Optional[str]):
        """"bfloat16": bf16 compute with f32 masters (see the module
        docstring). None, "float32" or "highest": f32 throughout."""
        if precision not in _PRECISIONS:
            raise ValueError(f"compute precision must be one of "
                             f"{_PRECISIONS}, got {precision!r}")
        self.compute_precision = precision
        return self

    def set_sync_interval(self, k: int):
        """Read the loss back to the host every k-th iteration instead of
        every one (default 1). In between, steps are queued on the device
        without waiting; the logged loss and the loop state's "loss" are
        the last synced value, and throughput is reported per sync
        window."""
        self.sync_interval = max(1, int(k))
        return self

    def set_iteration_hook(self, fn: Optional[Callable[[Dict], None]]):
        """Call `fn(loop_state)` after every iteration."""
        self.iteration_hook = fn
        return self

    @property
    def _mixed_bf16(self) -> bool:
        return self.compute_precision == "bfloat16"

    class _SyncWindow:
        """Throughput over the span between two device-drained points,
        counting only the dispatch and device part of each iteration
        (`restart()` comes after the iteration's tail work)."""

        def __init__(self):
            self.records = 0
            self.iters = 0
            self.t0 = time.perf_counter()
            self.step_time_s = float("nan")

        def add(self, n: int):
            self.records += n
            self.iters += 1

        def throughput(self, metrics: Metrics) -> float:
            dt = max(time.perf_counter() - self.t0, 1e-9)
            self.step_time_s = dt / max(self.iters, 1)
            metrics.add("computing time average", self.step_time_s * 1e9)
            return self.records / dt

        def restart(self):
            self.records, self.iters = 0, 0
            self.t0 = time.perf_counter()

    def _build_step(self):
        """step(opt_state, x, y, lr) -> the loss (a 0-d device tensor, not
        synced). Updates the parameters and the optimizer state in place;
        the BN layers update their running stats during the forward."""
        model, criterion = self.model, self.criterion
        optim = self.optim_method
        mixed = self._mixed_bf16
        params = dict(model.named_parameters())
        leaves = list(params.values())

        def step(opt_state, x, y, lr):
            model.train()
            if mixed:
                low = {k: p.to(torch.bfloat16) for k, p in params.items()
                       if p.is_floating_point()}
                out = functional_call(model, low,
                                      (_cast_floats(x, torch.bfloat16),))
                out = _cast_floats(out, torch.float32)
            else:
                out = model(x)
            loss = criterion(out, y)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
            optim.update_with_masters(dict(zip(params, grads)), opt_state,
                                      params, lr)
            return loss.detach()

        return step

    def _log_suffix(self) -> str:
        return ""

    def _optimize_impl(self):
        params = dict(self.model.named_parameters())
        bad = [k for k, p in params.items() if p.device != self.device]
        if bad:
            raise ValueError(f"the model's parameters {bad[:3]} are not on "
                             f"the optimizer's device {self.device}")
        opt_state = self.optim_method.init_state_with_masters(params)
        step = self._build_step()
        loop_state = self.optim_method.state
        epoch_size = self.dataset.size()
        data_iter = self.dataset.data(train=True)

        def fetch_and_place():
            """The next batch, its inputs and targets on the device."""
            with Timer(self.metrics, "data fetch time"):
                batch = next(data_iter, None)
                if batch is None:
                    logger.warning("training data stream exhausted before "
                                   "the end trigger fired; stopping early")
                    return None
                return (batch, _to_device(batch.get_input(), self.device),
                        _to_device(batch.get_target(), self.device))

        sync_every = self.sync_interval
        win = self._SyncWindow()
        loss_val = float("nan")
        loss = None
        pending = fetch_and_place()
        while pending is not None and not self.end_trigger(loop_state):
            batch, x, y = pending
            lr = self.optim_method.current_lr()
            loss = self.last_loss = step(opt_state, x, y, lr)
            pending = fetch_and_place()  # queued while the step runs
            do_sync = (loop_state["neval"] + 1) % sync_every == 0
            if do_sync:
                loss_val = float(loss)  # waits for the step to finish
            n = batch.size()
            loop_state["neval"] += 1
            loop_state["recordsProcessedThisEpoch"] += n
            loop_state["loss"] = loss_val
            win.add(n)
            if do_sync:
                throughput = win.throughput(self.metrics)
                logger.info(
                    f"[Epoch {loop_state['epoch'] + 1} "
                    f"{loop_state['recordsProcessedThisEpoch']}/"
                    f"{epoch_size}][Iteration {loop_state['neval']}] "
                    f"Training cost {loss_val}. Throughput is {throughput} "
                    f"records/second.{self._log_suffix()}")
            if loop_state["recordsProcessedThisEpoch"] >= epoch_size:
                loop_state["epoch"] += 1
                loop_state["recordsProcessedThisEpoch"] = 0
                self.dataset.shuffle()
            if self.iteration_hook is not None:
                self.iteration_hook(loop_state)
            if do_sync:
                win.restart()  # keep the tail work out of the next window
        if sync_every > 1 and loss is not None and \
                loop_state["neval"] % sync_every != 0:
            loop_state["loss"] = float(loss)  # the true final loss
        return self.model


class LocalOptimizer(BaseOptimizer):
    """Train on one device (`device`, default CUDA): the model must already
    be there. `batch_size` is recorded as the reference records it; the
    dataset's batches set the size actually trained on."""

    def __init__(self, model: torch.nn.Module, dataset, criterion,
                 batch_size: int = 32, *, device=None):
        super().__init__(model, dataset, criterion, device=device)
        self.batch_size = batch_size

    def optimize(self) -> torch.nn.Module:
        return self._optimize_impl()
