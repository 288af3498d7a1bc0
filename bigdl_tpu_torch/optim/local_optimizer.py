"""Single-device training loop (counterpart of
`bigdl_tpu/optim/local_optimizer.py`).

`BaseOptimizer` holds what the local and the distributed loops share: the
fluent setters (with the reference's camelCase aliases), the train step
and the training loop (end trigger, learning rate schedule, loss sync
every `sync_interval` steps, throughput over sync windows, epoch
bookkeeping, validation, checkpoints, the iteration hook).
`LocalOptimizer` trains on one device.

The step is the reference's `_build_step` on one device, eager: forward in
training mode, the criterion's loss, `torch.autograd.grad` over the
parameters, gradient clipping, the optimizer's in-place update. Under
`set_compute_precision("bfloat16")` it is the reference's mixed precision,
written out rather than `torch.autocast`: the f32 parameters stay the
autograd leaves (the masters); the model runs on bf16 copies of them and
on the bf16 cast of the float input, with the casts inside the
differentiated function so the gradients arrive in f32; BN statistics and
running stats stay f32 (the BN layer upcasts); the loss is taken on the
model's output upcast to f32.

- `set_gradient_accumulation(steps)` splits each batch into `steps`
  micro-batches, as the reference's scan does: each micro-batch's forward
  sees its own BN batch statistics and updates the running stats, and the
  gradients and losses are averaged before one update. The reference's
  `LocalOptimizer` ignores the setting (only its distributed step reads
  it); here both loops honour it.
- Clipping, as the reference's: constant clipping of each gradient
  element first, then the global L2 norm taken in f32.
- `set_validation`: the model in eval mode over the validation set every
  time the trigger fires, each method's results summed over the batches;
  the first method's score goes into the state's "score".
- `set_checkpoint` / `resume_from_latest_checkpoint`: the reference's
  format v2 (`serialization/checkpoint.py`), parameters, BN state and
  optimizer slots carried to the JAX tree layout through
  `interop.jax_params`; resume restores them, the counters and the data
  cursor. `set_checkpoint(sharded=True)` writes the same trees through
  `torch.distributed.checkpoint` (`serialization/sharded_checkpoint.py`,
  the reference's sharded layout, no data cursor, as the reference's);
  resume finds and loads either kind.
- A multi-input batch (a `MiniBatch` whose inputs or targets are a list
  of arrays) reaches the model and the criterion as the 1-based `Table`
  (`input[1]` is the first array), as the reference gives it; float
  tensors in it are cast under mixed precision and integer ones left
  alone, and string and bytes columns stay numpy arrays on the host, for
  the feature-column ops (`ops/feature_col.py`).
- The `train.step` fault site fires before every step.
- The step generator (`generator`): a `torch.Generator` on the training
  device, seeded 0 as the reference's key chain starts at `PRNGKey(0)`,
  lent to every `Dropout` for each step (`nn.lend_generator`); the
  step's masks advance it. Its state is committed in memory with each
  checkpoint saved, and a run that reloads that checkpoint on this
  optimizer (the retry path) restores it, so a retried step draws the
  masks of the unfaulted run. Checkpoints do not hold it, as the
  reference's do not hold its key: a fresh process that resumes starts
  the stream from the seed. A failed run puts it back as the run found
  it, as the reference keeps its key when a run fails.

- `set_optim_methods({child name: method})`: per-submodule methods, a
  `CompositeOptimMethod` over the model's top-level children.
- After each validation the first method's score feeds the method's
  schedule when it takes one (`Plateau.record`), as the reference's loop
  does.

Observability (`observability/`), as the reference's loop:
- `set_tracer(SpanTracer)`: the loop's phases ("data fetch", "step
  dispatch", "loss sync", "validation", "checkpoint") are spans under one
  root trace a run (`optimize/local`, `optimize/distri`); `export_trace`
  writes it.
- `set_telemetry(Telemetry)`: `run_start` (`backend` the device type,
  `n_devices` the ranks), one `step` record a sync point, `run_end` with
  `metrics.as_dict()`, and a `run_abort` event on every failure. With
  telemetry the step runs behind a `CompiledFunction`
  (`observability/compilation.py`, label `<loop>.step/<model>`): one
  `compile` record a batch signature, whose `flops` (`step_flops`, a
  count on a meta copy of the step, times the ranks) each step record
  carries as `flops_per_step`, with `mfu`; `bytes_accessed` is null,
  since nothing here models the bytes a step moves.
  `Telemetry(grad_norms=True)` adds the global gradient and parameter L2
  norms. Under `set_prefetch` a step record also carries the pipeline's
  `prefetch_queue_depth`, `prefetch_fetch_wait_s` and
  `prefetch_worker_busy`.
- `set_train_summary(TrainSummary)` / `set_validation_summary(...)`
  (`visualization/`): Loss, LearningRate and Throughput at each sync
  point, the `Parameters` histograms when the summary's trigger fires,
  and each validation method's score.
- `set_health_monitors(...)` (`NanGuard`, `StragglerDetector`,
  `ThroughputMonitor`) observe each step record. With a `NanGuard` the
  step flags itself non-finite on the device (`~isfinite(loss) |
  ~isfinite(grad norm)`); under `NanGuard("skip")` it reverts its own
  update there, `torch.where(bad, old, new)` over the parameters, every
  optimizer slot (a step count is then kept on the device) and the
  buffers (the BN running statistics, taken before the forward that
  moves them). The step generator is not put back, as the reference's
  key chain is not. The flags and norms, like the loss, come back to the
  host once a sync point, in one device-to-host copy with the loss. With
  no guard and no norms asked for, the step does nothing of this.

Preemption (`set_preemption_handler`, `resilience/preemption.py`): while
`optimize()` runs, SIGTERM opens a grace window; at the next iteration
boundary (after the iteration hook) the loop drains the step in flight,
writes a checkpoint (format v2, with the data cursor) when a path is set,
emits `preempted` (`checkpointed`, `grace_remaining_s`) and a `run_abort`,
and `optimize()` returns without raising and without `run_end`. The
handler is installed at the start of `optimize()` (its latch cleared) and
the previous disposition is restored on every exit.

`set_prefetch(depth, workers, deterministic, retry_policy)`
(`dataset/prefetch.py`): the transformer chain runs in background
threads, started with each `optimize()` and joined on every exit; the
order is serial iteration's, the epoch shuffle takes the pipeline's
source lock, and on a card the batches come pinned and are copied with
`non_blocking=True`. A checkpoint under prefetch holds no data cursor
(the stream runs ahead of the trained position), as the reference's.

Not ported (`ROADMAP.md` lists them): graph optimisation, and the
donation the JAX step uses (the port updates in place instead, and keeps a host
snapshot of the model at the start of each run so that a failed run can
put it back).
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import logging
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.nn.dropout import lend_generator
from bigdl_tpu_torch.observability import costs
from bigdl_tpu_torch.optim.metrics import Metrics, Timer
from bigdl_tpu_torch.optim.optim_method import OptimMethod, SGD
from bigdl_tpu_torch.optim.trigger import Trigger, every_epoch
from bigdl_tpu_torch.optim.validation import ValidationMethod
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.utils.table import Table

logger = logging.getLogger("bigdl_tpu_torch.optim")

#: compute precisions `set_compute_precision` takes: f32, or bf16 compute
#: with f32 masters
_PRECISIONS = (None, "float32", "highest", "bfloat16")


def _host_column(x) -> bool:
    """A string, bytes or object column: it stays a numpy array on the
    host, for the feature-column ops to consume (as the reference's)."""
    return isinstance(x, np.ndarray) and x.dtype.kind in "USO"


def _each(fn, x) -> Table:
    """`fn` of every item of a list, tuple or `Table`, as a `Table`."""
    return Table(*[fn(v) for v in x])


def _to_device(x, device: torch.device, non_blocking: bool = False):
    """A batch's inputs or targets on `device`: numpy arrays are copied
    there, tensors moved (no copy when already there), string and bytes
    columns left on the host. A list or tuple of them (a multi-input
    batch) becomes the 1-based `Table` the model reads as `input[1]`,
    `input[2]`, ..., as the reference's `_to_device` gives it.
    `non_blocking` copies a pinned host tensor without waiting for it."""
    if x is None:
        return None
    if isinstance(x, (list, tuple, Table)):
        return _each(lambda v: _to_device(v, device, non_blocking), x)
    if _host_column(x):
        return x
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device, non_blocking=non_blocking)


def _cast_floats(x, dtype: torch.dtype):
    """Float tensors (alone, or in a `Table`, list or tuple, which keeps
    its kind) cast to `dtype`; integer tensors (labels, indices) and host
    columns left alone."""
    if isinstance(x, Table):
        return _each(lambda v: _cast_floats(v, dtype), x)
    if isinstance(x, (list, tuple)):
        return type(x)(_cast_floats(v, dtype) for v in x)
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(dtype)
    return x


def _tensor_slots(node, out: List) -> List:
    """(dict, key) of every tensor in a tree of dicts, in order."""
    for k, v in node.items():
        if isinstance(v, dict):
            _tensor_slots(v, out)
        elif isinstance(v, torch.Tensor):
            out.append((node, k))
    return out


def _flat_views(ts: List[torch.Tensor]):
    """A [2, n] buffer for the tensors `ts` (one device and dtype, n their
    elements) and two lists of views, one into each row, each view with
    its tensor's shape and (for a dense tensor) strides, so that copies
    between them take the multi-tensor fast path."""
    sizes = [t.numel() for t in ts]
    flat = ts[0].new_empty((2, sum(sizes)))
    rows = ([], [])
    off = 0
    for t, n in zip(ts, sizes):
        dense = t.is_contiguous() or (
            t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last))
        for row, views in zip(flat, rows):
            chunk = row[off:off + n]
            views.append(chunk.as_strided(t.shape, t.stride(),
                                          chunk.storage_offset())
                         if dense else chunk.view(t.shape))
        off += n
    return flat, rows[0], rows[1]


def _counts_on(node, device: torch.device):
    """The state tree with each int (a step count) a 0-d int64 tensor on
    `device`, which a reverted step can leave where it was without the
    host knowing."""
    if isinstance(node, dict):
        return {k: _counts_on(v, device) for k, v in node.items()}
    if isinstance(node, int) and not isinstance(node, bool):
        return torch.tensor(node, dtype=torch.int64, device=device)
    return node


def _meta(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of `model` on the meta device: shapes without data."""
    return copy.deepcopy(model).to("meta")


def meta_step_call(opt: "BaseOptimizer", x, y):
    """(step, arguments): the step `opt` runs (`_build_step`, with its
    precision, accumulation, clipping and guards) on a copy of the model
    and the method on the meta device, and its arguments for the batch
    inputs `x` and targets `y` (host arrays or tensors, moved to the meta
    device). Calling it launches nothing (the kernel wrappers only count
    there), so the run itself is untouched, as the reference lowers its
    step a second time without running it."""
    twin = opt._meta_twin()
    params = dict(twin.model.named_parameters())
    opt_state = twin.optim_method.init_state_with_masters(params)
    meta = torch.device("meta")
    return twin._build_step(), (opt_state, _to_device(x, meta),
                                _to_device(y, meta),
                                twin.optim_method.current_lr())


def step_flops(opt: "BaseOptimizer", batch=None) -> int:
    """FLOPs of one training step of `opt` on `batch` (default: its
    dataset's first batch): `costs.count_flops` of `meta_step_call`, the
    count the loop's `compile` records and step records carry (times the
    ranks of a data-parallel step)."""
    if batch is None:
        batch = next(iter(opt.dataset.data(train=False)))
    fn, args = meta_step_call(opt, batch.get_input(), batch.get_target())
    return costs.count_flops(fn, *args)


def _flat_tree(tree, prefix: str = ""):
    """(path, leaf) pairs of a nest of dicts and lists, the path's keys
    joined by "/", dict keys in sorted order (the reference's flatten)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_tree(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat_tree(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def _micro_batches(x, steps: int):
    """x (a tensor, a host column, a `Table` of them, or None) split along
    its first axis into `steps` equal micro-batches, in order."""
    if x is None:
        return [None] * steps
    if isinstance(x, (list, tuple, Table)):
        parts = _each(lambda v: _micro_batches(v, steps), x)
        return [_each(lambda v: v[i], parts) for i in range(steps)]
    if x.shape[0] % steps:
        raise ValueError(f"gradient accumulation over {steps} micro-batches "
                         f"needs a batch size divisible by {steps}, got "
                         f"{x.shape[0]}")
    return list(x.reshape(steps, x.shape[0] // steps, *x.shape[1:]))


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
        self.checkpoint_trigger: Optional[Trigger] = None
        self.checkpoint_path: Optional[str] = None
        self.checkpoint_sharded = False
        self.checkpoint_keep_last_n: Optional[int] = None
        self.overwrite_checkpoint = True
        self.validation_trigger: Optional[Trigger] = None
        self.validation_dataset = None
        self.validation_methods: List[ValidationMethod] = []
        self.validation_batch_size = 32
        self.grad_clip_norm: Optional[float] = None
        self.grad_clip_const: Optional[tuple] = None
        self.grad_accum_steps: int = 1
        self.metrics = Metrics()
        self.compute_precision: Optional[str] = None
        self.sync_interval: int = 1
        self.iteration_hook: Optional[Callable[[Dict], None]] = None
        #: the newest step's loss as a 0-d tensor on the device, read
        #: without a sync (the loop state's "loss" is the last synced one)
        self.last_loss: Optional[torch.Tensor] = None
        #: the optimizer state (slots, f32 masters) of the run in progress
        #: (for the iteration hook; None after a run)
        self.opt_state = None
        # resume: what resume_from_latest_checkpoint loaded for the next
        # optimize()
        self._resume_slots = None
        self._resume_cursor = None
        self._resumed = False
        # stream positions behind the data cursor of a checkpoint
        self._cursor_prev_pos = self._cursor_last_pos = None
        # host copy of the model's tensors at the start of a run
        self._pristine: Optional[Dict[str, torch.Tensor]] = None
        #: the step generator: lent to the Dropout layers for each step
        self.generator = torch.Generator(self.device).manual_seed(0)
        # its state at the start of a run, and after each checkpoint's
        # step (keyed by that step's neval), for the retry path
        self._generator_at_start: Optional[torch.Tensor] = None
        self._generator_commits: Dict[int, torch.Tensor] = {}
        # observability: the collector, the span tracer, the monitors
        self.telemetry = None
        self.tracer = None
        self.health_monitors: List = []
        #: the step's aux fields (`_build_step`): "nonfinite",
        #: "grad_norm", "param_norm", as armed
        self._aux_fields: List[str] = []
        #: the run's step as dispatched (a `CompiledFunction` with
        #: telemetry attached; its `last_info` carries the step's FLOPs)
        self._step_fn = None
        # TensorBoard summaries (`visualization/`)
        self.train_summary = None
        self.validation_summary = None
        # set_prefetch's settings (None: off) and the run's pipeline
        self._prefetch: Optional[Dict] = None
        self._active_pipeline = None
        # the armed `PreemptionHandler` (None: none)
        self._preemption = None
        #: worker id -> the `SpanTracer` of its lane (the elastic loop's
        #: shard dispatches)
        self.worker_tracers: Dict = {}
        # False while a replay feeds kept batches: the stream is then
        # ahead of the trained position, and a checkpoint takes no cursor
        self._cursor_valid = True

    # fluent setters
    def set_gradient_accumulation(self, steps: int):
        """Split each batch into `steps` micro-batches and average their
        gradients before one update (the batch size must divide
        evenly)."""
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        self.grad_accum_steps = int(steps)
        return self

    def set_optim_method(self, method: OptimMethod):
        self.optim_method = method
        return self

    setOptimMethod = set_optim_method

    def set_optim_methods(self, methods: Dict[str, OptimMethod]):
        """Per-submodule optimization methods keyed by top-level child
        name (the reference's `setOptimMethods`)."""
        from bigdl_tpu_torch.optim.optim_method import CompositeOptimMethod
        self.optim_method = CompositeOptimMethod(self.model, methods)
        return self

    setOptimMethods = set_optim_methods

    def set_end_when(self, trigger: Trigger):
        self.end_trigger = trigger
        return self

    setEndWhen = set_end_when

    def set_checkpoint(self, path: str, trigger: Trigger,
                       sharded: bool = False,
                       keep_last_n: Optional[int] = None):
        """Checkpoint to `path` (local or `memory://`) every time `trigger`
        fires, tagged `iter<neval>`; `keep_last_n` prunes the oldest valid
        checkpoints after each save (on rank 0). `sharded=True` writes the
        arrays through `torch.distributed.checkpoint`, every rank its own
        shards (`serialization/sharded_checkpoint.py`; a local path)."""
        if keep_last_n is not None and keep_last_n < 1:
            raise ValueError(
                f"keep_last_n must be >= 1, got {keep_last_n}")
        if sharded:
            from bigdl_tpu_torch.serialization.sharded_checkpoint import \
                _local_path
            _local_path(path)  # refuse a URI now, not at the first save
        self.checkpoint_path = path
        self.checkpoint_sharded = bool(sharded)
        self.checkpoint_trigger = trigger
        self.checkpoint_keep_last_n = keep_last_n
        return self

    setCheckpoint = set_checkpoint

    def set_validation(self, trigger: Trigger, dataset,
                       methods: Sequence[ValidationMethod],
                       batch_size: Optional[int] = None):
        """Validate on `dataset` (Samples, batched by `batch_size`, default
        32, or MiniBatches) with `methods` every time `trigger` fires."""
        self.validation_trigger = trigger
        self.validation_dataset = dataset
        self.validation_methods = list(methods)
        self.validation_batch_size = batch_size or 32
        return self

    setValidation = set_validation

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float):
        """Scale the gradients by min(1, clip_norm / global L2 norm)."""
        self.grad_clip_norm = clip_norm
        return self

    setGradientClippingByl2Norm = set_gradient_clipping_by_l2_norm

    def set_constant_gradient_clipping(self, min_v: float, max_v: float):
        """Clamp every gradient element into [min_v, max_v]."""
        self.grad_clip_const = (min_v, max_v)
        return self

    setConstantGradientClipping = set_constant_gradient_clipping

    def disable_gradient_clipping(self):
        self.grad_clip_norm = None
        self.grad_clip_const = None
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

    def set_train_summary(self, summary):
        """Write training scalars to `summary` (a
        `visualization.TrainSummary`) at every sync point: Loss,
        LearningRate and Throughput; and, when its "Parameters" trigger
        fires, a histogram of every parameter (the reference's tree paths
        as tags, the JAX layout)."""
        self.train_summary = summary
        return self

    setTrainSummary = set_train_summary

    def set_validation_summary(self, summary):
        """Write each validation method's score to `summary` (a
        `visualization.ValidationSummary`) under the method's repr."""
        self.validation_summary = summary
        return self

    setValidationSummary = set_validation_summary

    def set_prefetch(self, depth: Optional[int] = None,
                     workers: Optional[int] = None,
                     deterministic: bool = True,
                     retry_policy=None):
        """Run the dataset's transformer chain in background threads
        (`dataset/prefetch.py`): `workers` threads (default
        `Engine.config["io_threads"]`) apply its element-wise prefix,
        one more batches, and the loop only pops a queue. `depth` (the
        total lookahead, ready and in flight) defaults to 4x workers.
        `deterministic=True` keeps the batch order serial iteration
        gives; `retry_policy` (a `resilience.RetryPolicy`) retries a
        transient per-item failure in its worker without moving the
        item. On a card the batches come pinned and are copied with
        `non_blocking=True`. Across an epoch boundary the `shuffle()`
        lands between pulls as the threads' timing has it, so a
        multi-epoch stream (and its resume) is exact only without
        prefetch. `depth=0` disables. The threads start with each
        `optimize()` and are joined before it returns, failed or not."""
        if depth == 0:
            self._prefetch = None
            return self
        if workers is None:
            from bigdl_tpu_torch.utils.engine import Engine
            workers = int(Engine.config["io_threads"])
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if depth is None:
            depth = 4 * workers
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._prefetch = {"depth": int(depth), "workers": int(workers),
                          "deterministic": bool(deterministic),
                          "retry_policy": retry_policy}
        return self

    setPrefetch = set_prefetch

    def _open_data_pipeline(self):
        """The run's training stream: the prefetching `InputPipeline`
        when `set_prefetch` is armed (kept for the step records' gauges
        and the close), else the dataset's own iterator."""
        if self._prefetch is None:
            self._active_pipeline = None
            return self.dataset.data(train=True)
        from bigdl_tpu_torch.dataset.prefetch import build_input_pipeline
        self._active_pipeline = build_input_pipeline(
            self.dataset, train=True, **self._prefetch,
            pin_memory=self.device.type == "cuda")
        return self._active_pipeline

    def _close_data_pipeline(self):
        """Join the run's pipeline threads (a no-op without one)."""
        pipeline, self._active_pipeline = self._active_pipeline, None
        if pipeline is not None:
            pipeline.close()

    def _shuffle_dataset(self):
        """The epoch boundary's reshuffle; under prefetch it takes the
        pipeline's source lock, so no worker is mid-pull meanwhile."""
        if self._active_pipeline is not None:
            with self._active_pipeline.source_guard():
                self.dataset.shuffle()
        else:
            self.dataset.shuffle()

    def set_preemption_handler(self, handler=None, grace_s: float = 30.0):
        """Arm preemption handling (see the module docstring): a
        configured `PreemptionHandler`, or by default one for SIGTERM with
        a grace window of `grace_s`. `handler=False` disarms."""
        if handler is False:
            self._preemption = None
            return self
        if handler is None:
            from bigdl_tpu_torch.resilience.preemption import \
                PreemptionHandler
            handler = PreemptionHandler(grace_s=grace_s)
        self._preemption = handler
        return self

    setPreemptionHandler = set_preemption_handler

    def _arm_preemption(self):
        """At the start of `optimize()`: clear a latch a previous
        preempted run left set (a second run must train) and install."""
        if self._preemption is not None:
            self._preemption.reset()
            self._preemption.install()

    def _disarm_preemption(self):
        """On every exit of `optimize()`: the previous disposition back."""
        if self._preemption is not None:
            self._preemption.uninstall()

    def _agree_preempted(self, triggered: bool) -> bool:
        """Whether to stop for preemption (one process: its own latch)."""
        return triggered

    def _check_preemption(self, opt_state, loop_state, loss) -> bool:
        """The iteration boundary's poll of the preemption latch. When it
        is set: drain the step in flight, write the checkpoint, emit
        `preempted` and `run_abort`, and return True (the loop stops)."""
        h = self._preemption
        if h is None or not self._agree_preempted(h.triggered):
            return False
        step = loop_state.get("neval", 0)
        logger.warning(
            "preemption (signal %s): draining and checkpointing at "
            "iteration %d (%.1fs of grace remaining)", h.signum, step,
            h.deadline_remaining() or 0.0)
        if loss is not None:
            try:  # the loss read waits for the step
                float(loss)
            except Exception:
                pass
        checkpointed = False
        if self.checkpoint_path is not None:
            try:
                self._save_checkpoint(opt_state, tag=f"iter{step}")
                checkpointed = True
            except Exception:
                logger.exception("preemption checkpoint failed; stopping "
                                 "without one")
        tel = self._lead_telemetry
        if tel is not None:
            tel.event("preempted", step=step, signal=h.signum,
                      checkpointed=checkpointed,
                      grace_remaining_s=round(
                          h.deadline_remaining() or 0.0, 3))
        from bigdl_tpu_torch.resilience.preemption import PreemptedError
        self._telemetry_run_abort(PreemptedError(
            f"preempted by signal {h.signum}" if h.signum is not None
            else "preempted: a peer rank received the signal"))
        return True

    def set_telemetry(self, telemetry):
        """Attach a `Telemetry`: `run_start` / `run_end`, a `step` record
        a sync point with its cost attribution, and the monitors' and the
        retry path's events (see the module docstring)."""
        self.telemetry = telemetry
        self._link_flight()
        return self

    setTelemetry = set_telemetry

    def set_tracer(self, tracer):
        """Attach a `SpanTracer`: the loop's phases as nested spans under
        one root trace a run."""
        self.tracer = tracer
        self._link_flight()
        return self

    setTracer = set_tracer

    def _link_flight(self):
        """Give the telemetry's flight recorder (when both are attached)
        the tracer, so that its dumps carry the span tail."""
        flight = getattr(self.telemetry, "flight", None)
        if flight is not None and self.tracer is not None:
            flight.attach_tracer(self.tracer)

    def set_health_monitors(self, *monitors):
        """Attach health monitors (`observability.health`), each shown
        every sync point's step record. A `NanGuard` also makes the step
        flag non-finite steps, and with action "skip" revert them; set it
        before `optimize()`."""
        self.health_monitors = list(monitors)
        return self

    setHealthMonitors = set_health_monitors

    def export_trace(self, path: str) -> str:
        """Write one Chrome trace to `path`: the tracer's lane and every
        worker's (`worker_tracers`), each a process of its own (needs
        `set_tracer`)."""
        if self.tracer is None:
            raise ValueError("no tracer attached; call set_tracer first")
        from bigdl_tpu_torch.observability.spans import export_merged
        return export_merged(path,
                             [self.tracer, *self.worker_tracers.values()])

    @property
    def _mixed_bf16(self) -> bool:
        return self.compute_precision == "bfloat16"

    # -- checkpoints and resume --------------------------------------------

    def resume_from_latest_checkpoint(self) -> bool:
        """Load the newest valid checkpoint under the checkpoint path
        (digests verified; a corrupt one is quarantined and the next older
        one taken) into the model and the optimization method before
        `optimize()`: parameters, BN running stats, optimizer slots,
        counters and the data cursor. False when there is nothing to
        resume from."""
        from bigdl_tpu_torch.interop.jax_params import load_params
        from bigdl_tpu_torch.serialization.checkpoint import (
            load_latest_valid, restore_optim_method)
        if self.checkpoint_path is None:
            return False
        got = load_latest_valid(self.checkpoint_path,
                                telemetry=self._lead_telemetry)
        if got is None:
            return False
        _, params, mstate, oblob = got
        load_params(self.model, params, mstate)
        restore_optim_method(self.optim_method, oblob)
        committed = self._generator_commits.get(
            self.optim_method.state.get("neval"))
        if committed is not None:
            self.generator.set_state(committed)
        if oblob.get("slots") is not None:
            self._resume_slots = self._slots_from_tree(oblob["slots"])
        self._resume_cursor = oblob.get("cursor")
        self._resumed = True
        return True

    def _slots_tree(self, opt_state, leaf=None):
        """The optimizer state in the reference's layout: every dict keyed
        by the parameter names (all of them, or those of one top-level
        child under a per-submodule method) becomes the JAX-layout tree
        (or the child's subtree), a step count an int32 array. The leaves
        are f32 numpy arrays, or `leaf(name, tensor, conv)` with `leaf`
        (`interop.jax_params.export_named`)."""
        from bigdl_tpu_torch.interop.jax_params import (export_named,
                                                        tree_from_named)
        names = {n for n, _ in self.model.named_parameters()}

        def conv(node):
            if isinstance(node, dict):
                if node and set(node) <= names:
                    return tree_from_named(self.model, node) if leaf is None \
                        else export_named(self.model, node, leaf)
                return {k: conv(v) for k, v in node.items()}
            if isinstance(node, int) and not isinstance(node, bool):
                return np.asarray(node, dtype=np.int32)
            if isinstance(node, torch.Tensor) and node.ndim == 0 \
                    and not node.is_floating_point():
                return np.asarray(int(node), dtype=np.int32)  # a step count
            return node

        return conv(opt_state)

    def _slots_from_tree(self, slots):
        """The inverse of `_slots_tree`: tensors on the parameters'
        devices keyed by parameter name, step counts as ints."""
        from bigdl_tpu_torch.interop.jax_params import (named_from_tree,
                                                        tree_keys)
        keys = tree_keys(self.model)

        def conv(node, child=None):
            """`child`: the top-level child whose slots `node` is under
            (a per-submodule method's state is keyed by child)."""
            if isinstance(node, dict):
                if node and set(node) == keys:
                    return named_from_tree(self.model, node)
                if child is not None and node \
                        and set(node) == tree_keys(self.model, child):
                    return named_from_tree(self.model, node, child)
                return {k: conv(v, k if k in keys else child)
                        for k, v in node.items()}
            if isinstance(node, np.ndarray) and node.ndim == 0 \
                    and np.issubdtype(node.dtype, np.integer):
                return int(node)
            return node

        return conv(slots)

    def _save_checkpoint(self, opt_state, tag: str):
        if self.checkpoint_sharded:
            self._save_sharded(opt_state, tag)
        else:
            self._save_v2(opt_state, tag)
        self._commit_generator()

    def _save_v2(self, opt_state, tag: str, full=None):
        """The format v2 checkpoint; `full`, when given, is (the whole
        parameters by name, the optimizer state with whole tensors), which
        a tensor-parallel run gathers first."""
        from bigdl_tpu_torch.interop.jax_params import (module_state,
                                                        params_tree,
                                                        tree_from_named)
        from bigdl_tpu_torch.serialization.checkpoint import save_checkpoint
        params = params_tree(self.model) if full is None else \
            tree_from_named(self.model, full[0])
        if full is not None:
            opt_state = full[1]
        save_checkpoint(self.checkpoint_path, self.model, params,
                        module_state(self.model), self.optim_method,
                        opt_slots=self._slots_tree(opt_state), tag=tag,
                        overwrite=self.overwrite_checkpoint,
                        keep_last_n=self.checkpoint_keep_last_n,
                        cursor=self._data_cursor())

    def _sharded_leaf(self, name: str, t: torch.Tensor, conv: bool):
        """A parameter's (or slot's) tensor in the reference's layout as
        the sharded checkpoint takes it."""
        return t.detach().contiguous()

    def _save_sharded(self, opt_state, tag: str):
        """The sharded checkpoint (every rank calls it), then rank 0 prunes
        to `keep_last_n`."""
        from bigdl_tpu_torch.interop.jax_params import (export_named,
                                                        module_state)
        from bigdl_tpu_torch.parallel import collectives
        from bigdl_tpu_torch.serialization.checkpoint import (
            prune_checkpoints)
        from bigdl_tpu_torch.serialization.sharded_checkpoint import (
            save_checkpoint_sharded)
        leaf = self._sharded_leaf
        save_checkpoint_sharded(
            self.checkpoint_path, self.model,
            export_named(self.model, dict(self.model.named_parameters()),
                         leaf),
            module_state(self.model), self.optim_method,
            opt_slots=self._slots_tree(opt_state, leaf), tag=tag)
        keep = self.checkpoint_keep_last_n
        if keep is not None and collectives.rank() == 0:
            prune_checkpoints(self.checkpoint_path, keep)

    def _commit_generator(self):
        """Keep the step generator's state for this step's neval, which a
        retry that reloads this step's checkpoint restores."""
        self._generator_commits[self.optim_method.state["neval"]] = \
            self.generator.get_state()

    def _data_cursor(self):
        """The dataset's cursor at the last trained batch (one pull behind
        the loop's lookahead), or None when the dataset has none, the
        stream runs ahead of it (a replay, a prefetch pipeline) or the
        capture fails: a checkpoint never fails over its cursor."""
        cur = getattr(self.dataset, "cursor", None)
        if cur is None or not self._cursor_valid \
                or self._active_pipeline is not None:
            return None
        try:
            return cur(position=self._cursor_prev_pos)
        except Exception as e:
            logger.warning("data cursor capture failed (%r); checkpoint "
                           "saved without one", e)
            return None

    def _init_cursor_positions(self):
        """Anchor the position trackers before a run's first pull."""
        self._cursor_valid = True
        pos = getattr(self.dataset, "position", None)
        p = pos() if pos is not None else None
        self._cursor_prev_pos = self._cursor_last_pos = p

    def _note_pull(self):
        """After a pull: the previous position points at the last trained
        batch, the one a checkpoint's cursor must name. A real pull also
        ends a replay: everything kept has been trained again by then."""
        self._cursor_valid = True
        pos = getattr(self.dataset, "position", None)
        if pos is None:
            return
        self._cursor_prev_pos = self._cursor_last_pos
        self._cursor_last_pos = pos()

    def _fast_forward_data(self, data_iter, loop_state):
        """Put a resumed run's data stream where the checkpoint left it.
        With a cursor, the dataset rewinds itself to the next untrained
        item. Without one (or when the dataset cannot take it, as a
        reference checkpoint's numpy cursor), the reference's fallback:
        completed epochs replay as whole passes, each followed by the
        boundary shuffle the original run made after its one-batch
        lookahead, then the records of the current epoch are skipped."""
        cold_resume, self._resumed = self._resumed, False
        cursor, self._resume_cursor = self._resume_cursor, None
        if cold_resume and cursor is not None \
                and self._active_pipeline is None \
                and hasattr(self.dataset, "restore_cursor"):
            try:
                self.dataset.restore_cursor(cursor)
            except Exception as e:
                logger.warning("data cursor restore failed (%r); falling "
                               "back to full-pass replay", e)
            else:
                return data_iter
        epochs_done = max(0, loop_state.get("epoch", 0)) if cold_resume \
            else 0
        pass_items = self.dataset.size()
        pending = None  # the boundary lookahead batch, not yet credited
        for _ in range(epochs_done):
            seen = pending.size() if pending is not None else 0
            while seen < pass_items:
                b = next(data_iter, None)
                if b is None:
                    return data_iter
                seen += b.size()
            pending = next(data_iter, None)
            self._shuffle_dataset()
        already = loop_state.get("recordsProcessedThisEpoch", 0)
        skipped = pending.size() if pending is not None else 0
        if pending is not None and skipped > already:
            return itertools.chain([pending], data_iter)
        while skipped < already:
            b = next(data_iter, None)
            if b is None:
                break
            skipped += b.size()
        return data_iter

    # -- validation ---------------------------------------------------------

    def _validation_batches(self):
        """MiniBatches of the validation set, whether it holds Samples or
        batches."""
        from bigdl_tpu_torch.dataset.sample import Sample
        from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
        data = self.validation_dataset
        it = iter(data.data(train=False) if hasattr(data, "data") else data)
        first = next(it, None)
        if first is None:
            return
        chained = itertools.chain([first], it)
        if isinstance(first, Sample):
            yield from SampleToMiniBatch(self.validation_batch_size)(chained)
        else:
            yield from chained

    def _validate(self, loop_state):
        """Run the validation methods when the trigger fires: the model in
        eval mode, results summed over the batches and logged, the first
        one's score into `loop_state["score"]` and to the method's
        schedule's `record` where it has one."""
        if not (self.validation_trigger and self.validation_dataset
                and self.validation_trigger(loop_state)):
            return None
        results = [None] * len(self.validation_methods)
        self.model.eval()
        gather = self._gather_params
        try:
            with torch.no_grad():
                full = None if gather is None else \
                    gather(dict(self.model.named_parameters()), "unshard")
                for batch in self._validation_batches():
                    x = _to_device(batch.get_input(), self.device)
                    y = _to_device(batch.get_target(), self.device)
                    out = self.model(x) if full is None else \
                        functional_call(self.model, full, (x,))
                    for i, m in enumerate(self.validation_methods):
                        r = m.apply(out, y)
                        results[i] = r if results[i] is None \
                            else results[i] + r
        finally:
            self.model.train()
        for m, r in zip(self.validation_methods, results):
            logger.info(f"{m!r} is {r!r}")
            if self.validation_summary is not None and r is not None \
                    and self._writes_summaries:
                self.validation_summary.add_scalar(
                    repr(m), r.result()[0], loop_state["neval"])
        if results and results[0] is not None:
            loop_state["score"] = results[0].result()[0]
            # feed Plateau-style schedules
            sched = getattr(self.optim_method, "schedule", None)
            if sched is not None and hasattr(sched, "record"):
                sched.record(loop_state["score"], self.optim_method)
        return results

    # -- the step and the loop ---------------------------------------------

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

    def _clip_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Constant clipping first, then the global L2 norm (f32)."""
        if self.grad_clip_const is not None:
            lo, hi = self.grad_clip_const
            grads = [g.clamp(lo, hi) for g in grads]
        if self.grad_clip_norm is not None:
            total = torch.sqrt(self._grad_sq_norm(grads))
            scale = torch.clamp(self.grad_clip_norm / (total + 1e-12),
                                max=1.0)
            grads = [g * scale for g in grads]
        return grads

    def _grad_sq_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The squared global L2 norm of the gradients (f32)."""
        return sum(torch.sum(g.float() ** 2) for g in grads)

    @property
    def _gather_params(self):
        """None, or (under tensor parallelism) a function that turns the
        parameters (or their casts), keyed by name, into the whole tensors
        a forward takes."""
        return None

    # -- observability ------------------------------------------------------

    @property
    def _lead_telemetry(self):
        """The telemetry this process writes to: the attached one (the
        distributed loop: on rank 0 only)."""
        return self.telemetry

    @property
    def _loop_name(self) -> str:
        return "local"

    @property
    def _n_compute_devices(self) -> int:
        """Devices a step runs on (the MFU denominator): 1 here; the
        ranks in the distributed loop."""
        return 1

    @property
    def _step_batches(self) -> int:
        """Batches like the loop's one a step trains on, over every
        device (a step's FLOPs are one batch's times this)."""
        return self._n_compute_devices

    def _span(self, name: str, **args):
        """A tracer span, or a free null context without a tracer."""
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, **args)

    def _worker_span(self, worker_id, name: str, **args):
        """A span on the lane of worker `worker_id` (a tracer of its own,
        made at its first span, process `worker:<id>`), joined to the
        loop's open trace, so one step's shard dispatches filter together
        across lanes. A free null context without a tracer."""
        if self.tracer is None or worker_id is None:
            return contextlib.nullcontext()
        wt = self.worker_tracers.get(worker_id)
        if wt is None:
            from bigdl_tpu_torch.observability.spans import SpanTracer
            wt = SpanTracer(process_name=f"worker:{worker_id}",
                            annotate=False)
            self.worker_tracers[worker_id] = wt
        cur = self.tracer.current_context()
        return wt.span(name, cat="elastic",
                       ctx=cur.child() if cur is not None else None, **args)

    def _nan_guard(self):
        from bigdl_tpu_torch.observability.health import NanGuard
        for m in self.health_monitors:
            if isinstance(m, NanGuard):
                return m
        return None

    def _skips(self) -> bool:
        """Whether a `NanGuard("skip")` is armed."""
        guard = self._nan_guard()
        return guard is not None and guard.action == "skip"

    def _aux_flags(self):
        """(the NaN guard or None, whether the step computes the global
        norms): what the step computes besides its update."""
        guard = self._nan_guard()
        need_norms = bool(
            (self.telemetry is not None and self.telemetry.grad_norms)
            or (guard is not None and guard.check_grads))
        return guard, need_norms

    @staticmethod
    def _lr_scalar(lr) -> float:
        """The learning rate as one number (a per-submodule method's
        tuple of rates: their mean, as the reference logs it)."""
        if isinstance(lr, tuple):
            return float(np.mean([v for v in lr if v]) if any(lr) else 0.0)
        return float(lr)

    def _global_norm(self, tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global L2 norm of the float tensors (f32, on the device):
        each tensor's norm in one multi-tensor launch, then theirs."""
        ts = [t.float() for t in tensors.values() if t.is_floating_point()]
        if not ts:
            return torch.zeros((), device=self.device)
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(ts)))

    def _agree_bad(self, bad: torch.Tensor) -> torch.Tensor:
        """The non-finite flag as every replica holds it (one process:
        its own)."""
        return bad

    def _revert_snapshot(self, params: Dict[str, torch.Tensor], opt_state,
                         held: Dict):
        """What a skipped step puts back, taken before the forward (which
        moves the BN running statistics): the (dict, key) slots of the
        parameters, the optimizer state's tensors and the buffers, grouped
        by device and dtype, each group's values copied into row 0 of a
        [2, n] buffer of `held` (kept from one step to the next, with its
        views: row 1 is the revert's scratch). One multi-tensor copy a
        group: the step is often bound by the host's launches and ops."""
        buffers = dict(self.model.named_buffers())
        slots = [(params, k) for k in params] + \
            _tensor_slots(opt_state if isinstance(opt_state, dict) else {},
                          []) + [(buffers, k) for k in buffers]
        groups: Dict = {}
        for d, k in slots:
            t = d[k]
            groups.setdefault((t.device, t.dtype), []).append((d, k))
        with torch.no_grad():
            for key, members in groups.items():
                ts = [d[k] for d, k in members]
                layout = [(t.shape, t.stride()) for t in ts]
                if key not in held or held[key][0] != layout:
                    held[key] = (layout, *_flat_views(ts))
                torch._foreach_copy_(held[key][2], ts)
        return groups, buffers, held

    def _step_guards(self, guard, need_norms: bool, loss, grads,
                     params: Dict[str, torch.Tensor], opt_state, old):
        """The step's tail when a guard or the norms are armed: the
        non-finite flag (agreed over the replicas) and, under skip, the
        revert of this step's update to `old`; then the norms. Returns
        the 1-D f32 device tensor of `_aux_fields`; nothing is synced."""
        out = []
        gnorm = self._global_norm(dict(zip(params, grads))) \
            if need_norms else None
        if guard is not None:
            bad = ~torch.isfinite(loss)
            if guard.check_grads:
                bad = bad | ~torch.isfinite(gnorm)
            bad = self._agree_bad(bad)
            out.append(bad)
            if old is not None:
                groups, buffers, held = old
                # the state tree's entries may be new tensors (a step
                # count), the buffers re-registered: read them again
                buffers.update(self.model.named_buffers())
                with torch.no_grad():
                    for key, members in groups.items():
                        _, flat, kept, scratch = held[key]
                        ts = [d[k] for d, k in members]
                        torch._foreach_copy_(scratch, ts)
                        torch.where(bad, flat[0], flat[1], out=flat[1])
                        torch._foreach_copy_(ts, scratch)
        if need_norms:
            out += [gnorm, self._global_norm(params)]
        return torch.stack([t.detach().float().reshape(()) for t in out])

    def _telemetry_run_start(self):
        if self.tracer is not None:
            # the run's root trace: every loop span is its child
            self.tracer.begin_trace(f"optimize/{self._loop_name}",
                                    cat="train", loop=self._loop_name)
        tel = self._lead_telemetry
        if tel is None:
            return
        tel.run_start(loop=self._loop_name, model=type(self.model).__name__,
                      optim_method=type(self.optim_method).__name__,
                      backend=self.device.type,
                      n_devices=self._n_compute_devices,
                      sync_interval=self.sync_interval)

    def _end_run_trace(self):
        if self.tracer is not None:
            self.tracer.end_trace()

    def _telemetry_run_end(self, loop_state):
        self._end_run_trace()
        tel = self._lead_telemetry
        if tel is None:
            return
        tel.run_end(step=loop_state["neval"], epoch=loop_state["epoch"],
                    loss=loop_state.get("loss"),
                    metrics=self.metrics.as_dict())

    def _telemetry_run_abort(self, error):
        """The stream's end marker of a run that failed: every run_start
        pairs with a run_end, a run_retry or a run_abort."""
        self._end_run_trace()
        tel = self._lead_telemetry
        if tel is not None:
            tel.event("run_abort", error=repr(error))

    def _meta_twin(self) -> "BaseOptimizer":
        """A shallow copy of this optimizer over a meta copy of the model
        and a copy of the method, whose step `step_flops` counts."""
        twin = copy.copy(self)
        twin.model = _meta(self.model)
        twin.optim_method = copy.deepcopy(self.optim_method)
        return twin

    def _compiled(self, step, meta, sig_argnums=(1, 2)):
        """`step` behind a `CompiledFunction` when this process writes
        telemetry (one `compile` record a batch signature, the step's
        FLOPs in `last_info`: `meta`'s call on the meta device, times the
        batches a step trains on); `step` itself otherwise, as the
        reference keeps its plain path when nothing observes it."""
        tel = self._lead_telemetry
        if tel is None:
            return step
        from bigdl_tpu_torch.observability.compilation import \
            CompiledFunction
        return CompiledFunction(
            step, label=f"{self._loop_name}.step/{type(self.model).__name__}",
            telemetry=tel, sig_argnums=sig_argnums, meta=meta,
            device=str(self.device), flops_scale=self._step_batches)

    def _step_cost(self) -> Optional[int]:
        """The FLOPs of the step just dispatched (None without
        telemetry or when its count failed)."""
        info = getattr(self._step_fn, "last_info", None)
        return None if info is None else info.get("flops")

    @property
    def _writes_summaries(self) -> bool:
        """Whether this process writes the summaries (the distributed
        loop: rank 0)."""
        return True

    def _summary_params(self) -> Dict[str, torch.Tensor]:
        """The whole parameters by name, for the "Parameters"
        histograms."""
        return dict(self.model.named_parameters())

    def _write_train_summary(self, loop_state, loss_val, lr, throughput):
        """A sync point's scalars, and the parameters' histograms when the
        summary's "Parameters" trigger fires (the reference's
        `saveSummary`)."""
        summary = self.train_summary
        if summary is None:
            return
        it = loop_state["neval"]
        trig = getattr(summary, "get_summary_trigger",
                       lambda _n: None)("Parameters")
        fire = trig is not None and trig(loop_state)
        named = self._summary_params() if fire else None
        if not self._writes_summaries:
            return
        summary.add_scalar("Loss", loss_val, it)
        summary.add_scalar("LearningRate", self._lr_scalar(lr), it)
        summary.add_scalar("Throughput", throughput, it)
        if fire:
            from bigdl_tpu_torch.interop.jax_params import tree_from_named
            with torch.no_grad():
                tree = tree_from_named(self.model, named)
            for tag, leaf in _flat_tree(tree):
                summary.add_histogram(tag, leaf, it)

    def _device_kind(self) -> str:
        return torch.cuda.get_device_name(self.device) \
            if self.device.type == "cuda" else self.device.type

    def _sync(self, loss: torch.Tensor, aux_pending: List[torch.Tensor]):
        """The synced loss and the rows of the window's aux values, read
        in one device-to-host copy; empties `aux_pending`."""
        if not aux_pending:
            return self._synced_loss(loss), []
        t = self._loss_tensor(loss).detach().float().reshape(1)
        flat = torch.cat([t, *aux_pending]).tolist()
        aux_pending.clear()
        k = len(self._aux_fields)
        rows = [flat[i:i + k] for i in range(1, len(flat), k)]
        return self._loss_value(flat[0]), rows

    def _observe_sync(self, loop_state, loss_val, lr, throughput,
                      step_time_s, records, aux_rows, flops):
        """The host side of a sync point: the step record from the synced
        values, the health monitors, the telemetry. A no-op with neither
        attached."""
        tel = self._lead_telemetry
        if tel is None and not self.health_monitors:
            return
        rec = {"step": loop_state["neval"],
               "epoch": loop_state["epoch"] + 1,
               "loss": loss_val, "lr": self._lr_scalar(lr),
               "throughput": throughput, "step_time_s": step_time_s,
               "records": records}
        if tel is not None:
            rec["flops_per_step"] = flops
            rec["bytes_accessed"] = None
            rec["mfu"] = costs.mfu(flops, step_time_s,
                                   device_kind=self._device_kind(),
                                   n_devices=self._n_compute_devices)
        if self._active_pipeline is not None:
            # the input pipeline's gauges: ready batches, the loop's
            # cumulative wait, the worker pool's busy fraction
            rec.update(self._active_pipeline.health())
        if aux_rows:
            fields = self._aux_fields
            if "nonfinite" in fields:
                i = fields.index("nonfinite")
                rec["nonfinite_steps"] = int(sum(r[i] for r in aux_rows))
            if "grad_norm" in fields:
                last = dict(zip(fields, aux_rows[-1]))
                rec["grad_norm"] = last["grad_norm"]
                rec["param_norm"] = last["param_norm"]
        for m in self.health_monitors:
            m.observe(rec, tel)
        if tel is not None:
            tel.step(**rec)

    # -- the step ------------------------------------------------------------

    def _build_step(self):
        """step(opt_state, x, y, lr) -> (loss, aux): the loss a 0-d device
        tensor, not synced; aux None, or, with a NaN guard or the norms
        armed, a 1-D f32 device tensor of `self._aux_fields`. Updates the
        parameters and the optimizer state in place; the BN layers update
        their running stats during the forward(s)."""
        model = self.model
        optim = self.optim_method
        accum = self.grad_accum_steps
        clip = self.grad_clip_const is not None \
            or self.grad_clip_norm is not None
        params = dict(model.named_parameters())
        guard, need_norms = self._aux_flags()
        skip = guard is not None and guard.action == "skip"
        held: Dict = {}  # the skip's flat copies, reused
        self._aux_fields = (["nonfinite"] if guard is not None else []) \
            + (["grad_norm", "param_norm"] if need_norms else [])
        loss_and_grads = self._loss_and_grads(model)

        def step(opt_state, x, y, lr):
            with lend_generator(self._step_generator()), self._step_scope():
                return train_step(opt_state, x, y, lr)

        def train_step(opt_state, x, y, lr):
            model.train()
            old = self._revert_snapshot(params, opt_state, held) \
                if skip else None
            if accum > 1:
                # the micro-batches in order, their gradients and losses
                # summed, then averaged (the reference's scan)
                g_sum, l_sum = None, None
                for mx, my in zip(_micro_batches(x, accum),
                                  _micro_batches(y, accum)):
                    loss, grads = loss_and_grads(mx, my)
                    g_sum = grads if g_sum is None else \
                        [a + b for a, b in zip(g_sum, grads)]
                    l_sum = loss if l_sum is None else l_sum + loss
                grads = [g / accum for g in g_sum]
                loss = l_sum / accum
            else:
                loss, grads = loss_and_grads(x, y)
            grads = self._reduce_grads(grads)
            if clip:
                grads = self._clip_grads(grads)
            optim.update_with_masters(dict(zip(params, grads)), opt_state,
                                      params, lr)
            if guard is None and not need_norms:
                return loss, None
            return loss, self._step_guards(guard, need_norms, loss, grads,
                                           params, opt_state, old)

        return step

    def _loss_and_grads(self, model: torch.nn.Module):
        """loss_and_grads(x, y) -> (loss, grads) on `model`: the forward
        in the run's precision (under bf16, on bf16 copies of the f32
        parameters, inside the differentiated function), the criterion's
        loss (detached) and the gradients of every parameter of `model`
        (f32 under bf16 compute), in `named_parameters()` order."""
        criterion = self.criterion
        mixed = self._mixed_bf16
        params = dict(model.named_parameters())
        leaves = list(params.values())
        gather = self._gather_params

        def loss_and_grads(x, y):
            if mixed:
                # the bf16 copies per forward: each backward frees its
                # graph, the casts included
                low = {k: p.to(torch.bfloat16) for k, p in params.items()
                       if p.is_floating_point()}
                if gather is not None:
                    low = gather(low)
                out = functional_call(model, low,
                                      (_cast_floats(x, torch.bfloat16),))
                out = _cast_floats(out, torch.float32)
            elif gather is not None:
                out = functional_call(model, gather(params), (x,))
            else:
                out = model(x)
            loss = criterion(out, y)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
            return loss.detach(), list(grads)

        return loss_and_grads

    # hooks the data-parallel loop overrides; here, one process alone
    def _log_suffix(self) -> str:
        return ""

    def _step_generator(self):
        """What a step lends its `Dropout` layers."""
        return self.generator

    def _step_scope(self):
        """The context a step runs in."""
        return contextlib.nullcontext()

    def _reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """A step's gradients as the update takes them (before
        clipping)."""
        return grads

    def _start_attempt(self, params: Dict[str, torch.Tensor]):
        """Called at the start of each run or retried attempt, after the
        snapshot, before the optimizer state is built (from the
        parameters as this leaves them)."""

    def _loss_tensor(self, loss: torch.Tensor) -> torch.Tensor:
        """The device tensor a sync point reads the loss from."""
        return loss

    def _loss_value(self, v: float) -> float:
        """The loss to log and record, from `_loss_tensor`'s value."""
        return v

    def _synced_loss(self, loss: torch.Tensor) -> float:
        """The loss to log and record at a sync point (waits for the
        step)."""
        return self._loss_value(float(self._loss_tensor(loss)))

    def _epoch_size(self) -> int:
        return self.dataset.size()

    def _records(self, batch) -> int:
        """The records a step trains on."""
        return batch.size()

    def _keeps_snapshot(self) -> bool:
        """Whether a run takes the start-of-run snapshot (a host copy of
        every parameter and buffer, one transfer each): `LocalOptimizer`
        always, as a failed run puts the model back."""
        return True

    def _snapshot(self):
        """A host copy of the model's parameters and buffers, taken at the
        start of a run."""
        self._pristine = {k: v.detach().to("cpu", copy=True)
                          for k, v in self.model.state_dict().items()}

    def _start_run(self):
        """Forget the last run's snapshot; note the step generator's
        state."""
        self._pristine = None
        self._generator_at_start = self.generator.get_state()

    def _restore_pristine(self):
        """Put the start-of-run snapshot back: the steps update in place,
        so a run that fails mid-step leaves the model half updated. The
        step generator goes back to its start-of-run state too."""
        if self._pristine is not None:
            self.model.load_state_dict(self._pristine)
        if self._generator_at_start is not None:
            self.generator.set_state(self._generator_at_start)

    def _optimize_impl(self):
        params = dict(self.model.named_parameters())
        bad = [k for k, p in params.items() if p.device != self.device]
        if bad:
            raise ValueError(f"the model's parameters {bad[:3]} are not on "
                             f"the optimizer's device {self.device}")
        if self._keeps_snapshot():
            self._snapshot()
        self._start_attempt(params)
        params = dict(self.model.named_parameters())
        if self._resume_slots is not None:
            opt_state, self._resume_slots = self._resume_slots, None
        else:
            opt_state = self.optim_method.init_state_with_masters(params)
        if self._skips():
            # a step count a skipped step must not advance stays on the
            # device, as the skip's flag does
            opt_state = _counts_on(opt_state, self.device)
        self.opt_state = opt_state
        step = self._step_fn = self._compiled(
            self._build_step(),
            lambda opt_state, x, y, lr: meta_step_call(self, x, y))
        loop_state = self.optim_method.state
        epoch_size = self._epoch_size()
        data_iter = self._fast_forward_data(self._open_data_pipeline(),
                                            loop_state)
        self._init_cursor_positions()
        tel = self._lead_telemetry
        # a prefetched batch on a card comes pinned: copy it without
        # waiting, behind the step in flight
        non_blocking = self._active_pipeline is not None \
            and self.device.type == "cuda"

        def fetch_and_place():
            """The next batch, its inputs and targets on the device."""
            with Timer(self.metrics, "data fetch time"), \
                    self._span("data fetch"):
                batch = next(data_iter, None)
                if batch is None:
                    logger.warning("training data stream exhausted before "
                                   "the end trigger fired; stopping early")
                    return None
                self._note_pull()
                return (batch,
                        _to_device(batch.get_input(), self.device,
                                   non_blocking),
                        _to_device(batch.get_target(), self.device,
                                   non_blocking))

        sync_every = self.sync_interval
        self._telemetry_run_start()
        win = self._SyncWindow()
        loss_val = float("nan")
        loss = lr = flops = None
        preempted = False
        aux_pending: List[torch.Tensor] = []
        pending = fetch_and_place()
        while pending is not None and not self.end_trigger(loop_state):
            batch, x, y = pending
            faults.fire("train.step", step=loop_state["neval"] + 1)
            lr = self.optim_method.current_lr()
            with self._span("step dispatch", step=loop_state["neval"] + 1):
                loss, aux = step(opt_state, x, y, lr)
            flops = self._step_cost()
            self.last_loss = loss
            if aux is not None:
                aux_pending.append(aux)
            pending = fetch_and_place()  # queued while the step runs
            do_sync = (loop_state["neval"] + 1) % sync_every == 0
            if do_sync:
                with self._span("loss sync"):  # waits for the step
                    loss_val, aux_rows = self._sync(loss, aux_pending)
            n = self._records(batch)
            loop_state["neval"] += 1
            loop_state["recordsProcessedThisEpoch"] += n
            loop_state["loss"] = loss_val
            win.add(n)
            if do_sync:
                throughput = win.throughput(self.metrics)
                self._observe_sync(loop_state, loss_val, lr, throughput,
                                   win.step_time_s, n, aux_rows, flops)
                logger.info(
                    f"[Epoch {loop_state['epoch'] + 1} "
                    f"{loop_state['recordsProcessedThisEpoch']}/"
                    f"{epoch_size}][Iteration {loop_state['neval']}] "
                    f"Training cost {loss_val}. Throughput is {throughput} "
                    f"records/second.{self._log_suffix()}")
                self._write_train_summary(loop_state, loss_val, lr,
                                          throughput)
            if loop_state["recordsProcessedThisEpoch"] >= epoch_size:
                loop_state["epoch"] += 1
                loop_state["recordsProcessedThisEpoch"] = 0
                self._shuffle_dataset()
            with self._span("validation"):
                self._validate(loop_state)
            if self.checkpoint_trigger is not None \
                    and self.checkpoint_trigger(loop_state):
                with Timer(self.metrics, "checkpoint time"), \
                        self._span("checkpoint"):
                    self._save_checkpoint(opt_state,
                                          tag=f"iter{loop_state['neval']}")
            if self.iteration_hook is not None:
                self.iteration_hook(loop_state)
            if self._check_preemption(opt_state, loop_state, loss):
                preempted = True
                break
            if do_sync:
                win.restart()  # keep the tail work out of the next window
        if sync_every > 1 and loss is not None and \
                loop_state["neval"] % sync_every != 0:
            # the final loss, and the guard's view of the window's tail
            loss_val, aux_rows = self._sync(loss, aux_pending)
            loop_state["loss"] = loss_val
            if aux_rows:
                self._observe_sync(loop_state, loss_val, lr, float("nan"),
                                   float("nan"), 0, aux_rows, flops)
        if not preempted:  # a preempted run closed with run_abort
            self._telemetry_run_end(loop_state)
        self.opt_state = None
        self._step_fn = None
        return self.model


class LocalOptimizer(BaseOptimizer):
    """Train on one device (`device`, default CUDA): the model must already
    be there. `batch_size` is recorded as the reference records it; the
    dataset's batches set the size actually trained on. A run that fails
    puts the model back as it was at the run's start."""

    def __init__(self, model: torch.nn.Module, dataset, criterion,
                 batch_size: int = 32, *, device=None):
        super().__init__(model, dataset, criterion, device=device)
        self.batch_size = batch_size

    def optimize(self) -> torch.nn.Module:
        self._start_run()
        self._arm_preemption()
        try:
            return self._optimize_impl()
        except (KeyboardInterrupt, SystemExit):
            self._restore_pristine()
            raise
        except BaseException as e:
            self._telemetry_run_abort(e)
            self._restore_pristine()
            raise
        finally:
            # the prefetch threads are joined however the run ended
            self._close_data_pipeline()
            self._disarm_preemption()
