"""Synchronous data- and tensor-parallel training (counterpart of
`bigdl_tpu/optim/distri_optimizer.py`): one process per device, joined
by `torch.distributed` (`Engine.init(distributed=True)`; NCCL on cards,
gloo on the CPU).

The reference runs one SPMD program over a mesh; XLA inserts the
all-reduces. The port maps its multi-host mode onto GPUs instead: every
rank runs `BaseOptimizer`'s step on its own shard (a `DistributedDataSet`
or any dataset of its own batches) and the step is the reference's
global-batch step:
- the parameters and buffers are broadcast from rank 0 at the start of
  each run (and of each retried attempt);
- each step runs the local forward and backward (the micro-batches of
  `set_gradient_accumulation` included) inside
  `collectives.data_parallel_step`, where the BN layers take their
  statistics over the global batch and the criteria with a
  data-dependent denominator divide by the global one; then the
  gradients are all-reduced in size-bounded buckets
  (`optim/bucketing.py`, `set_gradient_bucketing`) and divided by the
  world size; then clipped, so the global L2 norm is the same on every
  rank; then the update, identical on every rank;
- under accumulation, micro-batch i is the union over the ranks of each
  shard's i-th slice (the reference's is the i-th slice of the global
  batch: the same function of a batch in another order);
- the loss is averaged over the ranks at the sync points only
  (`set_sync_interval`); `last_loss` is the rank's own;
- records count `batch.size() * num_hosts` and the epoch is the
  dataset's `global_size`, as the reference's;
- validation runs the whole validation set on every rank (no
  collective), so every rank gets the same score;
- dropout: each step every rank draws the same seed from the step
  generator, at the step's first draw, and makes its own mask generator
  from (seed, rank); a retried step draws the unfaulted run's masks;
- checkpoints: rank 0 writes, between a barrier and an all-reduced
  success flag (a failed write fails every rank at the same step);
  every rank resumes from the same file;
- retry: a failure retries only when every rank failed at the same step
  (they agree through the process group's store, `collectives.agree`,
  within the group's timeout), then all of them reload the same
  checkpoint. A failed collective (`CollectiveError`) is permanent, and
  a failure on one rank alone stops every rank: the failing one once the
  agreement times out, the others when their collective errors out.

Tensor parallelism: with `mesh` a `ProcessMesh` of shape (data D, model
M), M > 1 (`Engine.get_mesh(data=D, model=M)`; rank r at (r // M, r % M)),
the ranks of one model group (the same data index) train on the same
batch and share the parameters, as the reference's `NamedSharding` over
a (data, model) mesh; `sharding_rules` (default `ShardingRules()`, as the
reference's) decide which parameter is split over "model"
(`parallel/sharding.py`):
- at the start of each attempt the whole state is broadcast as above,
  then each rank keeps only its shard of every sharded parameter
  (`ShardedParameters`: the module's parameter is swapped for one of the
  shard's shape, under the same name); its f32 masters and slots are
  built from the shard, so they are 1/M the size. After the run (and
  before a retry reloads) the whole parameters are gathered back;
- each forward gathers every sharded parameter over the model group
  (`collectives.all_gather`); the backward gives each rank its own slice
  of the whole parameter's gradient, never summed over the model group
  (every rank of it computed the same loss on the same data);
- everything the data-parallel step reduces is reduced over the data
  group only, divided by D: the gradient buckets (built over the shards),
  the BN statistics, the criteria's denominators, the synced loss;
- the global L2 norm of clipping counts each shard once: the shards'
  squared norms are summed over the model group, the replicated
  parameters' added once; so do the norms of a method that reduces over
  a whole parameter (`LAMB`'s trust ratio,
  `collectives.tensor_parallel_step`);
- a `DistributedDataSet` is built with the mesh's data index over D hosts
  (`DistributedDataSet(items, mesh.data_index, D)`), so the ranks of a
  model group take the same rows and the records and the epoch count D
  hosts; one whose host index or count does not match the mesh is
  refused. Dropout mixes the step's seed with the data index, so a model
  group draws one mask and data replicas draw different ones;
- checkpoints: the format v2 gathers the whole parameters and slots on
  every rank first (`save_on_rank0`'s `gather`), so rank 0 writes what
  the reference loads; a resume slices each rank's shard out of the whole
  arrays. `set_checkpoint(sharded=True)` writes each rank's shards
  through `torch.distributed.checkpoint` (`sharded_checkpoint.py`);
- a run that fails for good puts the start-of-run parameters back, as
  `LocalOptimizer` does (each rank holds only its shards, so the model
  cannot be left as the failed step had it).
The compute is replicated across a model group: the Megatron split of
the matmuls is not ported (`ROADMAP.md` queue 2).

Observability (`set_telemetry`, `set_tracer`, `set_health_monitors`), as
`LocalOptimizer`'s, over the ranks:
- rank 0 alone writes the `run_*`, `step` and `event` records (a step
  record has no rank field); every rank keeps its own spans;
- the NaN guard's flag is agreed over the data group with one all-reduce
  before a skip reverts the update, so that the replicas stay equal; the
  gradient and parameter norms are the whole parameters' under a model
  axis (`collectives.whole_norms`);
- the monitors run on every rank on the same synced values, so a
  `NanGuard("raise")` fails every rank at the same step, and the retry
  path (with a checkpoint set) reloads on all of them: a `run_retry` and
  a `retry` event a retry, a `run_abort` when the run fails for good.

At world size 1 no collective is issued: the step is the local one, run
inside the reference's retry loop (on a failure the error is classified
by the `RetryPolicy`, the loop backs off, reloads the newest valid
checkpoint, or without one restores the host snapshot of the model taken
at the start of the attempt, and trains on). As in the reference, there
is no retry without `set_checkpoint`, and then no snapshot either.

Not ported (`ROADMAP.md` queue 1 item 3): several devices in one process
(a device `Mesh` or `devices=` naming more than one raises
`NotImplementedError`: start one process per GPU) and elastic mode; the
overlap of the gradient buckets and the gathers with the backward and
forward passes (queue 2).
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, List, Optional, Sequence

import torch

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.optim.bucketing import GradientBucketPlan
from bigdl_tpu_torch.optim.local_optimizer import BaseOptimizer
from bigdl_tpu_torch.parallel import collectives
from bigdl_tpu_torch.parallel.mesh import ProcessMesh
from bigdl_tpu_torch.parallel.sharding import (ShardedParameters,
                                               ShardingRules, param_specs)
from bigdl_tpu_torch.resilience.retry import RetryPolicy

logger = logging.getLogger("bigdl_tpu_torch.optim")


class DistriOptimizer(BaseOptimizer):
    """Data- and tensor-parallel SGD, one device per process. `mesh` is a
    `ProcessMesh` of the default group's ranks (`Engine.get_mesh(data,
    model)`), or, as before, a device `Mesh` naming this process's device;
    None is every rank on the data axis. `sharding_rules` (default
    `ShardingRules()`) place the parameters on a model axis. `devices`
    names this process's device (default: the current CUDA device, which
    `Engine.init` sets to the rank's). `retry_times` / `retry_interval_s`
    build the default `RetryPolicy(max_retries=retry_times,
    base_delay_s=retry_interval_s)`; `retry_policy` replaces it."""

    def __init__(self, model: torch.nn.Module, dataset, criterion,
                 mesh=None, sharding_rules: Optional[ShardingRules] = None,
                 retry_times: int = 5, retry_interval_s: float = 1.0,
                 retry_policy: Optional[RetryPolicy] = None, *,
                 devices: Optional[Sequence] = None):
        #: the mesh of ranks (None: every rank on the data axis)
        self.process_mesh: Optional[ProcessMesh] = None
        if isinstance(mesh, ProcessMesh):
            self.process_mesh = mesh
        elif mesh is not None:
            if devices is not None:
                raise ValueError("pass mesh or devices, not both")
            devices = list(mesh.devices.ravel())
        devices = [resolve_device(d) for d in (devices or [None])]
        if len(devices) != 1:
            raise NotImplementedError(
                f"DistriOptimizer drives one device a process, not "
                f"{len(devices)}: start one process per GPU "
                "(Engine.init(distributed=True)) and pass each its own "
                "(ROADMAP.md queue 1 item 3)")
        super().__init__(model, dataset, criterion, device=devices[0])
        self.devices = devices
        self.rules = sharding_rules or ShardingRules()
        #: this attempt's tensor-parallel placement (None without a model
        #: axis, and between runs)
        self.sharded: Optional[ShardedParameters] = None
        self.retry_times = retry_times
        self.retry_interval_s = retry_interval_s
        self.retry_policy = retry_policy
        self._bucket_bytes = 4 * 2 ** 20
        #: the gradient buckets of the current run (world size > 1)
        self.bucket_plan: Optional[GradientBucketPlan] = None
        # failures agreed on with the peers so far (keys the agreement)
        self._failures = 0

    def set_gradient_bucketing(self, bucket_mb: float = 4.0,
                               enabled: bool = True):
        """Reduce the gradients in buckets of at most `bucket_mb` MiB,
        one all-reduce each (`optim/bucketing.py`; default 4 MiB).
        `enabled=False`: one all-reduce a gradient."""
        if bucket_mb <= 0:
            raise ValueError(f"bucket_mb must be > 0, got {bucket_mb}")
        self._bucket_bytes = int(bucket_mb * 2 ** 20) if enabled else 0
        return self

    setGradientBucketing = set_gradient_bucketing

    @property
    def world(self) -> int:
        """Ranks training together (the process group's world size)."""
        return collectives.world_size()

    @property
    def data_size(self) -> int:
        """Data replicas (the mesh's data axis; the world without one)."""
        mesh = self.process_mesh
        return self.world if mesh is None else mesh.shape["data"]

    @property
    def model_size(self) -> int:
        """Ranks sharing the parameters (the mesh's model axis)."""
        mesh = self.process_mesh
        return 1 if mesh is None else mesh.shape["model"]

    @property
    def _data_group(self) -> Optional[collectives.Group]:
        """The ranks the data-parallel step reduces over (None: all)."""
        mesh = self.process_mesh
        return None if mesh is None else mesh.data_group

    @property
    def _data_index(self) -> int:
        mesh = self.process_mesh
        return collectives.rank() if mesh is None else mesh.data_index

    @property
    def _n_compute_devices(self) -> int:
        """The MFU denominator's device count: the global step runs on
        every rank's device."""
        return self.world

    @property
    def _lead_telemetry(self):
        return self.telemetry if collectives.rank() == 0 else None

    @property
    def _loop_name(self) -> str:
        return "distri"

    def _agree_bad(self, bad: torch.Tensor) -> torch.Tensor:
        """Non-finite on any data replica is non-finite on all: one
        all-reduce over the data group, so that every replica skips the
        same steps."""
        if self.data_size == 1:
            return bad
        n = collectives.all_reduce_(bad.to(torch.int32).reshape(1),
                                    "guard", self._data_group)
        return (n > 0).reshape(())

    def _global_norm(self, tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.sharded is None:
            return super()._global_norm(tensors)
        norms = collectives.whole_norms(
            {k: [t] for k, t in tensors.items() if t.is_floating_point()})
        return torch.sqrt(sum(n[0].float() ** 2 for n in norms.values()))

    def _log_suffix(self) -> str:
        if self.model_size > 1:
            return f" ({self.world} ranks, mesh {self.data_size}x" \
                f"{self.model_size})"
        return f" ({self.world} ranks)" if self.world > 1 \
            else f" ({len(self.devices)} devices)"

    def _keeps_snapshot(self) -> bool:
        """A run that can retry (a checkpoint path is set) needs the
        start-of-attempt snapshot, and so does one with a model axis: a
        failed run's ranks hold only their shards."""
        return self.checkpoint_path is not None or self.model_size > 1

    def _check_dataset(self) -> None:
        """A dataset that knows its shard (`DistributedDataSet`) must hold
        this rank's: its host index and count are the data index and the
        data replicas of the mesh, so the ranks of a model group train on
        the same rows."""
        index = getattr(self.dataset, "host_index", None)
        if index is None or self.world == 1:
            return
        got = (index, self.dataset.num_hosts)
        if got != (self._data_index, self.data_size):
            raise ValueError(
                f"the dataset is host {got[0]} of {got[1]}, but this rank "
                f"is data replica {self._data_index} of {self.data_size} "
                f"on the mesh: build it as DistributedDataSet(items, "
                f"mesh.data_index, mesh.shape['data'])")

    # -- the data-parallel step ---------------------------------------------

    def _start_attempt(self, params: Dict[str, torch.Tensor]):
        if self.world == 1:
            return
        with torch.no_grad():
            for t in self.model.state_dict().values():
                collectives.broadcast_(t, 0)
        if self.model_size > 1:
            self.sharded = ShardedParameters(
                self.model, self.process_mesh,
                param_specs(self.model, self.process_mesh, self.rules))
            self.sharded.place()
            if self._resume_slots is not None:
                self._resume_slots = self.sharded.shard_tree(
                    self._resume_slots)
        self.bucket_plan = GradientBucketPlan(
            dict(self.model.named_parameters()), self._bucket_bytes)

    def _unplace(self, gather: bool) -> None:
        """Put the whole parameters back after a run or a failed attempt
        (`ShardedParameters.unplace`)."""
        if self.sharded is not None:
            sharded, self.sharded = self.sharded, None
            sharded.unplace(gather)

    def _optimize_impl(self):
        model = super()._optimize_impl()
        self._unplace(gather=True)
        return model

    @property
    def _gather_params(self):
        return None if self.sharded is None else self.sharded.full_params

    def _grad_sq_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        if self.sharded is None:
            return super()._grad_sq_norm(grads)
        dims = self.sharded.dims
        names = [n for n, _ in self.model.named_parameters()]
        zero = grads[0].new_zeros((), dtype=torch.float32)
        shards = sum((torch.sum(g.float() ** 2)
                      for n, g in zip(names, grads) if n in dims), zero)
        shards = collectives.all_reduce_(shards.reshape(1).clone(), "clip",
                                         self.process_mesh.model_group)[0]
        return shards + sum((torch.sum(g.float() ** 2)
                             for n, g in zip(names, grads) if n not in dims),
                            zero)

    def _meta_twin(self):
        """Inside a tensor-parallel run the model holds its shards: the
        twin holds whole meta parameters instead and no placement, so
        that the count is the whole (replicated) step's, as before the
        run."""
        twin = super()._meta_twin()
        if self.sharded is not None:
            for name in self.sharded.dims:
                owner, _, leaf = name.rpartition(".")
                twin.model.get_submodule(owner)._parameters[leaf] = \
                    torch.nn.Parameter(torch.empty(
                        self.sharded.full_shapes[name], device="meta"))
            twin.sharded = None
        return twin

    def _sharded_leaf(self, name: str, t: torch.Tensor, conv: bool):
        if self.sharded is None or name not in self.sharded.dims:
            return super()._sharded_leaf(name, t, conv)
        return self.sharded.to_dtensor(name, t, conv)

    @contextlib.contextmanager
    def _step_scope(self):
        with collectives.data_parallel_step(self.data_size,
                                            self._data_group):
            if self.sharded is None:
                yield
                return
            with collectives.tensor_parallel_step(
                    self.sharded.dims, self.process_mesh.model_group):
                yield

    def _step_generator(self):
        if self.data_size == 1:
            return self.generator

        def replica_generator():
            seed = int(torch.randint(
                0, 2 ** 62, (1,), generator=self.generator,
                device=self.generator.device))
            mixed = (seed ^ (self._data_index * 0x9E3779B97F4A7C15)) \
                % 2 ** 63
            return torch.Generator(self.device).manual_seed(mixed)

        return replica_generator

    def _reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.data_size == 1:
            return grads
        plan = self.bucket_plan or GradientBucketPlan(
            dict(self.model.named_parameters()), self._bucket_bytes)
        return collectives.bucket_all_reduce_mean(
            grads, plan.buckets, self.data_size, self._data_group)

    def _loss_tensor(self, loss: torch.Tensor) -> torch.Tensor:
        """The loss summed over the data replicas (at a sync point)."""
        if self.data_size == 1:
            return loss
        t = loss.detach().float().reshape(1).clone()
        return collectives.all_reduce_(t, "loss", self._data_group)

    def _loss_value(self, v: float) -> float:
        return v / self.data_size if self.data_size > 1 else v

    def _epoch_size(self) -> int:
        num_hosts = getattr(self.dataset, "num_hosts", 1)
        return getattr(self.dataset, "global_size", None) or \
            self.dataset.size() * num_hosts

    def _records(self, batch) -> int:
        return batch.size() * getattr(self.dataset, "num_hosts", 1)

    def _save_checkpoint(self, opt_state, tag: str):
        if self.checkpoint_sharded:
            super()._save_checkpoint(opt_state, tag)
            return
        from bigdl_tpu_torch.serialization.checkpoint import save_on_rank0
        sharded = self.sharded

        def gather():
            if sharded is None:
                return None
            with torch.no_grad():
                return (sharded.full_params(
                    dict(self.model.named_parameters()), "unshard"),
                    sharded.gather_tree(opt_state))

        save_on_rank0(lambda full: self._save_v2(opt_state, tag, full),
                      self.device, gather=gather)
        self._commit_generator()

    # -- the retry loop -----------------------------------------------------

    def _retry_policy(self) -> RetryPolicy:
        """The policy passed in, else the default built from retry_times
        and retry_interval_s."""
        if self.retry_policy is None:
            self.retry_policy = RetryPolicy(
                max_retries=self.retry_times,
                base_delay_s=self.retry_interval_s,
                name="distri_optimizer")
        return self.retry_policy

    def _peers_failed_alike(self) -> bool:
        """Whether every rank failed at this same step (always at world
        size 1). A rank that did not fail is blocked in a collective and
        never answers; the agreement then times out."""
        if self.world == 1:
            return True
        self._failures += 1
        return collectives.agree(f"failure/{self._failures}",
                                 str(self.optim_method.state["neval"]))

    def optimize(self) -> torch.nn.Module:
        self._check_dataset()
        self._start_run()
        return self._optimize_with_retry()

    def _optimize_with_retry(self) -> torch.nn.Module:
        policy = self._retry_policy()
        attempt = 0
        backoff_spent = 0.0
        last_failure = time.time()
        while True:
            try:
                return self._optimize_impl()
            except (KeyboardInterrupt, SystemExit):
                self._unplace(gather=False)
                self._restore_pristine()
                raise
            except Exception as e:
                # close the failed attempt's root span before the next
                # attempt opens its own
                self._end_run_trace()
                attempt += 1
                # failures far apart start a fresh count and budget
                if time.time() - last_failure > 120:
                    attempt = 1
                    backoff_spent = 0.0
                last_failure = time.time()
                delay = None if self.checkpoint_path is None else \
                    policy.next_delay(attempt, backoff_spent, e)
                if delay is not None and not self._peers_failed_alike():
                    logger.error(
                        f"Optimization failed ({e!r}) on rank "
                        f"{collectives.rank()} alone, or at another step "
                        "than its peers: not retried")
                    delay = None
                if delay is None:
                    # a permanent error, retries used up, the budget gone,
                    # nothing to reload from, or peers that did not fail
                    # with this rank
                    self._telemetry_run_abort(e)
                    self._unplace(gather=False)
                    self._restore_pristine()
                    raise
                # every rank failed here and is alive: gather together
                self._unplace(gather=True)
                logger.warning(
                    f"Optimization failed ({e!r}); retry {attempt}/"
                    f"{policy.max_retries} from latest checkpoint in "
                    f"{delay:.3f}s")
                tel = self._lead_telemetry
                if tel is not None:
                    # the aborted attempt's end in the stream
                    tel.event("run_retry", attempt=attempt, error=repr(e))
                    tel.event("retry", policy=policy.name, attempt=attempt,
                              delay_s=round(delay, 6), error=repr(e),
                              transient=True)
                if not self.resume_from_latest_checkpoint():
                    # failed before the first checkpoint: start again from
                    # the model as this attempt found it
                    self._restore_pristine()
                backoff_spent += delay
                if delay > 0:
                    policy.sleep(delay)
