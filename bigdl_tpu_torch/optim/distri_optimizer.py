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

Preemption (`set_preemption_handler`): as `LocalOptimizer`'s, at each
iteration boundary. At world size > 1 a SIGTERM may reach one rank only,
so while a handler is armed the ranks agree on the latch with one
all-reduce of a 0/1 flag over the world (kind "preempt"; a sum, so > 0 is
the max) after the iteration hook: every rank stops at the same step,
every rank joins the checkpoint's collectives and rank 0 writes it. With
no handler armed the step issues nothing more.

Elastic mode (`set_elastic`, the reference's shrink, replay and grow): a
single-controller loop in one process over a device list, which may name
one device several times (`build_mesh(data=2, devices=["cpu"] * 2)`, or
four slots of one card). Each global batch is `logical_replicas` fixed
logical shards; each shard's loss, f32 gradients and new BN buffers come
from one function (`_elastic_step`) on whichever slot owns it (round-
robin over the plan's slots). Slots on the lead's device use the model
itself; a slot on another device keeps a replica module there, into which
the lead's parameters are copied before its shards run. When the lead
moves to another device (its own was lost, or it grows back), the model,
the optimizer slots and the step generator are rebuilt there from the
last commit's host copies, never read from the old device; the devices
must be of one type (a generator's state does not cross types). Each
shard starts from the buffers as they were before the step (taken once,
put back before each shard) and computes BN statistics over its own rows;
the
shards' new buffers are averaged in f32 in logical order (a count such
as `num_batches_tracked` takes shard 0's). Shard i's dropout generator is
seeded from one draw of the step generator and i, never from the slot.
Each shard's gradients are added into one running sum on the lead as
soon as its backward ends, in logical order (no all-reduce; bucketing
changes nothing here), then divided by the shard count, clipped and
applied. Commit points (sync and epoch boundaries) copy the parameters,
every optimizer slot, the buffers, the step generator's state and the
loop state to the host; a recoverable failure (`_elastic_recoverable`)
marks the lost workers, replans over the survivors, restores the commit
into the live tensors and replays the window's batches, so the
trajectory equals an uninterrupted run's bit for bit. Elastic mode is
data-parallel only, refuses gradient accumulation, a batch that does not
divide and `NanGuard("skip")` (the step has no revert: the reference's
elastic loop applies no step guards), and raises `NotImplementedError`
under a `ProcessMesh` or at world size > 1 (re-forming a process group
after a loss, `ROADMAP.md` queue 1 item 3).

Outside elastic mode a device list of more than one device raises
`NotImplementedError` at `optimize()`: start one process per GPU. Not
ported: the overlap of the gradient buckets and the gathers with the
backward and forward passes (`ROADMAP.md` queue 2).
"""

from __future__ import annotations

import collections
import contextlib
import copy
import logging
import time
from typing import Dict, List, Optional, Sequence

import torch

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.nn.dropout import lend_generator
from bigdl_tpu_torch.optim.bucketing import GradientBucketPlan
from bigdl_tpu_torch.optim.local_optimizer import (BaseOptimizer,
                                                   _to_device,
                                                   meta_step_call)
from bigdl_tpu_torch.optim.metrics import Timer
from bigdl_tpu_torch.parallel import collectives
from bigdl_tpu_torch.parallel.mesh import ProcessMesh
from bigdl_tpu_torch.parallel.sharding import (ShardedParameters,
                                               ShardingRules, param_specs)
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.resilience.elastic import torch_device
from bigdl_tpu_torch.resilience.retry import RetryPolicy

logger = logging.getLogger("bigdl_tpu_torch.optim")


class DistriOptimizer(BaseOptimizer):
    """Data- and tensor-parallel SGD, one device per process. `mesh` is a
    `ProcessMesh` of the default group's ranks (`Engine.get_mesh(data,
    model)`), or a device `Mesh` naming this process's device (several for
    elastic mode); None is every rank on the data axis. `sharding_rules`
    (default `ShardingRules()`) place the parameters on a model axis.
    `devices` names this process's device (default: the current CUDA
    device, which `Engine.init` sets to the rank's), or elastic mode's
    device list. `retry_times` / `retry_interval_s` build the default
    `RetryPolicy(max_retries=retry_times, base_delay_s=retry_interval_s)`;
    `retry_policy` replaces it."""

    def __init__(self, model: torch.nn.Module, dataset, criterion,
                 mesh=None, sharding_rules: Optional[ShardingRules] = None,
                 retry_times: int = 5, retry_interval_s: float = 1.0,
                 retry_policy: Optional[RetryPolicy] = None, *,
                 devices: Optional[Sequence] = None):
        #: the mesh of ranks (None: every rank on the data axis)
        self.process_mesh: Optional[ProcessMesh] = None
        #: the device `Mesh` passed in (None: none)
        self.device_mesh = None
        if isinstance(mesh, ProcessMesh):
            self.process_mesh = mesh
        elif mesh is not None:
            if devices is not None:
                raise ValueError("pass mesh or devices, not both")
            self.device_mesh = mesh
            devices = list(mesh.devices.ravel())
        devices = [resolve_device(d) for d in (devices or [None])]
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
        # whether set_gradient_bucketing was called (elastic mode then
        # reports a plan)
        self._bucketing_armed = False
        #: the gradient buckets of the current run (world size > 1, or
        #: elastic mode with bucketing armed)
        self.bucket_plan: Optional[GradientBucketPlan] = None
        # failures agreed on with the peers so far (keys the agreement)
        self._failures = 0
        # elastic mode's registry, controller and recovery bound (None:
        # not armed)
        self._elastic: Optional[Dict] = None
        #: the last elastic run's counts: shard dispatches, commits and
        #: their seconds, recoveries, replayed batches
        self.elastic_stats: Dict = {}
        # torch device -> replica module (elastic slots off the lead's
        # device)
        self._replicas: Dict = {}

    def set_gradient_bucketing(self, bucket_mb: float = 4.0,
                               enabled: bool = True):
        """Reduce the gradients in buckets of at most `bucket_mb` MiB,
        one all-reduce each (`optim/bucketing.py`; default 4 MiB).
        `enabled=False`: one all-reduce a gradient. Elastic mode runs in
        one process and reduces nothing: each shard's gradients are added
        into the running sums, in logical order, as soon as its backward
        is done, with or without bucketing, so there the setter only
        builds the plan and reports it (a `bucket_plan` event) and the
        trajectory is the same bits either way."""
        if bucket_mb <= 0:
            raise ValueError(f"bucket_mb must be > 0, got {bucket_mb}")
        self._bucket_bytes = int(bucket_mb * 2 ** 20) if enabled else 0
        self._bucketing_armed = bool(enabled)
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
        every rank's device (elastic mode: on the distinct devices of its
        list)."""
        if self._elastic is not None:
            return len(set(self.devices))
        return self.world

    @property
    def _step_batches(self) -> int:
        """Batches like the loop's one a step trains on: one a rank; the
        global batch itself in elastic mode."""
        return 1 if self._elastic is not None else self._n_compute_devices

    @property
    def _lead_telemetry(self):
        return self.telemetry if collectives.rank() == 0 else None

    @property
    def _writes_summaries(self) -> bool:
        return collectives.rank() == 0

    def _summary_params(self) -> Dict[str, torch.Tensor]:
        """Under a model axis the shards are gathered (every rank takes
        part; rank 0 writes)."""
        params = dict(self.model.named_parameters())
        if self.sharded is None:
            return params
        return self.sharded.full_params(params, "unshard")

    @property
    def _loop_name(self) -> str:
        return "distri" if self._elastic is None else "distri_elastic"

    def _agree_preempted(self, triggered: bool) -> bool:
        """Every rank's latch as one: an all-reduce of the 0/1 flags over
        the world (their sum, so > 0 is the max), only called while a
        handler is armed."""
        if self.world == 1:
            return triggered
        flag = torch.tensor([1.0 if triggered else 0.0],
                            device=collectives.flag_device())
        collectives.all_reduce_(flag, "preempt")
        return float(flag) > 0

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
        if self._elastic is not None:
            return self._optimize_elastic_impl()
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

    # -- elastic mode ---------------------------------------------------------

    def set_elastic(self, logical_replicas: Optional[int] = None,
                    registry=None, controller=None, min_devices: int = 1,
                    max_recoveries_per_window: int = 8,
                    enabled: bool = True):
        """Arm elastic, preemption-tolerant training (see the module
        docstring): when a replica's device is lost mid-step (or the fault
        sites `mesh.device_loss` / `mesh.collective` say so), the loop
        rolls back to the last committed sync boundary, replans over the
        survivors, and replays the interrupted batches; when a lost worker
        comes back (a `WorkerRegistry` heartbeat) it grows back at the next
        committed boundary.

        `logical_replicas` (default: the registry's device count) is the
        fixed number of logical shards of a global batch. `registry`
        defaults to one worker a device of `devices`, each a `Slot` of its
        own, with an unending lease; pass a `SimulatedCluster(...)
        .registry` to script a fleet. `min_devices` is the floor below
        which the failure goes to the job-level retry, and
        `max_recoveries_per_window` bounds consecutive recoveries between
        commits. `enabled=False` disarms."""
        if not enabled:
            self._elastic = None
            return self
        model_axis = self.model_size if self.device_mesh is None \
            else self.device_mesh.shape.get("model", 1)
        if model_axis != 1:
            raise ValueError(
                "elastic training is data-parallel only: build the mesh "
                f"with model=1 (got model={model_axis})")
        self._refuse_elastic_processes()
        from bigdl_tpu_torch.resilience.elastic import ElasticController
        from bigdl_tpu_torch.resilience.membership import (Slot,
                                                           WorkerRegistry)
        if registry is None:
            registry = WorkerRegistry(lease_s=float("inf"))
            for i, d in enumerate(self.devices):
                registry.register(f"worker{i}", [Slot(i, d)])
        if controller is None:
            if logical_replicas is None:
                logical_replicas = max(1, registry.total_devices())
            controller = ElasticController(logical_replicas,
                                           min_devices=min_devices)
        if max_recoveries_per_window < 1:
            raise ValueError(f"max_recoveries_per_window must be >= 1, "
                             f"got {max_recoveries_per_window}")
        self._elastic = {"registry": registry, "controller": controller,
                         "max_recoveries": int(max_recoveries_per_window)}
        return self

    setElastic = set_elastic

    def _refuse_elastic_processes(self) -> None:
        if self.process_mesh is not None or self.world > 1:
            raise NotImplementedError(
                "elastic mode is single-controller (one process over a "
                "device list); under a process group it would have to "
                "re-form the group after a loss, which is not ported "
                "(ROADMAP.md queue 1 item 3)")

    @staticmethod
    def _elastic_mean(losses: List[torch.Tensor], states: List[Dict],
                      n: int):
        """The mean loss over the shards and their buffers averaged: float
        ones summed in logical order and divided by `n`, in f32; others (a
        count) shard 0's."""
        loss = losses[0]
        for li in losses[1:]:
            loss = loss + li
        loss = loss / n
        if n == 1:
            return loss, states[0]
        mean = {}
        for k, first in states[0].items():
            if not first.is_floating_point():
                mean[k] = first
                continue
            acc = first.float()
            for st in states[1:]:
                acc = acc + st[k].float()
            mean[k] = acc / n
        return loss, mean

    @staticmethod
    def _elastic_recoverable(e: BaseException) -> bool:
        """The failures the elastic loop recovers from in-process:
        `membership.DeviceLossError` and `membership.CollectiveError`
        (injected or raised), `torch.AcceleratorError` where the installed
        torch has it (the CUDA runtime's errors), and otherwise a
        `RuntimeError` whose message starts with "CUDA error" (the form the
        CUDA runtime's errors take in older torch). Everything else goes to
        the job-level retry."""
        from bigdl_tpu_torch.resilience.membership import (CollectiveError,
                                                           DeviceLossError)
        if isinstance(e, (DeviceLossError, CollectiveError)):
            return True
        accel = getattr(torch, "AcceleratorError", None)
        if accel is not None and isinstance(e, accel):
            return True
        return isinstance(e, RuntimeError) \
            and str(e).startswith("CUDA error")

    @staticmethod
    def _probe_dead_devices(devices) -> List:
        """The entries of `devices` (slots or devices) that fail a
        host -> device -> host round trip."""
        dead = []
        for d in devices:
            try:
                torch.zeros(2).to(torch_device(d)).cpu()
            except Exception:
                dead.append(d)
        return dead

    def _host_state(self, opt_state) -> Dict:
        """Host copies of the parameters (in `parameters()` order), the
        optimizer slots, the buffers and the step generator's state."""
        with torch.no_grad():
            return {"params": [p.detach().to("cpu", copy=True)
                               for p in self.model.parameters()],
                    "opt": _host_tree(opt_state),
                    "bufs": {k: b.detach().to("cpu", copy=True)
                             for k, b in self.model.named_buffers()},
                    "generator": self.generator.get_state()}

    def _lead_to(self, slot, opt_state, c) -> None:
        """Make `slot`'s device the one the model, `opt_state` and the step
        generator live on, built from the host copies `c` (`_host_state`)
        alone: the old lead's device may be the lost one, so nothing is
        read from it (None: take them now, from a device known to be
        alive). The parameters keep their identity (`.data` is rebound);
        the buffers and the slots are rebound to new tensors."""
        dev = torch_device(slot)
        if dev == self.device:
            return
        if c is None:
            c = self._host_state(opt_state)
        moved: Dict = {}
        with torch.no_grad():
            for p, h in zip(self.model.parameters(), c["params"]):
                p.data = h.to(dev, copy=True)
            for prefix, mod in self.model.named_modules():
                for k, b in mod._buffers.items():
                    if b is None:
                        continue
                    if id(b) not in moved:  # a buffer shared by modules
                        moved[id(b)] = c["bufs"][
                            f"{prefix}.{k}" if prefix else k].to(dev,
                                                                 copy=True)
                    mod._buffers[k] = moved[id(b)]
        if opt_state is not None:
            _tree_from_host(opt_state, c["opt"], dev)
        gen = torch.Generator(dev)
        gen.set_state(c["generator"])
        self.generator = gen
        self.device = dev
        self._replicas.pop(dev, None)

    def _slot_model(self, dev: torch.device, buf0: Dict):
        """(module, its loss_and_grads, its live buffers, the step's
        starting buffers there) for the slots on `dev`: the model itself on
        the lead's device, else a replica holding the lead's parameters."""
        if dev == self.device:
            m, m_buf0 = self.model, buf0
        else:
            m = self._replicas.get(dev)
            if m is None:
                m = self._replicas[dev] = copy.deepcopy(self.model).to(dev)
            with torch.no_grad():
                for a, b in zip(m.parameters(), self.model.parameters()):
                    a.copy_(b)
            m_buf0 = {k: v.to(dev) for k, v in buf0.items()}
        m.train()
        return m, self._loss_and_grads(m), dict(m.named_buffers()), m_buf0

    def _build_bucket_add(self):
        """The running sum's add of one shard's gradients
        (`torch._foreach_add`): behind a `CompiledFunction` labelled
        "distri.bucket_add" when this process writes telemetry, as the
        reference's (one `compile` record a gradient layout)."""
        def bucket_add(acc, g):
            return torch._foreach_add(acc, g)

        tel = self._lead_telemetry
        if tel is None:
            return bucket_add
        from bigdl_tpu_torch.observability.compilation import \
            CompiledFunction
        return CompiledFunction(bucket_add, label="distri.bucket_add",
                                telemetry=tel)

    def _elastic_step(self, plan, controller, registry, xs, ys,
                      step_no: int, opt_state, lr, bucket_add):
        """One global step as `controller.logical_replicas` logical
        shards on `plan`'s slots, then the combine and the update on the
        lead; returns the mean loss (a device tensor). `bucket_add` adds
        a shard's gradients into the running sum (`_build_bucket_add`)."""
        R0 = controller.logical_replicas
        params = dict(self.model.named_parameters())
        names = list(params)
        with torch.no_grad():
            buf0 = {k: b.clone() for k, b in self.model.named_buffers()}
        seed: List[int] = []

        def shard_generator(i: int, dev: torch.device):
            def make():
                # one draw of the step generator a step, at the first
                # shard that draws; shard i's stream keys off i alone
                if not seed:
                    seed.append(int(torch.randint(
                        0, 2 ** 62, (1,), generator=self.generator,
                        device=self.generator.device)))
                mixed = (seed[0] ^ ((i + 1) * 0x9E3779B97F4A7C15)) % 2 ** 63
                return torch.Generator(dev).manual_seed(mixed)
            return make

        on: Dict = {}
        losses, states = [], []
        g = None  # the running sum of the shards' gradients
        for i in range(R0):
            slot = controller.shard_device(plan, i)
            dev = torch_device(slot)
            if dev not in on:
                on[dev] = self._slot_model(dev, buf0)
            _, loss_and_grads, m_bufs, m_buf0 = on[dev]
            with torch.no_grad():
                for k, b in m_bufs.items():
                    b.copy_(m_buf0[k])
            with self._worker_span(registry.worker_for_device(slot),
                                   "shard dispatch", shard=i, step=step_no,
                                   device=str(dev)):
                with lend_generator(shard_generator(i, dev)), \
                        self._step_scope():
                    l_i, g_i = loss_and_grads(_to_device(xs[i], dev),
                                              _to_device(ys[i], dev))
            self.elastic_stats["shard_dispatches"] += 1
            with torch.no_grad():
                ms_i = {k: b.clone() for k, b in m_bufs.items()}
            if dev != self.device:
                l_i = l_i.to(self.device)
                g_i = [t.to(self.device) for t in g_i]
                ms_i = {k: v.to(self.device) for k, v in ms_i.items()}
            losses.append(l_i)
            states.append(ms_i)
            # into the running sum now, in logical order (a left fold)
            with torch.no_grad():
                g = g_i if g is None else bucket_add(g, g_i)
        faults.fire("mesh.collective", step=step_no, n_active=plan.n_active)
        with torch.no_grad():
            g = torch._foreach_div(g, float(R0))
        if self.grad_clip_const is not None or self.grad_clip_norm is not None:
            g = self._clip_grads(g)
        self.optim_method.update_with_masters(dict(zip(names, g)), opt_state,
                                              params, lr)
        loss, mean = self._elastic_mean(losses, states, R0)
        with torch.no_grad():
            for k, b in self.model.named_buffers():
                b.copy_(mean[k])
        return loss

    def _optimize_elastic_impl(self):
        """The elastic loop: per-shard dispatch with commit, rollback and
        replay (see the module docstring and `set_elastic`). Epoch
        boundaries always commit, so a rollback never crosses a dataset
        reshuffle."""
        from bigdl_tpu_torch.resilience.elastic import \
            InsufficientCapacityError
        cfg = self._elastic
        registry, controller = cfg["registry"], cfg["controller"]
        max_recoveries = cfg["max_recoveries"]
        if self.grad_accum_steps > 1:
            raise ValueError(
                "elastic mode does not support gradient accumulation: "
                "unset set_gradient_accumulation, or raise "
                "logical_replicas instead (shards already bound peak "
                "activation memory)")
        if self._skips():
            raise ValueError(
                "elastic mode cannot honour NanGuard('skip'): its step has "
                "no revert (the reference's elastic loop applies no step "
                "guards); use NanGuard('warn') or NanGuard('raise')")
        bad = [k for k, p in self.model.named_parameters()
               if p.device != self.device]
        if bad:
            raise ValueError(f"the model's parameters {bad[:3]} are not on "
                             f"the optimizer's device {self.device}")
        tel = self._lead_telemetry
        if registry.telemetry is None and tel is not None:
            registry.telemetry = tel
        registry.sweep()
        kinds = {torch_device(d).type for d in registry.alive_devices()}
        if kinds - {self.device.type}:
            # the step generator's state moves with the lead, and a CPU
            # generator's state is not a CUDA one's
            raise ValueError(
                f"elastic mode needs its devices of one type, the model's "
                f"({self.device.type}); got {sorted(kinds)}")
        total_dev = registry.total_devices()
        plan = controller.plan(registry.alive_devices(), total_dev)
        self._lead_to(plan.lead, None, None)
        if self._keeps_snapshot():
            self._snapshot()
        params = dict(self.model.named_parameters())
        if self._resume_slots is not None:
            opt_state, self._resume_slots = self._resume_slots, None
            _tree_to(opt_state, self.device)
        else:
            opt_state = self.optim_method.init_state_with_masters(params)
        self.opt_state = opt_state
        if self._bucketing_armed:
            self.bucket_plan = GradientBucketPlan(list(params.values()),
                                                  self._bucket_bytes)
            if tel is not None:
                tel.event("bucket_plan", **self.bucket_plan.describe())
        loop_state = self.optim_method.state
        epoch_size = self._epoch_size()
        data_iter = self._fast_forward_data(self._open_data_pipeline(),
                                            loop_state)
        self._init_cursor_positions()
        bucket_add = self._build_bucket_add()

        def global_step(x, y, plan, step_no, lr):
            return self._elastic_step(
                plan, controller, registry, controller.split_batch(x),
                controller.split_batch(y), step_no, opt_state, lr,
                bucket_add)

        # the FLOPs of the whole global batch's step (as one step on the
        # lead's device would run it), counted once a batch signature
        step = self._step_fn = self._compiled(
            global_step, lambda x, y, *rest: meta_step_call(self, x, y),
            sig_argnums=(0, 1))
        stats = self.elastic_stats = {
            "shard_dispatches": 0, "commits": 0, "commit_s": 0.0,
            "recoveries": 0, "replayed_batches": 0}
        sync_every = self.sync_interval
        self._telemetry_run_start()
        win = self._SyncWindow()
        loss_val = float("nan")
        loss = lr = flops = None
        preempted = False
        recoveries = 0  # consecutive recoveries with no commit between
        replay_q: collections.deque = collections.deque()
        window_batches: List = []  # the batches pulled since the commit

        def fetch():
            if replay_q:
                b = replay_q.popleft()
                # the stream is ahead of the trained position until the
                # queue drains: no cursor in a checkpoint meanwhile
                self._cursor_valid = False
            else:
                with Timer(self.metrics, "data fetch time"), \
                        self._span("data fetch"):
                    b = next(data_iter, None)
                if b is None:
                    logger.warning("training data stream exhausted before "
                                   "the end trigger fired; stopping early")
                else:
                    self._note_pull()
                    # no lookahead here: the batch just pulled is the one
                    # this step trains, so its checkpoint's cursor names
                    # the position after it
                    self._cursor_prev_pos = self._cursor_last_pos
            if b is not None:
                window_batches.append(b)
            return b

        def commit():
            t0 = time.perf_counter()
            c = self._host_state(opt_state)
            c.update(state=dict(loop_state), loss_val=loss_val)
            stats["commits"] += 1
            stats["commit_s"] += time.perf_counter() - t0
            return c

        def restore(c):
            with torch.no_grad():
                for p, h in zip(params.values(), c["params"]):
                    p.copy_(h)
                _restore_tree(opt_state, c["opt"])
                for k, b in self.model.named_buffers():
                    b.copy_(c["bufs"][k])
            self.generator.set_state(c["generator"])
            loop_state.clear()
            loop_state.update(c["state"])

        committed = commit()
        while not self.end_trigger(loop_state):
            batch = fetch()
            if batch is None:
                break
            step_no = loop_state["neval"] + 1
            try:
                faults.fire("train.step", step=step_no)
                faults.fire("mesh.device_loss", step=step_no,
                            n_active=plan.n_active)
                lr = self.optim_method.current_lr()
                with self._span("step dispatch", step=step_no):
                    loss = step(batch.get_input(), batch.get_target(), plan,
                                step_no, lr)
                flops = self._step_cost()
                self.last_loss = loss
                do_sync = step_no % sync_every == 0
                if do_sync:
                    with self._span("loss sync"):
                        loss_val = self._synced_loss(loss)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                if not self._elastic_recoverable(e):
                    raise
                recoveries += 1
                if recoveries > max_recoveries:
                    # no commit across max_recoveries replays: the
                    # "recoverable" failure is deterministic
                    logger.error(
                        "elastic recovery made no progress after %d "
                        "consecutive attempts; giving up on in-process "
                        "recovery", max_recoveries)
                    raise
                lost = tuple(getattr(e, "lost", ()) or ())
                if lost:
                    for w in lost:
                        if isinstance(w, str):
                            registry.mark_lost(w, reason=repr(e))
                        else:
                            registry.mark_device_lost(w, reason=repr(e))
                else:
                    for d in self._probe_dead_devices(plan.devices):
                        registry.mark_device_lost(d, reason=repr(e))
                registry.sweep()
                try:
                    new_plan = controller.plan(registry.alive_devices(),
                                               total_dev)
                except InsufficientCapacityError:
                    raise e  # below the floor: the job-level retry's
                kind = "elastic_shrink" if \
                    new_plan.n_active < plan.n_active else "elastic_rebuild"
                boundary_step = controller.replay_boundary(
                    committed["state"].get("neval", 0))
                logger.warning(
                    "%s at step %d (%r): %d -> %d active device(s); "
                    "rolling back to step %d and replaying %d batch(es)",
                    kind, step_no, e, plan.n_active, new_plan.n_active,
                    boundary_step, len(window_batches) + len(replay_q))
                if tel is not None:
                    tel.event(kind, step=step_no,
                              n_active_before=plan.n_active,
                              n_active=new_plan.n_active,
                              alive_workers=len(registry.alive()),
                              degraded_capacity=new_plan.degraded_capacity,
                              error=repr(e))
                plan = new_plan
                self._lead_to(plan.lead, opt_state, committed)
                restore(committed)
                loss, loss_val = None, committed["loss_val"]
                # a failure mid-replay keeps the still-queued tail
                replay = window_batches + list(replay_q)
                replay_q.clear()
                replay_q.extend(replay)
                window_batches.clear()
                stats["recoveries"] += 1
                stats["replayed_batches"] += len(replay_q)
                if tel is not None:
                    tel.event("elastic_replay", batches=len(replay_q),
                              from_step=controller.replay_boundary(
                                  loop_state.get("neval", 0)))
                win.restart()
                continue

            n = self._records(batch)
            loop_state["neval"] += 1
            loop_state["recordsProcessedThisEpoch"] += n
            loop_state["loss"] = loss_val
            win.add(n)
            if do_sync:
                throughput = win.throughput(self.metrics)
                self._observe_sync(loop_state, loss_val, lr, throughput,
                                   win.step_time_s, n, [], flops)
                logger.info(
                    f"[Epoch {loop_state['epoch'] + 1} "
                    f"{loop_state['recordsProcessedThisEpoch']}/"
                    f"{epoch_size}][Iteration {loop_state['neval']}] "
                    f"Training cost {loss_val}. Throughput is {throughput} "
                    f"records/second. ({plan.n_active} devices, elastic)")
                self._write_train_summary(loop_state, loss_val, lr,
                                          throughput)
            boundary = loop_state["recordsProcessedThisEpoch"] >= epoch_size
            if boundary:
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
            if do_sync or boundary:
                # the rollback target from here on
                committed = commit()
                window_batches.clear()
                recoveries = 0
                # lease expiries shrink, revived workers grow, both at a
                # committed point: no rollback needed
                registry.sweep()
                new_plan = controller.plan(registry.alive_devices(),
                                           total_dev)
                if new_plan.devices != plan.devices:
                    grow = new_plan.n_active > plan.n_active
                    if tel is not None:
                        tel.event(
                            "elastic_grow" if grow else "elastic_shrink",
                            step=loop_state["neval"],
                            n_active_before=plan.n_active,
                            n_active=new_plan.n_active,
                            alive_workers=len(registry.alive()),
                            degraded_capacity=new_plan.degraded_capacity)
                    logger.info(
                        "elastic %s at step %d: %d -> %d active devices",
                        "grow" if grow else "shrink", loop_state["neval"],
                        plan.n_active, new_plan.n_active)
                    plan = new_plan
                    self._lead_to(plan.lead, opt_state, committed)
            if do_sync:
                win.restart()

        if sync_every > 1 and loss is not None and \
                loop_state["neval"] % sync_every != 0:
            loop_state["loss"] = loss_val = self._synced_loss(loss)
        if not preempted:
            self._telemetry_run_end(loop_state)
        self.opt_state = None
        self._step_fn = None
        self._replicas.clear()
        return self.model

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

    def _check_devices(self) -> None:
        """One device a process, unless elastic mode drives the list."""
        if self._elastic is not None:
            self._refuse_elastic_processes()
        elif len(self.devices) != 1:
            raise NotImplementedError(
                f"DistriOptimizer drives one device a process, not "
                f"{len(self.devices)}: start one process per GPU "
                "(Engine.init(distributed=True)) and pass each its own, or "
                "arm set_elastic for the single-controller elastic loop")

    def optimize(self) -> torch.nn.Module:
        self._check_devices()
        self._check_dataset()
        self._maybe_optimize_graph()
        self._start_run()
        self._arm_preemption()
        try:
            return self._optimize_with_retry()
        finally:
            self._disarm_preemption()

    def _optimize_with_retry(self) -> torch.nn.Module:
        policy = self._retry_policy()
        attempt = 0
        backoff_spent = 0.0
        last_failure = time.time()
        while True:
            try:
                try:
                    return self._optimize_impl()
                finally:
                    # each attempt joins its prefetch threads, finished
                    # or failed, before a retry builds new ones
                    self._close_data_pipeline()
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



class ParallelOptimizer(DistriOptimizer):
    """The reference's `ParallelOptimizer`, a parity subclass that adds
    nothing to `DistriOptimizer`. The reference's `ParallelOptimizer`
    overlaps each layer's gradient exchange with the rest of the
    backward; the port's step still takes every gradient from one
    `torch.autograd.grad` and then all-reduces the buckets, and that
    overlap is parked speed work (`ROADMAP.md` queue 2, the bucket
    overlap). This class exists so that code written for the reference
    finds the name."""


def _host_tree(node):
    """A host copy of an optimizer state tree: its tensors copied to the
    CPU, everything else kept."""
    if isinstance(node, dict):
        return {k: _host_tree(v) for k, v in node.items()}
    if isinstance(node, torch.Tensor):
        return node.detach().to("cpu", copy=True)
    return copy.deepcopy(node)


def _restore_tree(live, saved) -> None:
    """Put `saved` (`_host_tree`'s copy) back into the live tree: into
    its tensors in place (the optimizer and the model keep pointing at
    them), other entries (a step count) set."""
    for k, v in saved.items():
        if isinstance(v, dict):
            _restore_tree(live[k], v)
        elif isinstance(v, torch.Tensor) and isinstance(live.get(k),
                                                       torch.Tensor):
            live[k].copy_(v)
        else:
            live[k] = copy.deepcopy(v)


def _tree_from_host(live, saved, device: torch.device) -> None:
    """Rebind `live`'s tensors to copies of `saved`'s (`_host_tree`'s) on
    `device`, reading nothing of the old ones."""
    for k, v in saved.items():
        if isinstance(v, dict):
            _tree_from_host(live[k], v, device)
        elif isinstance(v, torch.Tensor):
            live[k] = v.to(device, copy=True)
        else:
            live[k] = copy.deepcopy(v)


def _tree_to(node, device: torch.device) -> None:
    """Move an optimizer state tree's tensors to `device`, in place."""
    for k, v in node.items():
        if isinstance(v, dict):
            _tree_to(v, device)
        elif isinstance(v, torch.Tensor):
            node[k] = v.to(device)
