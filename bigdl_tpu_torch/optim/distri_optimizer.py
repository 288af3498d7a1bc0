"""Synchronous data-parallel training (counterpart of
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

At world size 1 no collective is issued: the step is the local one, run
inside the reference's retry loop (on a failure the error is classified
by the `RetryPolicy`, the loop backs off, reloads the newest valid
checkpoint, or without one restores the host snapshot of the model taken
at the start of the attempt, and trains on). As in the reference, there
is no retry without `set_checkpoint`, and then no snapshot either.

Not ported (`ROADMAP.md` queue 1 item 3): several devices in one process
(`mesh=` or `devices=` naming more than one raises
`NotImplementedError`: start one process per GPU), `sharding_rules`
(tensor parallelism), sharded checkpoints and elastic mode; the overlap
of the gradient buckets with the backward pass.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence

import torch

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.optim.bucketing import GradientBucketPlan
from bigdl_tpu_torch.optim.local_optimizer import BaseOptimizer
from bigdl_tpu_torch.parallel import collectives
from bigdl_tpu_torch.resilience.retry import RetryPolicy

logger = logging.getLogger("bigdl_tpu_torch.optim")


class DistriOptimizer(BaseOptimizer):
    """Data-parallel SGD, one device per process: `mesh` (the reference's
    parameter) or `devices` names this process's device (default: the
    current CUDA device, which `Engine.init` sets to the rank's). The
    ranks are the default process group's. `retry_times` /
    `retry_interval_s` build the default `RetryPolicy(max_retries=
    retry_times, base_delay_s=retry_interval_s)`; `retry_policy`
    replaces it."""

    def __init__(self, model: torch.nn.Module, dataset, criterion,
                 mesh=None, sharding_rules=None, retry_times: int = 5,
                 retry_interval_s: float = 1.0,
                 retry_policy: Optional[RetryPolicy] = None, *,
                 devices: Optional[Sequence] = None):
        if sharding_rules is not None:
            raise NotImplementedError(
                "DistriOptimizer sharding_rules (tensor parallelism) are "
                "not ported (ROADMAP.md queue 1 item 3); pass None")
        if mesh is not None:
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
    def _n_compute_devices(self) -> int:
        """The MFU denominator's device count: the global step runs on
        every rank's device."""
        return self.world

    def _log_suffix(self) -> str:
        return f" ({self.world} ranks)" if self.world > 1 \
            else f" ({len(self.devices)} devices)"

    def _keeps_snapshot(self) -> bool:
        """Only a run that can retry (a checkpoint path is set) needs the
        start-of-attempt snapshot."""
        return self.checkpoint_path is not None

    # -- the data-parallel step ---------------------------------------------

    def _start_attempt(self, params: Dict[str, torch.Tensor]):
        if self.world == 1:
            return
        with torch.no_grad():
            for t in self.model.state_dict().values():
                collectives.broadcast_(t, 0)
        self.bucket_plan = GradientBucketPlan(params, self._bucket_bytes)

    def _step_scope(self):
        return collectives.data_parallel_step(self.world)

    def _step_generator(self):
        if self.world == 1:
            return self.generator

        def rank_generator():
            seed = int(torch.randint(
                0, 2 ** 62, (1,), generator=self.generator,
                device=self.generator.device))
            mixed = (seed ^ (collectives.rank() * 0x9E3779B97F4A7C15)) \
                % 2 ** 63
            return torch.Generator(self.device).manual_seed(mixed)

        return rank_generator

    def _reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.world == 1:
            return grads
        plan = self.bucket_plan or GradientBucketPlan(
            dict(self.model.named_parameters()), self._bucket_bytes)
        return collectives.bucket_all_reduce_mean(grads, plan.buckets,
                                                  self.world)

    def _synced_loss(self, loss: torch.Tensor) -> float:
        if self.world == 1:
            return float(loss)
        t = loss.detach().float().reshape(1).clone()
        return float(collectives.all_reduce_(t, "loss")) / self.world

    def _epoch_size(self) -> int:
        num_hosts = getattr(self.dataset, "num_hosts", 1)
        return getattr(self.dataset, "global_size", None) or \
            self.dataset.size() * num_hosts

    def _records(self, batch) -> int:
        return batch.size() * getattr(self.dataset, "num_hosts", 1)

    def _save_checkpoint(self, opt_state, tag: str):
        from bigdl_tpu_torch.serialization.checkpoint import save_on_rank0
        save_on_rank0(lambda: super(DistriOptimizer, self)._save_checkpoint(
            opt_state, tag), self.device)
        if collectives.rank() != 0:
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
                self._restore_pristine()
                raise
            except Exception as e:
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
                    self._restore_pristine()
                    raise
                logger.warning(
                    f"Optimization failed ({e!r}); retry {attempt}/"
                    f"{policy.max_retries} from latest checkpoint in "
                    f"{delay:.3f}s")
                if not self.resume_from_latest_checkpoint():
                    # failed before the first checkpoint: start again from
                    # the model as this attempt found it
                    self._restore_pristine()
                backoff_spent += delay
                if delay > 0:
                    policy.sleep(delay)
