"""Synchronous data-parallel training (counterpart of
`bigdl_tpu/optim/distri_optimizer.py`), on one device so far.

On one device the reference's SPMD step degenerates to the local step:
the batch is not split across devices, no gradient all-reduce runs, and
every sharding spec is replicated. So the port's `DistriOptimizer` runs
`BaseOptimizer`'s step (gradient accumulation and clipping included) and
loop on its one device, inside the reference's retry loop: on a failure
the error is classified by the `RetryPolicy`, the loop backs off, reloads
the newest valid checkpoint and trains on; with no checkpoint yet, it
restores the host snapshot of the model taken at the start of the
attempt (the steps update the model in place, so a failed attempt leaves
it half updated). A reloaded checkpoint also puts back the step
generator's state committed with it, so the retried steps draw the
dropout masks of the unfaulted run. As in the reference, there is no
retry without `set_checkpoint`: then no snapshot is taken either (it
would cost a host copy of the model at every `optimize()`), and a
failure leaves the model where the failed step left it.

Not ported: several devices (data parallel over `torch.distributed`,
`ROADMAP.md` queue 1 item 3; asking for them raises
`NotImplementedError`), `sharding_rules` (tensor parallelism; anything
but None raises), elastic mode and gradient bucketing.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Sequence

import torch

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.optim.local_optimizer import BaseOptimizer
from bigdl_tpu_torch.resilience.retry import RetryPolicy

logger = logging.getLogger("bigdl_tpu_torch.optim")


class DistriOptimizer(BaseOptimizer):
    """Data-parallel SGD over the devices of `mesh` (the reference's
    parameter) or `devices` (default: the one CUDA device); only a single
    device is supported yet. `retry_times` / `retry_interval_s` build the
    default `RetryPolicy(max_retries=retry_times,
    base_delay_s=retry_interval_s)`; `retry_policy` replaces it."""

    def __init__(self, model: torch.nn.Module, dataset, criterion,
                 mesh=None, sharding_rules=None, retry_times: int = 5,
                 retry_interval_s: float = 1.0,
                 retry_policy: Optional[RetryPolicy] = None, *,
                 devices: Optional[Sequence] = None):
        if sharding_rules is not None:
            raise NotImplementedError(
                "DistriOptimizer sharding_rules (tensor parallelism) are "
                "not ported; pass None")
        if mesh is not None:
            if devices is not None:
                raise ValueError("pass mesh or devices, not both")
            devices = list(mesh.devices.ravel())
        devices = [resolve_device(d) for d in (devices or [None])]
        if len(devices) != 1:
            raise NotImplementedError(
                f"DistriOptimizer over {len(devices)} devices is not ported "
                "yet (ROADMAP.md queue 1 item 3, multi-GPU data parallel); "
                "pass one device")
        super().__init__(model, dataset, criterion, device=devices[0])
        self.devices = devices
        self.retry_times = retry_times
        self.retry_interval_s = retry_interval_s
        self.retry_policy = retry_policy

    def _log_suffix(self) -> str:
        return f" ({len(self.devices)} devices)"

    def _keeps_snapshot(self) -> bool:
        """Only a run that can retry (a checkpoint path is set) needs the
        start-of-attempt snapshot."""
        return self.checkpoint_path is not None

    def _retry_policy(self) -> RetryPolicy:
        """The policy passed in, else the default built from retry_times
        and retry_interval_s."""
        if self.retry_policy is None:
            self.retry_policy = RetryPolicy(
                max_retries=self.retry_times,
                base_delay_s=self.retry_interval_s,
                name="distri_optimizer")
        return self.retry_policy

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
                if delay is None:
                    # a permanent error, retries used up, the budget gone,
                    # or nothing to reload from
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
