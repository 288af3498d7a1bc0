"""The collectives of synchronous data-parallel training over
`torch.distributed`, one process per device (port-only: the JAX package
has no counterpart, because XLA inserts its all-reduces into the SPMD
step).

- `world_size()` / `rank()`: of the default process group; 1 and 0
  without one.
- `all_reduce_sum(x, kind)`: a differentiable sum over the ranks. The
  forward sums x, the backward sums the incoming gradient (the adjoint of
  a sum that every rank reads), as SyncBatchNorm's does.
- `all_reduce_(t, kind)`, `broadcast_(t, src)`, `barrier()`: in place,
  no gradient.
- `data_parallel_step(world)`: the scope of one data-parallel training
  step. Only inside it do the BN layers take their statistics over the
  global batch and the criteria with a data-dependent denominator divide
  by the global one (`step_world()`, `dp_denominator`); the optimizer
  opens it around its step, so no flag leaks into evaluation or serving.

At world size 1 (or outside a step) nothing is issued, as the
reference's one-device mesh uses plain placement. A `meta` tensor (a
FLOP count) is never sent. Every collective is counted by kind in
`counts` (calls, and bytes under `"<kind>_bytes"`), and any failure in
one is raised as `CollectiveError`, which the retry policy classes as
permanent: a peer that is gone is not retried into.
"""

from __future__ import annotations

import collections
import contextlib
import datetime
from typing import List, Sequence

import torch
import torch.distributed as dist

#: collectives issued, by kind ("grad", "bn", "loss", "denominator",
#: "broadcast", "flag"), and the bytes of each under "<kind>_bytes"
counts: collections.Counter = collections.Counter()

#: seconds a rank waits on its peers outside a collective (the agreement
#: after a failure); `Engine.init` sets it to the process group's timeout
timeout_s: float = 600.0

# the world sizes of the data-parallel steps being run, innermost last
_STEPS: List[int] = []


class CollectiveError(RuntimeError):
    """A collective failed: a peer died, timed out or disagreed."""


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the default process group; 1 without one."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    """This process's rank in the default process group; 0 without one."""
    return dist.get_rank() if is_initialized() else 0


def reset_counts() -> None:
    counts.clear()


def _run(what: str, fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs)
    except Exception as e:
        raise CollectiveError(
            f"{what} failed on rank {rank()} of {world_size()}: {e}") from e


def all_reduce_(t: torch.Tensor, kind: str) -> torch.Tensor:
    """Sum `t` over the ranks, in place; returns it."""
    if world_size() == 1 or t.device.type == "meta":
        return t
    counts[kind] += 1
    counts[kind + "_bytes"] += t.numel() * t.element_size()
    _run(f"all_reduce ({kind})", dist.all_reduce, t)
    return t


def broadcast_(t: torch.Tensor, src: int = 0,
               kind: str = "broadcast") -> torch.Tensor:
    """Overwrite `t` with rank `src`'s, in place; returns it."""
    if world_size() == 1 or t.device.type == "meta":
        return t
    counts[kind] += 1
    counts[kind + "_bytes"] += t.numel() * t.element_size()
    _run(f"broadcast ({kind})", dist.broadcast, t, src)
    return t


def barrier() -> None:
    if world_size() > 1:
        _run("barrier", dist.barrier)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind = kind
        return all_reduce_(x.clone(), kind)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.kind), None


def all_reduce_sum(x: torch.Tensor, kind: str) -> torch.Tensor:
    """x summed over the ranks, differentiably; x itself at world 1."""
    if world_size() == 1 or x.device.type == "meta":
        return x
    return _AllReduceSum.apply(x, kind)


@contextlib.contextmanager
def data_parallel_step(world: int):
    """The block is one training step of a data-parallel run over `world`
    ranks."""
    _STEPS.append(int(world))
    try:
        yield
    finally:
        _STEPS.pop()


def step_world() -> int:
    """World size of the data-parallel step being run; 1 outside one."""
    return _STEPS[-1] if _STEPS else 1


def dp_denominator(d: torch.Tensor, min_value=None) -> torch.Tensor:
    """This rank's share of a loss's global denominator: `d` (a count or
    a sum of weights, without gradient) summed over the ranks of the
    data-parallel step, at least `min_value`, over the world size. A
    rank's loss divided by it averages over the ranks to the global
    batch's loss. Outside a step: `d`, at least `min_value`."""
    world = step_world()
    if world > 1:
        d = all_reduce_(d.detach().clone(), "denominator")
    if min_value is not None:
        d = torch.clamp(d, min=min_value)
    return d if world == 1 else d / world


def agree(key: str, value: str) -> bool:
    """Whether every rank posts the same `value` under `key` within
    `timeout_s`, through the process group's store (outside any
    collective, so a rank blocked in one simply never posts). False when
    a rank is missing or differs, or the store is gone."""
    if world_size() == 1:
        return True
    store = dist.distributed_c10d._get_default_store()
    keys = [f"bigdl_tpu_torch/{key}/{r}" for r in range(world_size())]
    try:
        store.set(keys[rank()], value)
        store.wait(keys, datetime.timedelta(seconds=timeout_s))
        return all(store.get(k).decode() == value for k in keys)
    except Exception:
        return False


def bucket_all_reduce_mean(grads: Sequence[torch.Tensor], buckets,
                           world: int) -> List[torch.Tensor]:
    """`grads` averaged over `world` ranks, one all-reduce a bucket: each
    bucket (a tuple of indices into `grads`, one dtype) is flattened into
    one contiguous buffer, summed, divided by `world` and split back into
    views of it."""
    out = list(grads)
    for bucket in buckets:
        flat = torch.cat([grads[i].reshape(-1) for i in bucket])
        all_reduce_(flat, "grad").div_(world)
        offset = 0
        for i in bucket:
            n = grads[i].numel()
            out[i] = flat[offset:offset + n].view(grads[i].shape)
            offset += n
    return out
