"""The collectives of data- and tensor-parallel training over
`torch.distributed`, one process per device (port-only: the JAX package
has no counterpart, because XLA inserts its all-reduces and all-gathers
into the SPMD step).

- `world_size()` / `rank()`: of the default process group; 1 and 0
  without one.
- `Group`: a subgroup of the ranks (a data or model group of a process
  mesh, `parallel/mesh.py`); `group=None` is the whole world. Nothing is
  issued over a group of one rank.
- `all_reduce_sum(x, kind)`: a differentiable sum over the ranks of the
  data-parallel step's group. The forward sums x, the backward sums the
  incoming gradient (the adjoint of a sum that every rank reads), as
  SyncBatchNorm's does.
- `all_gather(x, dim, group, kind)`: the shards of a tensor over a model
  group, concatenated along `dim`, differentiably. Every rank of the
  group reads the whole tensor and computes the same loss on the same
  data, so the adjoint is this rank's slice of the incoming gradient,
  not a sum over the group.
- `all_reduce_(t, kind, group)`, `broadcast_(t, src)`, `barrier()`: in
  place, no gradient; `broadcast_object(obj, src)`.
- `data_parallel_step(world, group)`: the scope of one data-parallel
  training step over `world` data replicas (the ranks of `group`). Only
  inside it do the BN layers take their statistics over the global batch
  and the criteria with a data-dependent denominator divide by the global
  one (`step_world()`, `step_group()`, `dp_denominator`); the optimizer
  opens it around its step, so no flag leaks into evaluation or serving.
- `tensor_parallel_step(names, group)`: the scope of a step whose
  parameters `names` are stored as shards over the ranks of `group`;
  inside it `whole_norms` gives those parameters' norms as the whole
  tensors', as the optimization methods that reduce over a tensor
  (`LAMB`) need them.
- `any_failed(failed)`: one all-reduced flag, so that every rank takes
  the same branch after a step that may fail on some ranks alone.

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
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: collectives issued, by kind ("grad", "bn", "loss", "denominator",
#: "broadcast", "flag", "clip", "norm"; all-gathers: "gather" in a step's
#: forward, "unshard" outside the steps), and the bytes of each under
#: "<kind>_bytes" (an all-gather counts the whole gathered tensor)
counts: collections.Counter = collections.Counter()

#: seconds a rank waits on its peers outside a collective (the agreement
#: after a failure); `Engine.init` sets it to the process group's timeout
timeout_s: float = 600.0

# the (world size, group) of the data-parallel steps being run, innermost
# last
_STEPS: List[Tuple[int, Optional["Group"]]] = []

# the (sharded parameter names, model group) of the tensor-parallel steps
# being run, innermost last
_SHARDS: List[Tuple[frozenset, "Group"]] = []


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


class Group:
    """Ranks of the default process group that issue collectives together:
    `ranks` (global ranks, in order), `pg` the torch process group (None:
    the default group, when `ranks` is the whole world). `index` is this
    rank's position in `ranks`."""

    def __init__(self, ranks: Sequence[int], pg=None):
        self.ranks = tuple(int(r) for r in ranks)
        self.pg = pg

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def index(self) -> int:
        return self.ranks.index(rank())


def _size(group: Optional[Group]) -> int:
    return world_size() if group is None else group.size


def _pg(group: Optional[Group]):
    return None if group is None else group.pg


def _run(what: str, fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs)
    except Exception as e:
        raise CollectiveError(
            f"{what} failed on rank {rank()} of {world_size()}: {e}") from e


def all_reduce_(t: torch.Tensor, kind: str,
                group: Optional[Group] = None) -> torch.Tensor:
    """Sum `t` over the ranks of `group` (default: every rank), in place;
    returns it."""
    if _size(group) == 1 or t.device.type == "meta":
        return t
    counts[kind] += 1
    counts[kind + "_bytes"] += t.numel() * t.element_size()
    _run(f"all_reduce ({kind})", dist.all_reduce, t, group=_pg(group))
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


def broadcast_object(obj, src: int = 0, kind: str = "broadcast"):
    """Rank `src`'s `obj` (any picklable object) on every rank."""
    if world_size() == 1:
        return obj
    counts[kind] += 1
    box = [obj]
    _run(f"broadcast_object ({kind})", dist.broadcast_object_list, box, src)
    return box[0]


def flag_device() -> torch.device:
    """Where a control tensor (a success flag) goes for the default group's
    backend: the current CUDA device under NCCL, else the CPU."""
    if is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def any_failed(failed: bool) -> bool:
    """Whether this rank or any other of the default group `failed`: one
    flag all-reduced (kind "flag") that every rank issues at the same
    point; `failed` itself at world size 1."""
    if world_size() == 1:
        return failed
    flag = torch.tensor([1.0 if failed else 0.0], device=flag_device())
    all_reduce_(flag, "flag")
    return float(flag) > 0


def barrier() -> None:
    if world_size() > 1:
        _run("barrier", dist.barrier)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kind, group):
        ctx.kind, ctx.group = kind, group
        return all_reduce_(x.clone(), kind, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.kind, ctx.group), None, None


def all_reduce_sum(x: torch.Tensor, kind: str) -> torch.Tensor:
    """x summed over the ranks of the data-parallel step's group (every
    rank outside a step), differentiably; x itself over one rank."""
    group = step_group()
    if _size(group) == 1 or x.device.type == "meta":
        return x
    return _AllReduceSum.apply(x, kind, group)


def _gather_parts(t: torch.Tensor, group: Group) -> List[torch.Tensor]:
    """Every rank's `t` over `group`, in its order. gloo gathers CUDA
    tensors through host copies (its own CUDA path stages the same
    way)."""
    staged = t.device.type == "cuda" and \
        dist.get_backend(group.pg) == "gloo"
    src = (t.cpu() if staged else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(group.size)]
    _run("all_gather (gather)", dist.all_gather, parts, src, group=group.pg)
    return [p.to(t.device) for p in parts] if staged else parts


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, kind):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        out = torch.cat(_gather_parts(x, group), dim)
        counts[kind] += 1
        counts[kind + "_bytes"] += out.numel() * out.element_size()
        return out

    @staticmethod
    def backward(ctx, g):
        mine = g.narrow(ctx.dim, ctx.group.index * ctx.n, ctx.n)
        return mine.contiguous(), None, None, None


def all_gather(x: torch.Tensor, dim: int, group: Group,
               kind: str = "gather") -> torch.Tensor:
    """The shards `x` of the ranks of `group`, concatenated along `dim` in
    the group's order, differentiably: the gradient of this rank's shard
    is its own slice of the whole tensor's gradient (every rank of the
    group computed the same loss, so nothing is summed). x itself over
    one rank or on the meta device (a FLOP count: the whole tensor's shape
    is the caller's)."""
    if group.size == 1 or x.device.type == "meta":
        return x
    return _AllGather.apply(x, dim, group, kind)


@contextlib.contextmanager
def data_parallel_step(world: int, group: Optional[Group] = None):
    """The block is one training step of a data-parallel run over `world`
    data replicas, the ranks of `group` (default: every rank)."""
    _STEPS.append((int(world), group))
    try:
        yield
    finally:
        _STEPS.pop()


def step_world() -> int:
    """Data replicas of the data-parallel step being run; 1 outside
    one."""
    return _STEPS[-1][0] if _STEPS else 1


def step_group() -> Optional[Group]:
    """The group of the data-parallel step being run (None: every
    rank)."""
    return _STEPS[-1][1] if _STEPS else None


def dp_denominator(d: torch.Tensor, min_value=None) -> torch.Tensor:
    """This rank's share of a loss's global denominator: `d` (a count or
    a sum of weights, without gradient) summed over the ranks of the
    data-parallel step, at least `min_value`, over the world size. A
    rank's loss divided by it averages over the ranks to the global
    batch's loss. Outside a step: `d`, at least `min_value`."""
    world = step_world()
    if world > 1:
        d = all_reduce_(d.detach().clone(), "denominator", step_group())
    if min_value is not None:
        d = torch.clamp(d, min=min_value)
    return d if world == 1 else d / world


@contextlib.contextmanager
def tensor_parallel_step(names, group: Group):
    """The block is one training step in which the parameters named in
    `names` are stored as shards over the ranks of `group` (a model
    group); `whole_norms` reads it."""
    _SHARDS.append((frozenset(names), group))
    try:
        yield
    finally:
        _SHARDS.pop()


def whole_norms(tensors: Dict[str, Sequence[torch.Tensor]]
                ) -> Dict[str, List[torch.Tensor]]:
    """The L2 norm of each tensor in `tensors[name]`, as the whole
    parameter `name`'s: inside a tensor-parallel step the tensors of a
    sharded parameter are this rank's shards, and their squared norms are
    summed over the model group, all of them in one all-reduce (kind
    "norm"); any other tensor's is `torch.linalg.vector_norm`."""
    names, group = _SHARDS[-1] if _SHARDS else (frozenset(), None)
    split = [k for k in tensors if k in names and group.size > 1]
    out = {k: [torch.linalg.vector_norm(t) for t in ts]
           for k, ts in tensors.items() if k not in split}
    if split:
        sq = torch.stack([torch.sum(t.float() ** 2)
                          for k in split for t in tensors[k]])
        sq = all_reduce_(sq, "norm", group).sqrt()
        i = 0
        for k in split:
            out[k] = list(sq[i:i + len(tensors[k])])
            i += len(tensors[k])
    return out


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
                           world: int, group: Optional[Group] = None
                           ) -> List[torch.Tensor]:
    """`grads` averaged over the `world` ranks of `group` (default: every
    rank), one all-reduce a bucket: each bucket (a tuple of indices into
    `grads`, one dtype) is flattened into one contiguous buffer, summed,
    divided by `world` and split back into views of it."""
    out = list(grads)
    for bucket in buckets:
        flat = torch.cat([grads[i].reshape(-1) for i in bucket])
        all_reduce_(flat, "grad", group).div_(world)
        offset = 0
        for i in bucket:
            n = grads[i].numel()
            out[i] = flat[offset:offset + n].view(grads[i].shape)
            offset += n
    return out
