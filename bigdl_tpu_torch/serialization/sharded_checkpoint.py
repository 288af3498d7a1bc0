"""Sharded checkpoints through `torch.distributed.checkpoint` (counterpart
of `bigdl_tpu/serialization/sharded_checkpoint.py`, which writes through
orbax).

Every process of the group takes part in a save, and each writes only its
own shards: a tensor-parallel parameter goes to DCP as a DTensor on the
process mesh (`parallel/mesh.py` `ProcessMesh.device_mesh`) with
placements `[Replicate(), Shard(d)]`, so the ranks of a model group write
its pieces and one data replica's copy is kept; a replicated tensor is
written once. No array passes through one rank. A restore reshards:
`restore_sharded` places each array onto the specs it is given (a DTensor
of this rank's shard), on any mesh shape, or whole; in one process without
a group DCP runs in its no-dist mode.

Layout, the reference's:

    <path>/<tag>/arrays/          DCP: {"tree": {params, slots?, mstate?},
                                  "structure": the tree's keys as JSON}
    <path>/<tag>/optim.json       optim class, scalar state, the names of
                                  the array-valued state, scalar hypers
    <path>/<tag>/optim_state.npz  array-valued optim state, if any
    <path>/<tag>/manifest.json    {format, model, time, tag, "sharded": true}

The arrays are the reference's trees (its paths, conv kernels HWIO; the BN
state's module paths joined by "/"). The tree's keys are kept beside them
because DCP drops empty subtrees. A save is staged in a hidden
`.tmp-<tag>-sharded` directory and renamed into place by rank 0 once the
documents are written, so `checkpoint.py`'s scan (`latest_checkpoint`,
`load_latest_valid`, `prune_checkpoints`) sees only whole checkpoints.
Paths are local: DCP's file system writer takes no `memory://` URI.

The two packages' sharded formats cannot read each other: the card has no
orbax, and JAX cannot read DCP. The JSON documents are the same, key for
key, and a resume follows the same trajectory; the format v2
(`checkpoint.py`) is the one both packages read.
"""

from __future__ import annotations

import io
import json
import os
import time
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from bigdl_tpu_torch.parallel import collectives
from bigdl_tpu_torch.utils import filesystem as fsys

FORMAT_V1 = "bigdl_tpu.checkpoint.v1"


def _local_path(path: str) -> str:
    if fsys.is_uri(path):
        raise ValueError(f"sharded checkpoints are written through "
                         f"torch.distributed.checkpoint to a local path, "
                         f"not {path!r}")
    return os.path.abspath(path)


def _dcp(fn, state, ckpt_dir: str):
    """`dcp.save` or `dcp.load` of `state` at `ckpt_dir`, over the default
    group, or in DCP's no-dist mode without one (its notice that it
    assumes one process silenced: that is the intent here)."""
    no_dist = not collectives.is_initialized()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "torch.distributed is disabled")
        return fn(state, checkpoint_id=ckpt_dir, no_dist=no_dist)


def _skeleton(tree):
    """The keys of a tree of dicts: {key: subtree's keys, or None at a
    leaf}."""
    if isinstance(tree, dict):
        return {str(k): _skeleton(v) for k, v in tree.items()}
    return None


def _fill(skeleton, leaf, path=()):
    """A tree with `skeleton`'s keys and `leaf(path)` at its leaves."""
    if skeleton is None:
        return leaf(path)
    return {k: _fill(v, leaf, path + (k,)) for k, v in skeleton.items()}


def _tensor(x):
    """A leaf as DCP takes it: tensors (and DTensors) as they are, numpy
    arrays and Python numbers as tensors."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def save_sharded(ckpt_dir: str, params) -> str:
    """Write `params`, a tree of dicts whose leaves are tensors, DTensors
    or numpy arrays, through DCP into `ckpt_dir`; every process of the
    group calls it. Returns the directory."""
    import torch.distributed.checkpoint as dcp
    ckpt_dir = _local_path(ckpt_dir)
    state = {"tree": _map(params, _tensor),
             "structure": json.dumps(_skeleton(params))}
    _dcp(dcp.save, state, ckpt_dir)
    return ckpt_dir


def _leaf_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def restore_sharded(ckpt_dir: str, like, mesh=None, specs=None):
    """Read a `save_sharded` tree back onto the structure of `like` (a
    tree of tensors or numpy arrays giving shapes and dtypes). With a
    `ProcessMesh` `mesh` and `specs` (a tree of `PartitionSpec` like
    `like`'s, e.g. `parallel.sharding.infer_param_specs`), a leaf split
    over "model" lands as a DTensor holding only this rank's shard; every
    other leaf is read whole, as a tensor on `like`'s device (the CPU for
    a numpy leaf). Every process of the group calls it."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from bigdl_tpu_torch.parallel.sharding import model_dim

    m = 1 if mesh is None else int(mesh.shape.get("model", 1))

    def target(path):
        leaf = _leaf_at(like, path)
        t = leaf if isinstance(leaf, torch.Tensor) else _tensor(leaf)
        dim = None if specs is None or m == 1 else \
            model_dim(_leaf_at(specs, path))
        if dim is None:
            return torch.empty(t.shape, dtype=t.dtype, device=t.device)
        shape = list(t.shape)
        shape[dim] //= m
        local = torch.empty(shape, dtype=t.dtype, device=mesh.device_type)
        return DTensor.from_local(
            local, mesh.device_mesh, [Replicate(), Shard(dim)],
            run_check=False, shape=t.shape,
            stride=torch.empty(t.shape, device="meta").stride())

    tree = _fill(_skeleton(like), target)
    _dcp(dcp.load, {"tree": tree}, _local_path(ckpt_dir))
    return tree


def _read_metadata(ckpt_dir: str):
    from torch.distributed.checkpoint import FileSystemReader
    return FileSystemReader(ckpt_dir).read_metadata().state_dict_metadata


def _read_as_saved(ckpt_dir: str, meta=None) -> Dict:
    """The tree `save_sharded` wrote, whole, as host tensors (`meta`: its
    DCP metadata, read here by default)."""
    import torch.distributed.checkpoint as dcp
    ckpt_dir = _local_path(ckpt_dir)
    if meta is None:
        meta = _read_metadata(ckpt_dir)
    state = {"structure": ""}
    _dcp(dcp.load, state, ckpt_dir)

    def placeholder(path):
        md = meta[".".join(("tree",) + path)]
        return torch.empty(md.size, dtype=md.properties.dtype)

    state = {"tree": _fill(json.loads(state["structure"]), placeholder)}
    _dcp(dcp.load, state, ckpt_dir)
    return state["tree"]


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array (bf16 widened to f32: numpy has none)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _state_key(path) -> str:
    return "/".join(path)


def _state_path(key: str):
    return tuple(key.split("/")) if key else ()


def save_checkpoint_sharded(path: str, model, params, model_state,
                            optim_method, opt_slots=None,
                            tag: str = "") -> str:
    """The optimizer checkpoint with its arrays written through DCP (see
    the module docstring): every process calls it, with `params` and
    `opt_slots` trees in the reference's layout whose leaves are tensors,
    DTensors (this rank's shards) or numpy arrays, and `model_state` the
    BN state ({module-path tuple: {"mean", "var"}}). Rank 0 writes the
    documents and publishes the directory; the call returns on every rank
    once it is there. Returns the checkpoint directory."""
    from bigdl_tpu_torch.serialization.checkpoint import save_on_rank0

    name = tag or time.strftime("%Y%m%d_%H%M%S")
    root = _local_path(path)
    ckpt_dir = os.path.join(root, name)
    stage = os.path.join(root, f".tmp-{name}-sharded")
    arrays = {"params": params}
    if opt_slots is not None:
        arrays["slots"] = opt_slots
    if model_state:
        arrays["mstate"] = {_state_key(k): v for k, v in model_state.items()}
    device = collectives.flag_device()
    save_on_rank0(lambda: fsys.rmtree(stage) if fsys.exists(stage)
                  else None, device)
    save_sharded(os.path.join(stage, "arrays"), arrays)

    def publish():
        _write_documents(stage, name, model, optim_method)
        displaced = None
        if fsys.exists(ckpt_dir):
            displaced = os.path.join(root, f".replaced-{name}-sharded")
            if fsys.exists(displaced):
                fsys.rmtree(displaced)
            fsys.rename(ckpt_dir, displaced)
        fsys.rename(stage, ckpt_dir)
        if displaced is not None:
            fsys.rmtree(displaced)

    save_on_rank0(publish, device)
    return ckpt_dir


def _write_documents(ckpt_dir: str, name: str, model, optim_method):
    """optim.json, optim_state.npz and manifest.json, with the keys the
    reference writes."""
    state = dict(optim_method.state)
    state_arrays = {k: np.asarray(v) for k, v in state.items()
                    if hasattr(v, "shape") and np.asarray(v).ndim > 0}
    state_scalars = {}
    for k, v in state.items():
        if k in state_arrays:
            continue
        v = v.item() if hasattr(v, "item") else v
        try:
            json.dumps(v)
            state_scalars[k] = v
        except (TypeError, ValueError):
            warnings.warn(
                f"sharded checkpoint: optim state key {k!r} "
                f"({type(v).__name__}) is not JSON/npz-serializable and "
                f"will not survive resume")
    blob_doc = {
        "class": type(optim_method).__name__,
        "state": state_scalars,
        "state_array_keys": sorted(state_arrays),
        "hyper": {k: v for k, v in vars(optim_method).items()
                  if isinstance(v, (int, float, bool, str))},
    }
    with fsys.open_file(os.path.join(ckpt_dir, "optim.json"), "w") as f:
        json.dump(blob_doc, f, indent=2)
    if state_arrays:
        buf = io.BytesIO()
        np.savez(buf, **state_arrays)
        with fsys.open_file(os.path.join(ckpt_dir, "optim_state.npz"),
                            "wb") as f:
            f.write(buf.getvalue())
    manifest = {
        "format": FORMAT_V1,
        "model": getattr(model, "name", "model"),
        "time": time.time(),
        "tag": name,
        "sharded": True,
    }
    with fsys.open_file(os.path.join(ckpt_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def load_checkpoint_sharded(ckpt_dir: str):
    """(params, model_state, optim_blob) of a sharded checkpoint, as saved
    and whole, as numpy trees (the optimizer places them on its mesh), with
    the slots under the blob's "slots": what `checkpoint.load_checkpoint`
    gives for the format v2. Every process of the group calls it, and
    either every one returns or every one raises: what each reads on its
    own (the documents, DCP's metadata) is read first and its outcome
    agreed on (`collectives.any_failed`) before the collective loads,
    which DCP fails on every rank when one fails."""
    arrays_dir = _local_path(os.path.join(ckpt_dir, "arrays"))
    failed = None
    try:
        meta = _read_metadata(arrays_dir)
        with fsys.open_file(os.path.join(ckpt_dir, "optim.json"), "r") as f:
            blob = json.load(f)
        akeys = blob.pop("state_array_keys", [])
        if akeys:
            with fsys.open_file(os.path.join(ckpt_dir, "optim_state.npz"),
                                "rb") as f:
                npz = np.load(io.BytesIO(f.read()))
            blob["state"].update({k: npz[k] for k in akeys})
    except Exception as e:
        failed = e
    if collectives.any_failed(failed is not None):
        raise failed or OSError(f"sharded checkpoint {ckpt_dir} failed to "
                                "load on another rank")
    arrays = _map(_read_as_saved(arrays_dir, meta), _host)
    blob["slots"] = arrays.get("slots")
    mstate = {_state_path(k): v
              for k, v in (arrays.get("mstate") or {}).items()}
    return arrays["params"], mstate, blob
