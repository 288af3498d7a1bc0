"""Parameter sharding rules and tensor-parallel placement (counterpart of
`bigdl_tpu/parallel/sharding.py`).

The rules are the reference's, kept here as the port's own copy: a
parameter's path in the reference's tree of the model, and its shape in
the reference's layout, decide its `PartitionSpec` on the "model" axis:
  Linear weight (in, out)        -> P(None, 'model')   (column parallel)
  Conv kernel HWIO               -> P(None, None, None, 'model')
  Embedding table (vocab, dim)   -> P('model', None)   (row/vocab parallel)
  biases / norms / scalars       -> replicated
and a dimension below `min_shard_dim`, or one the axis does not divide,
stays replicated. `infer_param_specs` runs them on the reference's tree of
a port model (`interop.jax_params`: the reference's paths, conv kernels
HWIO) and returns specs in that layout; `param_specs` translates them to
the port's layout, keyed by parameter name (a conv weight is OIHW in the
port, so HWIO dim 3 is dim 0; `Linear` keeps (in, out) and an embedding
table (vocab, dim)).

The reference places the parameters with `NamedSharding` and lets XLA
insert the all-gathers. The port does it with explicit collectives, one
process per device (`ShardedParameters`, which `DistriOptimizer` uses on a
`ProcessMesh` with a model axis): each rank's module holds only its shard
of every sharded parameter (a `Parameter` of the shard's shape, under the
parameter's own name), so the optimizer's f32 masters and slots are built
from the shard; the step gathers each whole parameter over the model
group (`collectives.all_gather`), and the backward gives the rank its own
slice of the whole parameter's gradient. The compute is the dense step's,
replicated across a model group.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from bigdl_tpu_torch.parallel import collectives


#: HWIO dimension of each OIHW dimension of a conv weight
_OIHW_TO_HWIO = (3, 2, 0, 1)


class PartitionSpec(tuple):
    """Which mesh axis each dimension of a tensor is split over (None:
    replicated), as `jax.sharding.PartitionSpec`; trailing dimensions left
    out are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec


def model_dim(spec) -> Optional[int]:
    """The dimension `spec` splits over the "model" axis, or None."""
    return spec.index("model") if "model" in spec else None


class ShardingRules:
    """Name/shape-driven parameter placement policy for the 'model' axis.

        >>> from bigdl_tpu_torch.parallel.sharding import ShardingRules
        >>> rules = ShardingRules(min_shard_dim=256)
        >>> rules.spec_for(("fc", "weight"), (512, 512), model_axis_size=2)
        PartitionSpec(None, 'model')
        >>> rules.spec_for(("fc", "bias"), (512,), model_axis_size=2)
        PartitionSpec()
        >>> rules.spec_for(("fc", "weight"), (512, 512), model_axis_size=1)
        PartitionSpec()
    """

    def __init__(self, min_shard_dim: int = 256,
                 shard_embeddings: bool = True):
        self.min_shard_dim = min_shard_dim
        self.shard_embeddings = shard_embeddings

    def spec_for(self, path: Tuple[str, ...], shape: Tuple[int, ...],
                 model_axis_size: int) -> PartitionSpec:
        """The spec of the parameter at `path` (the reference's tree
        keys) with `shape` (the reference's layout)."""
        if model_axis_size <= 1:
            return P()
        leaf = path[-1] if path else ""
        nd = len(shape)
        if leaf in ("bias", "mean", "var", "b_rz", "b_n") or nd <= 1:
            return P()

        def ok(dim):
            return shape[dim] >= self.min_shard_dim \
                and shape[dim] % model_axis_size == 0

        lower = [p.lower() for p in path]
        is_embed = any("lookup" in p or "embed" in p for p in lower)
        if nd == 2:
            if is_embed and self.shard_embeddings and ok(0):
                return P("model", None)
            if ok(1):
                return P(None, "model")  # column-parallel linear
            return P()
        if nd == 4 and ok(3):  # HWIO conv kernel: shard output channels
            return P(None, None, None, "model")
        if nd == 3 and ok(2):
            return P(None, None, "model")
        return P()


def _model_axis_size(mesh) -> int:
    return int(mesh.shape.get("model", 1))


def _map_tree(tree, fn, path=()):
    """`fn(path, leaf)` over the leaves of nested dicts, lists and tuples
    (paths of string keys, as the reference's tree paths print)."""
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, path + (str(k),)) for k, v in
                tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def infer_param_specs(params, mesh, rules: Optional[ShardingRules] = None):
    """A tree of `PartitionSpec` matching `params`, in the reference's
    layout: `params` is a tree in that layout (nested dicts of anything
    with a `.shape`), or a port model, whose reference tree
    (`interop.params_tree`'s paths, conv kernels HWIO) is used. `mesh` is
    any mesh with a `.shape` dict (`ProcessMesh`, `Mesh`)."""
    from bigdl_tpu_torch.interop.jax_params import _tree_targets
    rules = rules or ShardingRules()
    m = _model_axis_size(mesh)
    if isinstance(params, torch.nn.Module):
        params = _tree_targets(params)
    return _map_tree(params, lambda path, leaf: rules.spec_for(
        path, tuple(leaf.shape), m))


def _targets_by_name(model):
    """(name, JAX-layout path, JAX-layout shape, parameter, is conv
    weight) of each of the model's parameters, walking the reference's
    tree."""
    from bigdl_tpu_torch.interop.jax_params import (_HwioToOihw,
                                                    _param_names,
                                                    _tree_targets)
    names = _param_names(model)
    out = []

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (str(k),))
                continue
            conv = isinstance(v, _HwioToOihw)
            p = v.param if conv else v
            out.append((names[id(p)], path + (str(k),), tuple(v.shape), p,
                        conv))

    walk(_tree_targets(model), ())
    return out


def param_specs(model, mesh, rules: Optional[ShardingRules] = None
                ) -> Dict[str, PartitionSpec]:
    """{parameter name: `PartitionSpec` in the port's layout} of every
    parameter of `model`: the reference's rule on its path and reference
    shape, translated (a conv weight's HWIO spec to OIHW). Sharded specs
    name every dimension; replicated ones are `PartitionSpec()`."""
    rules = rules or ShardingRules()
    m = _model_axis_size(mesh)
    out = {}
    for name, path, ref_shape, p, conv in _targets_by_name(model):
        dim = model_dim(rules.spec_for(path, ref_shape, m))
        if dim is None:
            out[name] = P()
            continue
        if conv:
            dim = _OIHW_TO_HWIO.index(dim)
        out[name] = P(*("model" if d == dim else None
                        for d in range(p.dim())))
    return out


def _shard(t: torch.Tensor, dim: int, index: int, m: int) -> torch.Tensor:
    n = t.shape[dim] // m
    return t.narrow(dim, index * n, n)


def shard_params(params, mesh, rules: Optional[ShardingRules] = None, *,
                 index: Optional[int] = None):
    """(shards, specs) of the port model `params`: {parameter name: its
    slice at model index `index` (default: this rank's on a
    `ProcessMesh`, else 0), a view} and `param_specs`. A replicated
    parameter's shard is the parameter."""
    specs = param_specs(params, mesh, rules)
    m = _model_axis_size(mesh)
    if index is None:
        index = getattr(mesh, "model_index", 0)
    shards = {}
    for name, p in params.named_parameters():
        dim = model_dim(specs[name])
        t = p.detach()
        shards[name] = t if dim is None else _shard(t, dim, index, m)
    return shards, specs


class ShardedParameters:
    """The tensor-parallel placement of `model`'s parameters on the
    `ProcessMesh` `mesh` by `specs` (`param_specs`): `place()` swaps each
    sharded parameter for a `Parameter` of this rank's shard, under the
    same name; `full_params` gathers them for a forward; `unplace()` puts
    whole parameters back. Names, and so checkpoints and interop, stay the
    reference's."""

    def __init__(self, model, mesh, specs: Dict[str, PartitionSpec]):
        self.model, self.mesh = model, mesh
        self.group = mesh.model_group
        self.m, self.index = mesh.shape["model"], mesh.model_index
        #: sharded parameter name -> the dimension split over "model"
        self.dims = {n: model_dim(s) for n, s in specs.items()
                     if model_dim(s) is not None}
        self.full_shapes: Dict[str, Tuple[int, ...]] = {}

    def _owner(self, name: str):
        prefix, _, leaf = name.rpartition(".")
        return self.model.get_submodule(prefix), leaf

    def _swap(self, name: str, data: torch.Tensor):
        mod, leaf = self._owner(name)
        old = mod._parameters[leaf]
        mod._parameters[leaf] = torch.nn.Parameter(
            data, requires_grad=old.requires_grad)

    def shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor `t` of parameter `name`
        (a view)."""
        return _shard(t, self.dims[name], self.index, self.m)

    def place(self) -> None:
        """Keep only this rank's shard of each sharded parameter."""
        for name in self.dims:
            mod, leaf = self._owner(name)
            p = mod._parameters[leaf]
            self.full_shapes[name] = tuple(p.shape)
            self._swap(name, self.shard(name, p.detach()).clone())

    def gather(self, name: str, t: torch.Tensor,
               kind: str = "gather") -> torch.Tensor:
        """The whole tensor of parameter `name` from every rank's shard
        `t`, over the model group (differentiable), counted as `kind`."""
        return collectives.all_gather(t, self.dims[name], self.group, kind)

    def full_params(self, tensors: Dict[str, torch.Tensor],
                    kind: str = "gather") -> Dict[str, torch.Tensor]:
        """`tensors` (keyed by parameter name: the shards, or their
        casts) with every sharded one gathered whole: "gather" a forward's,
        "unshard" the gathers outside the steps (checkpoints, the end of a
        run)."""
        return {n: self.gather(n, t, kind) if n in self.dims else t
                for n, t in tensors.items()}

    def unplace(self, gather: bool = True) -> None:
        """Put whole parameters back: gathered over the model group, or,
        with `gather=False` (after a failure, when a peer may be gone),
        this rank's shard in place and zeros elsewhere, for the caller to
        overwrite with the start-of-run snapshot."""
        for name in self.dims:
            mod, leaf = self._owner(name)
            shard = mod._parameters[leaf].detach()
            with torch.no_grad():
                if gather:
                    full = self.gather(name, shard, "unshard")
                else:
                    full = shard.new_zeros(self.full_shapes[name])
                    self.shard(name, full).copy_(shard)
            self._swap(name, full)

    def _named_dicts(self, node, fn):
        """`fn(name, tensor)` over every dict keyed by parameter names in
        `node` (an optimizer state tree); other leaves as they are."""
        if isinstance(node, dict):
            names = {n for n, _ in self.model.named_parameters()}
            if node and set(node) <= names:
                return {k: fn(k, v) if k in self.dims else v
                        for k, v in node.items()}
            return {k: self._named_dicts(v, fn) for k, v in node.items()}
        return node

    def shard_tree(self, node):
        """An optimizer state tree of whole tensors (a resumed run's slots)
        with this rank's shard of each sharded parameter's entries."""
        return self._named_dicts(
            node, lambda n, t: self.shard(n, t).clone()
            if tuple(t.shape) == self.full_shapes[n] else t)

    def to_dtensor(self, name: str, t: torch.Tensor, conv: bool):
        """This rank's shard `t` of parameter `name` (or of its slot), in
        the reference's layout (`conv`: a conv weight's shard permuted to
        HWIO), as a DTensor on the mesh: replicated over "data", split
        over "model"."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        dim, full = self.dims[name], list(self.full_shapes[name])
        if conv:
            full = [full[_OIHW_TO_HWIO.index(d)] for d in range(4)]
            dim = _OIHW_TO_HWIO[dim]
        return DTensor.from_local(
            t.detach().contiguous(), self.mesh.device_mesh,
            [Replicate(), Shard(dim)], run_check=False,
            shape=torch.Size(full),
            stride=torch.empty(full, device="meta").stride())

    def gather_tree(self, node):
        """An optimizer state tree with every sharded parameter's entries
        gathered whole (every rank of the model group must call it)."""
        with torch.no_grad():
            return self._named_dicts(
                node, lambda n, t: self.gather(n, t, "unshard"))


def stored_bytes(model, opt_state=None) -> int:
    """Bytes this process holds of `model`'s parameters (its shards, once
    placed), plus of `opt_state`'s tensors."""
    return _tensor_bytes(list(model.parameters())) + \
        _tensor_bytes(opt_state)


def _tensor_bytes(tree: Any) -> int:
    """Bytes of every tensor in a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0
