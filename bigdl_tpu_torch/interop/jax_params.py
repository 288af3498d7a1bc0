"""Carry JAX parameter trees into the port's models, and back.

`load_transformer_lm_params` fills a `TransformerLM` and
`lm_params_tree` gives its parameters or gradients back;
`load_module_params` fills any model built from the port's containers
(the ResNets, the zoo, the recurrent models, `WideAndDeep` with its
children `wide`, `embed0`, ... and `deep` at the JAX tree's keys) from
the JAX params tree and BN state, and
`module_params_tree` / `module_state` give the port's parameters,
gradients and running stats back in the JAX layout. `params_tree` and
`load_params` pick the right one of the two for a model, and
`tree_from_named` / `named_from_tree` carry any tensors keyed by the
port's parameter names (an optimizer's slots) to the JAX layout and back:
checkpoints go through these four. The pipelines carry as the JAX
package's own trees: `load_gpipe_params` / `gpipe_params_tree` slice and
stack `GPipe.init`'s leading stage axis over the S stage copies, and
`load_pipeline_params` / `pipeline_params_tree` carry
`PipelineStages.init`'s per-stage list (and `train_step_1f1b`'s
per-stage gradients back) through `load_module_params` /
`tree_from_named` on each stage. A `MoE` needs nothing of its own: its
parameters `router`, `w1`, `b1`, `w2`, `b2` are `MoE.init`'s keys, so
`load_module_params` and `module_params_tree` carry it. A quantized
model (`nn/quantized.py`) carries the same way: its int8 weights keep
the JAX layout (HWIO, [in, out]) and are copied as they are, and come
back as int8.

A `Graph` keys its nodes `"<module name>_<id>"` from a per-package,
per-process counter, so the JAX twin of a port graph has other keys.
`load_module_params` pairs a graph's nodes with the tree's entries by
position: the JAX tree's dict order is its `exec_order` (`Container.init`
fills it so), as the port's registration order is. Each pair's module
names (the key without its id) must agree, and each leaf's shape; a
mismatch raises. `module_params_tree(model, like=tree)` and
`module_state(model, like=tree)` give the port's tensors under the keys of
`tree` (a JAX parameter tree, its leaves unused) the same way. A tree
whose dicts were rebuilt in sorted key order (`jax.tree_util.tree_map`
does so) no longer lists a graph in `exec_order`: convert its leaves with
a dict comprehension.

The trees are the JAX package's nested dicts, with their leaves converted
by the caller to numpy arrays (`np.asarray`), so nothing here needs JAX.
The `TransformerLM` tree:

    {"embed": [V, E], "head": [E, V],
     "block{i}": {"attn": {"wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo"},
                  "ln1": {"weight", "bias"}, "ln2": {"weight", "bias"},
                  "w1", "b1", "w2", "b2"}}

Layout rule: the port keeps the JAX `[in, out]` projection layout as raw
parameters and computes `x @ W`, so every leaf is copied as it is, with no
transpose.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def _targets(model) -> Dict:
    """The port's parameters arranged as the JAX tree."""
    out = {"embed": model.embed, "head": model.head}
    for i, blk in enumerate(model.blocks):
        attn = {n: getattr(blk.attn, n) for n in ("wq", "wk", "wv", "wo")}
        if blk.attn.with_bias:
            attn.update({n: getattr(blk.attn, n)
                         for n in ("bq", "bk", "bv", "bo")})
        out[f"block{i}"] = {
            "attn": attn,
            "ln1": {"weight": blk.ln1.weight, "bias": blk.ln1.bias},
            "ln2": {"weight": blk.ln2.weight, "bias": blk.ln2.bias},
            "w1": blk.w1, "b1": blk.b1, "w2": blk.w2, "b2": blk.b2}
    return out


def load_transformer_lm_params(model, tree: Mapping) -> None:
    """Fill `model` (a port `TransformerLM`) from the JAX `TransformerLM`
    parameter tree `tree` (nested dicts of numpy arrays), in place. Raises
    on a missing or extra key and on a shape mismatch."""
    with torch.no_grad():
        _copy(_targets(model), tree, "")


def lm_params_tree(model, grad: bool = False) -> Dict:
    """The `TransformerLM`'s parameters (or, with `grad=True`, their
    `.grad`) as the JAX package's tree: nested dicts of f32 numpy arrays.
    The inverse of `load_transformer_lm_params`, for comparing the two."""
    return _export(_targets(model), _leaf(grad))


# --------------------------------------------------------------------------
# The general carry: module trees built from the port's containers
# --------------------------------------------------------------------------
#
# The JAX package keys a container's parameter tree by its children's keys
# ("<index>_<name>", the port's `Container` registers children under the
# same keys) and its BN state by module-path tuples of those keys, each
# entry {"mean", "var"}. Leaves are copied as they are, except the conv
# kernel: HWIO in the JAX package, OIHW in the port. `Linear` keeps the
# JAX [in, out] weight (nn/linear.py), so it needs no transpose.

class _HwioToOihw:
    """Marks a port conv weight: the JAX leaf is its HWIO permutation."""

    def __init__(self, param):
        self.param = param
        self.shape = (param.shape[2], param.shape[3], param.shape[1],
                      param.shape[0])


def _copy(targets: Mapping, tree: Mapping, path: str):
    """Copy the numpy leaves of `tree` into the tensors of `targets` (the
    same nesting); raises on a missing or extra key or a shape mismatch.
    A conv weight (`_HwioToOihw`) takes its leaf permuted HWIO -> OIHW."""
    if set(targets) != set(tree):
        raise KeyError(f"parameter keys at {path or '<root>'} differ: "
                       f"model {sorted(targets)}, tree {sorted(tree)}")
    for key, dst in targets.items():
        where = f"{path}.{key}" if path else key
        if isinstance(dst, Mapping):
            _copy(dst, tree[key], where)
            continue
        src = np.asarray(tree[key])
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{where}: tree shape {tuple(src.shape)} != "
                             f"model shape {tuple(dst.shape)}")
        t = torch.tensor(src)
        if isinstance(dst, _HwioToOihw):
            dst, t = dst.param, t.permute(3, 2, 0, 1)
        dst.copy_(t)


def _node_name(key: str) -> str:
    """A graph node key without its id: the module's name."""
    return key.rsplit("_", 1)[0]


def _child_keys(module, keys, like) -> list:
    """The keys `module`'s children (port keys `keys`) take in the tree
    `like`: the same, except in a `Graph` whose keys differ from the
    tree's, where they pair by position (module names checked)."""
    from bigdl_tpu_torch.nn.containers import Graph
    if not isinstance(module, Graph) or not isinstance(like, Mapping):
        return list(keys)
    have = list(like)
    if set(have) == set(keys):
        return list(keys)
    if len(have) != len(keys):
        raise KeyError(f"graph {module.name!r} has {len(keys)} nodes, the "
                       f"tree {len(have)} entries")
    for k, h in zip(keys, have):
        if _node_name(k) != _node_name(h):
            raise ValueError(f"graph {module.name!r}: node {k!r} pairs with "
                             f"the tree's {h!r} by position, and their "
                             "module names differ")
    return have


def _named_children(module) -> list:
    """(key, child) of `module`'s children in the JAX tree: all of them,
    except in a `DynamicGraph`, whose JAX tree holds only the nodes with
    parameters (the reference's `DynamicGraph.init` drops the empty
    subtrees)."""
    from bigdl_tpu_torch.nn.dynamic_graph import DynamicGraph
    children = list(module.named_children())
    if isinstance(module, DynamicGraph):
        children = [(k, c) for k, c in children
                    if next(c.parameters(), None) is not None]
    return children


def _module_targets(module, like: Optional[Mapping] = None) -> Dict:
    """A module's parameters arranged as the JAX tree: its own parameters
    by name, then each child's subtree under the child's key (a
    container's `"<index>_<name>"`, a graph node's key, a recurrent
    layer's `cell`, `cell0`, ..., a `TimeDistributed`'s `layer`); a
    graph's nodes under the keys of `like` where given (`_child_keys`)."""
    from bigdl_tpu_torch.nn.conv import SpatialConvolution
    out = {}
    for name, p in module.named_parameters(recurse=False):
        conv_w = isinstance(module, SpatialConvolution) and name == "weight"
        out[name] = _HwioToOihw(p) if conv_w else p
    children = _named_children(module)
    keys = _child_keys(module, [k for k, _ in children], like)
    for key, (_, child) in zip(keys, children):
        out[key] = _module_targets(
            child, like.get(key) if isinstance(like, Mapping) else None)
    return out


def _bn_modules(model, like: Optional[Mapping] = None
                ) -> Dict[Tuple[str, ...], torch.nn.Module]:
    """{module path: BN module}, the paths under the keys of `like` where
    given (`_child_keys`), in module order."""
    from bigdl_tpu_torch.nn.normalization import BatchNormalization
    out = {}

    def walk(m, path, sub):
        if isinstance(m, BatchNormalization):
            out[path] = m
        children = _named_children(m)
        keys = _child_keys(m, [k for k, _ in children], sub)
        for key, (_, child) in zip(keys, children):
            walk(child, path + (key,),
                 sub.get(key) if isinstance(sub, Mapping) else None)

    walk(model, (), like)
    return out


def load_module_params(model, params: Mapping,
                       state: Optional[Mapping] = None) -> None:
    """Fill `model` (built from the port's containers, e.g. a port
    `ResNet`) in place from the JAX model's parameter tree `params`
    (nested dicts of numpy arrays) and BN state `state` ({module-path
    tuple: {"mean", "var"}}; None leaves the running stats alone). A
    graph's nodes pair with the tree's entries by position (module names
    checked). Raises on a missing or extra key, path or stat, and on a
    shape mismatch."""
    with torch.no_grad():
        _copy(_module_targets(model, params), params, "")
        if state is None:
            return
        bns = _bn_modules(model, params)
        if set(bns) != set(state):
            raise KeyError(f"BN state paths differ: model-only "
                           f"{sorted(set(bns) - set(state))}, tree-only "
                           f"{sorted(set(state) - set(bns))}")
        for path, bn in bns.items():
            stats = state[path]
            if set(stats) != {"mean", "var"}:
                raise KeyError(f"{'.'.join(path)}: BN state keys "
                               f"{sorted(stats)} != ['mean', 'var']")
            for key in ("mean", "var"):
                src = np.asarray(stats[key])
                dst = getattr(bn, key)
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"{'.'.join(path)}.{key}: tree shape "
                                     f"{tuple(src.shape)} != model shape "
                                     f"{tuple(dst.shape)}")
                dst.copy_(torch.tensor(src))


def _export(targets: Mapping, leaf) -> Dict:
    out = {}
    for key, dst in targets.items():
        if isinstance(dst, Mapping):
            out[key] = _export(dst, leaf)
        elif isinstance(dst, _HwioToOihw):
            out[key] = leaf(dst.param).permute(2, 3, 1, 0).numpy()
        else:
            out[key] = leaf(dst).numpy()
    return out


def _leaf(grad: bool):
    """A parameter (or its .grad) as a CPU tensor: floats as f32, an int8
    leaf (a quantized layer's weight) as it is."""
    def leaf(p):
        t = p.grad if grad else p
        if t is None:
            raise ValueError("a parameter has no .grad")
        t = t.detach().cpu()
        return t.float() if t.is_floating_point() else t
    return leaf


def module_params_tree(model, grad: bool = False,
                       like: Optional[Mapping] = None) -> Dict:
    """The model's parameters (or, with `grad=True`, their `.grad`) as the
    JAX package's tree: nested dicts of f32 numpy arrays (a quantized
    layer's int8 weight stays int8), conv kernels HWIO; a graph's nodes
    under the keys of the JAX tree `like` where given. The inverse of
    `load_module_params`, for comparing the two."""
    return _export(_module_targets(model, like), _leaf(grad))


def module_state(model, like: Optional[Mapping] = None
                 ) -> Dict[Tuple[str, ...], Dict[str, np.ndarray]]:
    """The BN running stats as the JAX package's state dict (a graph's
    nodes under the keys of the JAX parameter tree `like` where given)."""
    return {path: {"mean": bn.mean.detach().cpu().numpy(),
                   "var": bn.var.detach().cpu().numpy()}
            for path, bn in _bn_modules(model, like).items()}


# --------------------------------------------------------------------------
# Any model, and trees keyed by parameter name (checkpoints)
# --------------------------------------------------------------------------

def _is_lm(model) -> bool:
    from bigdl_tpu_torch.models.transformer import TransformerLM
    return isinstance(model, TransformerLM)


def _tree_targets(model) -> Dict:
    return _targets(model) if _is_lm(model) else _module_targets(model)


def params_tree(model) -> Dict:
    """The model's parameters in the JAX layout: `lm_params_tree` for a
    `TransformerLM`, `module_params_tree` for a container model."""
    return lm_params_tree(model) if _is_lm(model) \
        else module_params_tree(model)


def load_params(model, params: Mapping,
                state: Optional[Mapping] = None) -> None:
    """Fill `model` in place from a JAX-layout params tree (and, for a
    container model, the BN state; a `TransformerLM` has none)."""
    if _is_lm(model):
        if state:
            raise KeyError(f"a TransformerLM has no BN state, got "
                           f"{sorted(state)[:3]}")
        load_transformer_lm_params(model, params)
    else:
        load_module_params(model, params, state)


def _param_names(model) -> Dict[int, str]:
    return {id(p): n for n, p in model.named_parameters()}


def tree_from_named(model, named: Mapping[str, torch.Tensor]) -> Dict:
    """Tensors keyed by the model's parameter names (for example an
    optimizer's velocity), as the JAX-layout tree of f32 numpy arrays: the
    layout `params_tree` gives, empty subtrees included. Tensors of the
    parameters of one top-level child only (a per-submodule method's
    slots) give that child's subtree."""
    return export_named(
        model, named, lambda name, t, conv: t.detach().float().cpu().numpy())


def export_named(model, named: Mapping[str, torch.Tensor], leaf) -> Dict:
    """`tree_from_named` with its own leaves: each leaf is
    `leaf(name, tensor, conv)`, the tensor in the JAX layout (a conv
    weight's permuted OIHW -> HWIO, `conv` True)."""
    names = _param_names(model)
    targets = _tree_targets(model)
    children = {n.split(".", 1)[0] for n in named}
    if set(named) != set(names.values()) and len(children) == 1:
        targets = targets[children.pop()]

    def walk(node):
        out = {}
        for key, dst in node.items():
            if isinstance(dst, Mapping):
                out[key] = walk(dst)
                continue
            conv = isinstance(dst, _HwioToOihw)
            name = names[id(dst.param if conv else dst)]
            t = named[name]
            out[key] = leaf(name, t.permute(2, 3, 1, 0) if conv else t,
                            conv)
        return out

    return walk(targets)


def named_from_tree(model, tree: Mapping, child: Optional[str] = None
                    ) -> Dict:
    """The inverse of `tree_from_named`: a JAX-layout tree (of the whole
    model, or of its top-level `child`) as tensors keyed by parameter
    name, each on its parameter's device in the tree's dtype. Raises on a
    missing key or a shape mismatch."""
    names = _param_names(model)
    out = {}

    def walk(targets, node, path):
        for key, dst in targets.items():
            where = f"{path}.{key}" if path else key
            if isinstance(dst, Mapping):
                walk(dst, node[key], where)
                continue
            conv = isinstance(dst, _HwioToOihw)
            p = dst.param if conv else dst
            t = torch.tensor(np.asarray(node[key]))
            if conv:
                t = t.permute(3, 2, 0, 1).contiguous()
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{where}: tree shape {tuple(t.shape)} != "
                                 f"parameter shape {tuple(p.shape)}")
            out[names[id(p)]] = t.to(p.device)

    targets = _tree_targets(model)
    walk(targets if child is None else targets[child], tree, child or "")
    return out


def tree_keys(model, child: Optional[str] = None) -> set:
    """The top-level keys of the model's JAX-layout tree (or of its
    top-level `child`'s subtree)."""
    targets = _tree_targets(model)
    return set(targets if child is None else targets[child])


# --------------------------------------------------------------------------
# The pipelines (`parallel/pipeline.py`)
# --------------------------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def load_gpipe_params(model, params: Mapping,
                      state: Optional[Mapping] = None) -> None:
    """Fill a port `GPipe` from the JAX `GPipe.init` tree, whose every leaf
    is stacked on a leading stage axis: stage s takes slice s of each leaf
    (and of each BN statistic of `state`, stacked the same way, if
    given)."""
    for s, stage in enumerate(model.stages):
        load_module_params(
            stage, _tree_map(lambda a: np.asarray(a)[s], params),
            None if state is None else {
                path: {k: np.asarray(v)[s] for k, v in stats.items()}
                for path, stats in state.items()})


def gpipe_params_tree(model, grad: bool = False) -> Dict:
    """The port `GPipe`'s parameters (or their `.grad`) as the JAX tree:
    each stage's `module_params_tree`, stacked on a leading stage axis."""
    trees = [module_params_tree(stage, grad) for stage in model.stages]

    def stack(nodes):
        if isinstance(nodes[0], Mapping):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack(nodes)

    return stack(trees)


def load_pipeline_params(pipe, params, states=None) -> None:
    """Fill a port `PipelineStages`' stages from the JAX
    `PipelineStages.init` per-stage list (and, optionally, a per-stage
    list of BN states), each through `load_module_params`."""
    if len(params) != pipe.S:
        raise ValueError(f"{len(params)} stage trees for {pipe.S} stages")
    for s, (stage, tree) in enumerate(zip(pipe.stages, params)):
        load_module_params(stage, tree,
                           None if states is None else states[s])


def pipeline_params_tree(pipe, grads=None) -> list:
    """The port pipeline's per-stage list in the JAX layout: each stage's
    parameters (`module_params_tree`), or, given `grads` (the per-stage
    `{name: tensor}` list `train_step_1f1b` returns), those gradients
    (`tree_from_named`), as JAX's 1F1B returns its gradient list."""
    if grads is None:
        return [module_params_tree(stage) for stage in pipe.stages]
    if len(grads) != pipe.S:
        raise ValueError(f"{len(grads)} stage gradients for {pipe.S} "
                         "stages")
    return [tree_from_named(stage, g)
            for stage, g in zip(pipe.stages, grads)]
