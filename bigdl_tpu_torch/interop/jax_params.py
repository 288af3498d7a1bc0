"""Carry JAX parameter trees into the port's models, and back.

`load_transformer_lm_params` fills a `TransformerLM` and
`lm_params_tree` gives its parameters or gradients back;
`load_module_params` fills any model built from the port's containers
(the ResNets) from the JAX params tree and BN state, and
`module_params_tree` / `module_state` give the port's parameters,
gradients and running stats back in the JAX layout.

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


def _module_targets(module) -> Dict:
    from bigdl_tpu_torch.nn.containers import Container
    from bigdl_tpu_torch.nn.conv import SpatialConvolution
    if isinstance(module, Container):
        return {key: _module_targets(child)
                for key, child in module.named_children()}
    out = {}
    for name, p in module.named_parameters(recurse=False):
        conv_w = isinstance(module, SpatialConvolution) and name == "weight"
        out[name] = _HwioToOihw(p) if conv_w else p
    return out


def _bn_modules(model) -> Dict[Tuple[str, ...], torch.nn.Module]:
    from bigdl_tpu_torch.nn.normalization import BatchNormalization
    return {tuple(name.split(".")) if name else (): m
            for name, m in model.named_modules()
            if isinstance(m, BatchNormalization)}


def load_module_params(model, params: Mapping,
                       state: Optional[Mapping] = None) -> None:
    """Fill `model` (built from the port's containers, e.g. a port
    `ResNet`) in place from the JAX model's parameter tree `params`
    (nested dicts of numpy arrays) and BN state `state` ({module-path
    tuple: {"mean", "var"}}; None leaves the running stats alone). Raises
    on a missing or extra key, path or stat, and on a shape mismatch."""
    with torch.no_grad():
        _copy(_module_targets(model), params, "")
        if state is None:
            return
        bns = _bn_modules(model)
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
    """A parameter (or its .grad) as an f32 CPU tensor."""
    def leaf(p):
        t = p.grad if grad else p
        if t is None:
            raise ValueError("a parameter has no .grad")
        return t.detach().float().cpu()
    return leaf


def module_params_tree(model, grad: bool = False) -> Dict:
    """The model's parameters (or, with `grad=True`, their `.grad`) as the
    JAX package's tree: nested dicts of f32 numpy arrays, conv kernels
    HWIO. The inverse of `load_module_params`, for comparing the two."""
    return _export(_module_targets(model), _leaf(grad))


def module_state(model) -> Dict[Tuple[str, ...], Dict[str, np.ndarray]]:
    """The BN running stats as the JAX package's state dict."""
    return {path: {"mean": bn.mean.detach().cpu().numpy(),
                   "var": bn.var.detach().cpu().numpy()}
            for path, bn in _bn_modules(model).items()}
