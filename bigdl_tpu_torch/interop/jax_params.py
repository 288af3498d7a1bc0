"""Carry a JAX `TransformerLM` parameter tree into the port's model.

The tree is the JAX package's nested dict, with its leaves converted by
the caller to numpy arrays (`np.asarray`), so nothing here needs JAX:

    {"embed": [V, E], "head": [E, V],
     "block{i}": {"attn": {"wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo"},
                  "ln1": {"weight", "bias"}, "ln2": {"weight", "bias"},
                  "w1", "b1", "w2", "b2"}}

Layout rule: the port keeps the JAX `[in, out]` projection layout as raw
parameters and computes `x @ W`, so every leaf is copied as it is, with no
transpose.
"""

from __future__ import annotations

from typing import Dict, Mapping

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


def _copy(targets: Mapping, tree: Mapping, path: str):
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
        dst.copy_(torch.tensor(src))


def load_transformer_lm_params(model, tree: Mapping) -> None:
    """Fill `model` (a port `TransformerLM`) from the JAX `TransformerLM`
    parameter tree `tree` (nested dicts of numpy arrays), in place. Raises
    on a missing or extra key and on a shape mismatch."""
    with torch.no_grad():
        _copy(_targets(model), tree, "")
