"""Embedding lookups and the sparse layers (counterpart of
`bigdl_tpu/nn/embedding.py`).

`LookupTable` is the first layer of the PTB language model and the deep
half of Wide&Deep; `LookupTableSparse`, `SparseLinear` and
`SparseJoinTable` are the reference's sparse building blocks. A sparse
input is the reference's static form: a `Table` of a padded `[B, L]`
index matrix and its `[B, L]` values, not a COO tensor. The conventions
differ from layer to layer, as in the reference:
- `LookupTable` / `LookupTableSparse`: 1-based ids, 0 is padding;
- `SparseLinear` / `SparseJoinTable`: 0-based indices, -1 is padding.
Every lookup is a gather (`F.embedding`), and its gradient an
`index_add` into the rows it read.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.nn.initialization import (InitializationMethod,
                                               RandomNormal, RandomUniform,
                                               default_generator)
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import Table


class LookupTable(Module):
    """Embedding lookup: `[...]` ids -> `[..., n_output]` rows of the
    `[n_index, n_output]` weight, as the reference computes it:

    - ids are 1-based unless `one_based=False`; float ids (the
      reference's example feeds them) are truncated to integers first;
    - an id below the first row (0 with 1-based ids) and the id
      `padding_value` (when it is not 0) give a zero row; an id past the
      last row reads the last row;
    - with a finite `max_norm`, each row is scaled by
      min(1, max_norm / (its `norm_type`-norm + 1e-7)) in the forward, a
      differentiable renormalisation (the weight itself is not changed).

    `should_scale_grad_by_freq` is accepted and ignored, as in the
    reference. Default init: N(0, 1) (`RandomNormal`)."""

    def __init__(self, n_index: int, n_output: int,
                 padding_value: float = 0,
                 max_norm: float = float("inf"), norm_type: float = 2.0,
                 should_scale_grad_by_freq: bool = False,
                 weight_init: Optional[InitializationMethod] = None,
                 one_based: bool = True, name: Optional[str] = None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(name)
        device = resolve_device(device)
        self.n_index, self.n_output = n_index, n_output
        self.padding_value = padding_value
        self.max_norm, self.norm_type = max_norm, norm_type
        self.one_based = one_based
        init = weight_init or RandomNormal(0.0, 1.0)
        self.weight = nn.Parameter(init(default_generator(generator),
                                        (n_index, n_output), device=device))

    def forward(self, ids):
        w = self.weight
        if self.max_norm != float("inf"):
            norms = torch.linalg.vector_norm(w, ord=self.norm_type, dim=1,
                                             keepdim=True)
            w = w * torch.clamp(self.max_norm / (norms + 1e-7), max=1.0)
        ids = torch.as_tensor(ids, device=w.device).to(torch.int32)
        if self.one_based:
            ids = ids - 1
        out = F.embedding(ids.clamp(0, self.n_index - 1).long(), w)
        valid = ids >= 0
        if self.padding_value:
            pad = int(self.padding_value) - (1 if self.one_based else 0)
            valid = valid & (ids != pad)
        return torch.where(valid[..., None], out, out.new_zeros(()))


def _ids(x, device) -> torch.Tensor:
    """Ids or indices as int32 on `device` (float ids, which the
    reference's example feeds, truncated toward zero)."""
    return torch.as_tensor(x, device=device).to(torch.int32)


class LookupTableSparse(Module):
    """Bag embedding: `T(ids [B, L], weights [B, L])` (or the ids alone,
    every weight 1) -> `[B, n_output]`, each row the weighted bag of its
    ids' rows under `combiner`: `sum`, `mean` (over the weights' sum) or
    `sqrtn` (over the weights' L2 norm). Ids are 1-based; 0 is padding
    and weighs nothing. With `max_norm` > 0 the rows are renormalised in
    the forward (`LookupTable`'s `max_norm`). The table is the child
    `embed`, a `LookupTable` (the reference's `inner`), so the parameter
    tree is `{"embed": {"weight"}}` as in the reference."""

    def __init__(self, n_index: int, n_output: int, combiner: str = "sum",
                 max_norm: float = -1,
                 weight_init: Optional[InitializationMethod] = None,
                 name: Optional[str] = None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name)
        if combiner not in ("sum", "mean", "sqrtn"):
            raise ValueError(f"unknown combiner {combiner}")
        self.embed = LookupTable(
            n_index, n_output, weight_init=weight_init,
            max_norm=(max_norm if max_norm > 0 else float("inf")),
            device=device, generator=generator)
        self.combiner = combiner

    def forward(self, input):
        if isinstance(input, Table):
            ids, wts = input[1], input[2]
        else:
            ids, wts = input, None
        ids = _ids(ids, self.embed.weight.device)
        valid = ids > 0 if self.embed.one_based else ids >= 0
        mask = valid.to(torch.float32)
        emb = self.embed(ids)  # [B, L, D], max_norm applied
        w = mask if wts is None else torch.as_tensor(
            wts, device=mask.device) * mask
        s = torch.sum(emb * w[..., None], dim=1)
        if self.combiner == "sum":
            return s
        if self.combiner == "mean":
            denom = torch.sum(w, dim=1, keepdim=True)
        else:
            denom = torch.sqrt(torch.sum(w * w, dim=1, keepdim=True))
        return s / torch.clamp(denom, min=1e-12)


class SparseLinear(Module):
    """Linear over a wide sparse feature vector given as `T(indices [B, L],
    values [B, L])`: y = sum over l of values[b, l] * W[indices[b, l]] + b,
    with W: [input_size, output_size]. Indices are 0-based and -1 is
    padding; an index past `input_size - 1` reads (and trains) the last
    row, as the reference clips it; float indices are truncated. A
    non-`Table` input takes the dense route, `x @ W + b`.

    `backward_start` and `backward_length` are accepted and ignored, as in
    the reference. Default init: U(-1/sqrt(input_size), 1/sqrt(input_size))
    for the weight, zeros for the bias (the reference's)."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, backward_start: int = -1,
                 backward_length: int = -1, name: Optional[str] = None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(name)
        device = resolve_device(device)
        self.input_size, self.output_size = input_size, output_size
        self.with_bias = with_bias
        stdv = 1.0 / math.sqrt(input_size)
        self.weight = nn.Parameter(RandomUniform(-stdv, stdv)(
            default_generator(generator), (input_size, output_size),
            device=device))
        self.bias = nn.Parameter(torch.zeros(output_size, device=device)) \
            if with_bias else None

    def forward(self, input):
        w = self.weight
        if not isinstance(input, Table):
            y = input @ w
        else:
            idx = _ids(input[1], w.device)
            vals = torch.as_tensor(input[2], device=w.device)
            rows = F.embedding(idx.clamp(0, self.input_size - 1).long(), w)
            vals = torch.where(idx >= 0, vals, vals.new_zeros(()))
            y = torch.einsum("blo,bl->bo", rows, vals)
        return y + self.bias if self.bias is not None else y


class SparseJoinTable(Module):
    """Joins sparse `T(indices, values)` slots along the feature axis:
    `dims[i]` is slot i's width, so slot i's indices are shifted by the
    widths before it (padding, -1, stays -1). Returns `T(indices,
    values)`, each `[B, sum of the L_i]`."""

    def __init__(self, dims: Sequence[int], name: Optional[str] = None):
        super().__init__(name)
        self.dims = list(dims)

    def forward(self, input):
        offset = 0
        idxs, vals = [], []
        for slot, dim in zip(list(input), self.dims):
            i = torch.as_tensor(slot[1])
            idxs.append(torch.where(i >= 0, i + offset, -1))
            vals.append(torch.as_tensor(slot[2]))
            offset += dim
        return Table(torch.cat(idxs, dim=1), torch.cat(vals, dim=1))
