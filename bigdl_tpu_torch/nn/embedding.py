"""Embedding lookup (counterpart of `bigdl_tpu/nn/embedding.py`).

Ported: `LookupTable`, the first layer of the PTB language model. Not
ported yet: `LookupTableSparse` and `SparseLinear` (Wide&Deep,
`ROADMAP.md` queue 1 item 4).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.nn.initialization import (InitializationMethod,
                                               RandomNormal,
                                               default_generator)
from bigdl_tpu_torch.nn.module import Module


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
