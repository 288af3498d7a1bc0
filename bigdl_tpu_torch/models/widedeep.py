"""Wide & Deep recommender (counterpart of `bigdl_tpu/models/widedeep.py`).

Input: the 1-based `Table` a multi-input batch becomes in the training
loop, the predictor and the serving engine:

    1: wide_indices  [B, Lw]  sparse feature ids, 0-based, -1 padding
    2: wide_values   [B, Lw]
    3: deep_cat_ids  [B, C]   one id a categorical column, 1-based
    4: deep_cont     [B, D]   continuous features

Output: [B, class_num] log-probabilities. The wide half is a
`SparseLinear` over the wide ids, the deep half one `LookupTable` a
categorical column, joined with the continuous features into an MLP; the
two halves' logits add (`model_type` "wide_n_deep"), or one alone
("wide", "deep"). Every part is built whatever the type, as in the
reference. The children are `wide`, `embed0`, `embed1`, ... and `deep`,
so the parameter tree is the reference's `{"wide": {"weight", "bias"},
"deep": {...}, "embed0": {"weight"}, ...}` and `interop.jax_params`
carries it both ways.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.models._builder import Builder
from bigdl_tpu_torch.utils.table import T

MODEL_TYPES = ("wide", "deep", "wide_n_deep")


class WideAndDeep(nn.Module):
    """Wide & Deep with the reference's defaults. On `device` (default
    CUDA), weights from `generator` (default seed 0) in build order: the
    wide layer, the embeddings, the MLP."""

    def __init__(self, class_num: int = 2, wide_dim: int = 5000,
                 embed_vocabs: Sequence[int] = (100, 100, 100),
                 embed_dim: int = 8, cont_dim: int = 13,
                 hidden: Sequence[int] = (100, 50),
                 model_type: str = "wide_n_deep",
                 name: Optional[str] = None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name or "WideAndDeep")
        if model_type not in MODEL_TYPES:
            raise ValueError(f"model_type must be one of {MODEL_TYPES}, "
                             f"got {model_type!r}")
        b = Builder(device, generator)
        self.model_type = model_type
        self.class_num = class_num
        self.wide = nn.SparseLinear(wide_dim, class_num, **b.kw)
        self.n_embeds = len(embed_vocabs)
        for i, v in enumerate(embed_vocabs):
            self.add_module(f"embed{i}", nn.LookupTable(v, embed_dim, **b.kw))
        last = embed_dim * len(embed_vocabs) + cont_dim
        self.deep = nn.Sequential()
        for h in hidden:
            self.deep.add(nn.Linear(last, h, **b.kw)).add(nn.ReLU())
            last = h
        self.deep.add(nn.Linear(last, class_num, **b.kw))

    @property
    def embeds(self) -> List[nn.LookupTable]:
        return [getattr(self, f"embed{i}") for i in range(self.n_embeds)]

    def forward(self, input):
        wide_idx, wide_val = input[1], input[2]
        cat_ids, cont = input[3], input[4]
        logits = 0.0
        if self.model_type in ("wide", "wide_n_deep"):
            logits = logits + self.wide(T(wide_idx, wide_val))
        if self.model_type in ("deep", "wide_n_deep"):
            embs = [e(cat_ids[:, i]) for i, e in enumerate(self.embeds)]
            cont = torch.as_tensor(cont, device=embs[0].device)
            logits = logits + self.deep(torch.cat(embs + [cont], dim=-1))
        return torch.log_softmax(logits, dim=-1)
