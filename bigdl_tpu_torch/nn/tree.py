"""Tree-structured LSTMs (counterpart of `bigdl_tpu/nn/tree.py`):
`TreeLSTM`, the base, and `BinaryTreeLSTM`, the constituency Tree-LSTM
(Tai et al. 2015) of the reference's tree sentiment example.

Input: `Table(embeddings [B, L, D], tree [B, N, 3])`, the reference's
contract: `tree[b, n] = (left, right, leaf)` with 1-based indices; `leaf
> 0` marks a leaf that reads `embeddings[b, leaf - 1]`, else `left` and
`right` point at earlier node slots; an all-zero row is padding, whose
state is zero. Output: the node hiddens [B, N, H].

The reference fills a node-state buffer in a `lax.fori_loop` with
dynamic updates. The port runs the N slots in a Python loop, every
sentence of the batch at once: each slot computes both the leaf and the
composer gates and keeps the one its row asks for, reading its children's
states from the list of the earlier slots' states with batched indexing
(an index at or past the current slot reads zeros, as the reference's
unfilled buffer does). Nothing is written in place into a tensor that an
earlier slot's autograd graph holds.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.nn.initialization import (RandomUniform,
                                               default_generator)
from bigdl_tpu_torch.nn.module import Module


class TreeLSTM(Module):
    """The base: holds the sizes; a concrete tree topology implements
    `forward`."""

    def __init__(self, input_size: int, hidden_size: int,
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_size = input_size
        self.hidden_size = hidden_size


class BinaryTreeLSTM(TreeLSTM):
    """The binary constituency Tree-LSTM. A leaf: (i, o, u) =
    x @ leaf_w + leaf_b, c = sigmoid(i) * tanh(u), h = sigmoid(o) *
    tanh(c). A composer of children l, r: (i, f_l, f_r, o, u) = h_l @
    comp_wl + h_r @ comp_wr + comp_b, c = sigmoid(i) * tanh(u) +
    sigmoid(f_l) * c_l + sigmoid(f_r) * c_r, h = sigmoid(o) * tanh(c).
    Without `gate_output` the output gates are 1. Weights from
    U(-1/sqrt(H), 1/sqrt(H)), biases zero, as the reference's init."""

    def __init__(self, input_size: int, hidden_size: int,
                 gate_output: bool = True, name: Optional[str] = None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(input_size, hidden_size, name)
        self.gate_output = gate_output
        device = resolve_device(device)
        g = default_generator(generator)
        d, h = input_size, hidden_size
        init = RandomUniform(-1.0 / math.sqrt(h), 1.0 / math.sqrt(h))
        self.leaf_w = nn.Parameter(init(g, (d, 3 * h), device=device))
        self.leaf_b = nn.Parameter(torch.zeros(3 * h, device=device))
        self.comp_wl = nn.Parameter(init(g, (h, 5 * h), device=device))
        self.comp_wr = nn.Parameter(init(g, (h, 5 * h), device=device))
        self.comp_b = nn.Parameter(torch.zeros(5 * h, device=device))

    def forward(self, input):
        emb, tree = input[1], input[2].long()
        b, n_slots = tree.shape[0], tree.shape[1]
        hsz = self.hidden_size
        rows = torch.arange(b, device=emb.device)
        zero = emb.new_zeros((b, hsz))
        hs, cs = [], []
        for n in range(n_slots):
            left, right, leaf = tree[:, n, 0], tree[:, n, 1], tree[:, n, 2]
            # the leaf path
            g = emb[rows, (leaf - 1).clamp(min=0)] @ self.leaf_w \
                + self.leaf_b
            c_leaf = torch.sigmoid(g[:, :hsz]) * torch.tanh(g[:, 2 * hsz:])
            h_leaf = torch.tanh(c_leaf)
            if self.gate_output:
                h_leaf = torch.sigmoid(g[:, hsz:2 * hsz]) * h_leaf
            # the composer path, children read from the earlier slots (a
            # slot at or past n reads the zero row appended at index n)
            h_prev = torch.stack(hs + [zero], dim=1)
            c_prev = torch.stack(cs + [zero], dim=1)
            li = (left - 1).clamp(min=0)
            ri = (right - 1).clamp(min=0)
            li = torch.where(li < n, li, n)
            ri = torch.where(ri < n, ri, n)
            hl, hr = h_prev[rows, li], h_prev[rows, ri]
            cl, cr = c_prev[rows, li], c_prev[rows, ri]
            gc = hl @ self.comp_wl + hr @ self.comp_wr + self.comp_b
            c_comp = (torch.sigmoid(gc[:, :hsz]) * torch.tanh(gc[:, 4 * hsz:])
                      + torch.sigmoid(gc[:, hsz:2 * hsz]) * cl
                      + torch.sigmoid(gc[:, 2 * hsz:3 * hsz]) * cr)
            h_comp = torch.tanh(c_comp)
            if self.gate_output:
                h_comp = torch.sigmoid(gc[:, 3 * hsz:4 * hsz]) * h_comp
            is_leaf = (leaf > 0)[:, None]
            is_pad = ((leaf == 0) & (left == 0) & (right == 0))[:, None]
            hs.append(torch.where(is_pad, zero,
                                  torch.where(is_leaf, h_leaf, h_comp)))
            cs.append(torch.where(is_pad, zero,
                                  torch.where(is_leaf, c_leaf, c_comp)))
        return torch.stack(hs, dim=1)
