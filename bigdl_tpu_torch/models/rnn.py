"""The sequence models (counterpart of `bigdl_tpu/models/rnn.py`): the PTB
LSTM language model and `SimpleRNN`, with the reference's module names, so
the port's parameter paths are the JAX tree's (`0_LookupTable.weight`,
`1_Recurrent.cell.cell0.wi`, `2_TimeDistributed.layer.weight`, ...).

`PTBModel` keeps a quirk of the reference (`bigdl_tpu/models/rnn.py:16`):
every LSTM cell, the first included, takes `hidden_size` inputs, which is
the embedding's width, so the model is the same either way.
"""

from __future__ import annotations

from typing import Optional

import torch

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.models._builder import Builder


def PTBModel(input_size: int = 10000, hidden_size: int = 200,
             output_size: int = 10000, num_layers: int = 2,
             keep_prob: float = 1.0, *, device=None,
             generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """1-based ids [B, T] -> [B, T, output_size] log-probabilities:
    `LookupTable(input_size, hidden_size)`, `num_layers` stacked LSTM
    cells over time, a `Linear` to `output_size` and `LogSoftMax` at
    every step. With `keep_prob < 1`, a `Dropout(1 - keep_prob)` after
    the embedding and after the LSTM stack (masks from the optimizer's
    step generator). On `device` (default CUDA), weights from `generator`
    (default seed 0) drawn in the reference's build order: the cells,
    the embedding, the projection."""
    b = Builder(device, generator)
    cells = [nn.LSTMCell(hidden_size, hidden_size, **b.kw)
             for _ in range(num_layers)]
    m = (nn.Sequential(name="PTBModel")
         .add(nn.LookupTable(input_size, hidden_size, **b.kw)))
    if keep_prob < 1.0:
        m.add(nn.Dropout(1.0 - keep_prob))
    m.add(nn.Recurrent(nn.MultiRNNCell(cells)))
    if keep_prob < 1.0:
        m.add(nn.Dropout(1.0 - keep_prob))
    return (m.add(nn.TimeDistributed(nn.Linear(hidden_size, output_size,
                                               **b.kw)))
            .add(nn.TimeDistributed(nn.LogSoftMax())))


def SimpleRNN(input_size: int = 4, hidden_size: int = 40,
              output_size: int = 4, *, device=None,
              generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """[B, T, input_size] -> [B, T, output_size] log-probabilities: an
    `RnnCell` over time, a `Linear` and `LogSoftMax` at every step."""
    b = Builder(device, generator)
    return (nn.Sequential(name="SimpleRNN")
            .add(nn.Recurrent(nn.RnnCell(input_size, hidden_size, **b.kw)))
            .add(nn.TimeDistributed(nn.Linear(hidden_size, output_size,
                                              **b.kw)))
            .add(nn.TimeDistributed(nn.LogSoftMax())))
