"""The recurrent stack (counterpart of `bigdl_tpu/nn/recurrent.py`).

Ported: `Cell`, `RnnCell`, `LSTMCell` (with its aliases `LSTM` and
`LSTM2`), `MultiRNNCell`, `Recurrent` and `TimeDistributed`, what the
PTB language model and `SimpleRNN` use. Not ported yet (`ROADMAP.md`
queue 1 item 5): `LSTMPeepholeCell`, `GRUCell`, `ConvLSTMPeephole`,
`ConvLSTMPeephole3D`, `BiRecurrent` and `RecurrentDecoder`.

The layout is the reference's: a cell holds `wi [in, k*h]`, `wh [h, k*h]`
and `bias [k*h]` and computes `x @ wi + h @ wh + bias` (one fused product
for the LSTM's four gates, in the order i, f, g, o), and its modules sit
at the reference's parameter paths (`cell`, `cell0`, `cell1`, ...,
`layer`), so `named_parameters` gives the JAX tree's paths and weights
carry over as they are (`interop/jax_params.py`).

The reference runs the time loop as `lax.scan`, one compiled step body.
The port runs it as a Python loop over the T steps: each step launches
its own products and elementwise kernels. The gate products are plain
`torch.matmul`, as they are `jnp` products outside any Pallas kernel in
the reference; no fused LSTM kernel and no cuDNN RNN is used.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import nn

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.nn.initialization import (RandomUniform,
                                               default_generator)
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import T


class Cell(Module):
    """A recurrent cell: `step(x, state)` -> (out, new_state) for one time
    step of `x` [B, ...]. `forward(T(x, state))` is the single step the
    reference's `apply` is, returning `T(out, new_state)`. A state is a
    tensor or a (nested) tuple of tensors."""

    hidden_size: int

    def zero_state(self, batch: int, dtype=torch.float32, device=None):
        raise NotImplementedError

    def zero_state_for(self, x):
        """The zero state for one time step `x` [B, ...] of input: its
        batch size, dtype and device."""
        return self.zero_state(x.shape[0], x.dtype, x.device)

    def step(self, x, state):
        raise NotImplementedError

    def forward(self, input):
        out, new_state = self.step(input[1], input[2])
        return T(out, new_state)


def _cell_params(module, input_size, hidden_size, gates, device,
                 generator):
    """`wi [in, gates*h]`, `wh [h, gates*h]` and `bias [gates*h]`, each
    drawn from U(-1/sqrt(h), 1/sqrt(h)) in that order, as the
    reference's init."""
    device = resolve_device(device)
    g = default_generator(generator)
    stdv = 1.0 / math.sqrt(hidden_size)
    init = RandomUniform(-stdv, stdv)
    width = gates * hidden_size
    for name, shape in (("wi", (input_size, width)),
                        ("wh", (hidden_size, width)), ("bias", (width,))):
        setattr(module, name, nn.Parameter(init(g, shape, device=device)))


class RnnCell(Cell):
    """The plain RNN cell: h' = activation(x @ wi + h @ wh + bias); its
    output is its new state."""

    def __init__(self, input_size: int, hidden_size: int,
                 activation=torch.tanh, name: Optional[str] = None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(name)
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        _cell_params(self, input_size, hidden_size, 1, device, generator)

    def zero_state(self, batch, dtype=torch.float32, device=None):
        return torch.zeros((batch, self.hidden_size), dtype=dtype,
                           device=device)

    def step(self, x, h):
        h2 = self.activation(x @ self.wi + h @ self.wh + self.bias)
        return h2, h2


class LSTMCell(Cell):
    """The LSTM cell, one fused product for the four gates in the order
    i, f, g, o; `forget_bias` is added to the forget gate's
    pre-activation. The state is (h, c) and the output h. `p` (the
    reference's dropout probability) is accepted and ignored, as in the
    reference."""

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0,
                 forget_bias: float = 0.0, activation=torch.tanh,
                 inner_activation=None, name: Optional[str] = None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(name)
        self.input_size, self.hidden_size = input_size, hidden_size
        self.forget_bias = forget_bias
        self.activation = activation
        self.inner_activation = inner_activation or torch.sigmoid
        _cell_params(self, input_size, hidden_size, 4, device, generator)

    def zero_state(self, batch, dtype=torch.float32, device=None):
        z = torch.zeros((batch, self.hidden_size), dtype=dtype,
                        device=device)
        return z, z

    def step(self, x, state):
        h_prev, c_prev = state
        z = x @ self.wi + h_prev @ self.wh + self.bias
        i, f, g, o = z.chunk(4, dim=-1)
        i = self.inner_activation(i)
        f = self.inner_activation(f + self.forget_bias)
        g = self.activation(g)
        o = self.inner_activation(o)
        c = f * c_prev + i * g
        h = o * self.activation(c)
        return h, (h, c)


#: the reference's Torch-style alias, and its re-fused LSTM (the same
#: arithmetic as this cell)
LSTM = LSTMCell
LSTM2 = LSTMCell


class MultiRNNCell(Cell):
    """A stack of cells, `cell0`, `cell1`, ...: each cell's output is the
    next one's input; the state is the tuple of the cells' states."""

    def __init__(self, cells, name: Optional[str] = None):
        super().__init__(name)
        cells = list(cells)
        for i, c in enumerate(cells):
            self.add_module(f"cell{i}", c)
        self.hidden_size = cells[-1].hidden_size

    @property
    def cells(self) -> List[Cell]:
        return list(self._modules.values())

    def zero_state(self, batch, dtype=torch.float32, device=None):
        return tuple(c.zero_state(batch, dtype, device) for c in self.cells)

    def zero_state_for(self, x):
        return tuple(c.zero_state_for(x) for c in self.cells)

    def step(self, x, state):
        new_states = []
        out = x
        for c, s in zip(self.cells, state):
            out, s = c.step(out, s)
            new_states.append(s)
        return out, tuple(new_states)


class Recurrent(Module):
    """Run `cell` over the time axis of `x` [B, T, ...] from the zero
    state: [B, T, hidden] with `return_sequences`, else the output of the
    last step taken. With `reverse`, the steps run from the last time
    step to the first (the outputs are returned in time order; the last
    step taken is the one that read x[:, 0])."""

    def __init__(self, cell: Cell, return_sequences: bool = True,
                 reverse: bool = False, name: Optional[str] = None):
        super().__init__(name)
        self.cell = cell
        self.return_sequences = return_sequences
        self.reverse = reverse

    def forward(self, x):
        steps = range(x.shape[1])
        if self.reverse:
            steps = reversed(steps)
        state = self.cell.zero_state_for(x[:, 0])
        outs = []
        for t in steps:
            out, state = self.cell.step(x[:, t], state)
            outs.append(out)
        if not self.return_sequences:
            return outs[-1]
        if self.reverse:
            outs.reverse()
        return torch.stack(outs, dim=1)


class TimeDistributed(Module):
    """Apply `layer` at every time step of [B, T, ...], with time folded
    into the batch: one call of the layer on [B*T, ...]."""

    def __init__(self, layer: Module, name: Optional[str] = None):
        super().__init__(name)
        self.layer = layer

    def forward(self, x):
        b, t = x.shape[0], x.shape[1]
        y = self.layer(x.reshape(b * t, *x.shape[2:]))
        return y.reshape(b, t, *y.shape[1:])
