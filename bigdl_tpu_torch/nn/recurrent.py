"""The recurrent stack (counterpart of `bigdl_tpu/nn/recurrent.py`).

The whole file (`ROADMAP.md` queue 1 item 5; done): `Cell`, `RnnCell`,
`LSTMCell` (with its aliases `LSTM` and `LSTM2`), `LSTMPeepholeCell`
(`LSTMPeephole`), `GRUCell` (`GRU`), `MultiRNNCell`, `ConvLSTMPeephole`,
`ConvLSTMPeephole3D`, `Recurrent`, `BiRecurrent`, `RecurrentDecoder`
and `TimeDistributed`.

The layout is the reference's: a cell holds `wi [in, k*h]`, `wh [h, k*h]`
and `bias [k*h]` and computes `x @ wi + h @ wh + bias` (one fused product
for the LSTM's four gates, in the order i, f, g, o), and its modules sit
at the reference's parameter paths (`cell`, `cell0`, `cell1`, ...,
`layer`, a `BiRecurrent`'s `fwd` and `bwd`), so `named_parameters` gives
the JAX tree's paths and weights carry over as they are
(`interop/jax_params.py`). The GRU keeps the reference's keys (`wi_rz`,
`wh_rz`, `b_rz` for the reset and update gates, in that order, and
`wi_n`, `wh_n`, `b_n` for the candidate) and its formulation, Cho et
al.'s `(r * h) @ wh_n`, not `torch.nn.GRU`'s `r * (h @ W + b)`. The
convolutional cells keep the JAX kernels' HWIO (DHWIO) layout as their
parameters and permute them for `F.conv2d` / `F.conv3d` over the NHWC
(NDHWC) maps, "same" padding at stride 1.

The reference runs the time loop as `lax.scan`, one compiled step body.
The port runs it as a Python loop over the T steps: each step launches
its own products and elementwise kernels. The gate products are plain
`torch.matmul`, as they are `jnp` products outside any Pallas kernel in
the reference; no fused LSTM kernel and no cuDNN RNN is used.

Each cell's `reset_parameters(generator)` draws its parameters anew as
its constructor does: a `BiRecurrent` given no backward cell builds one
as a deep copy of the forward cell with fresh parameters, as the
reference initialises its copy from its own key.
"""

from __future__ import annotations

import copy
import math
from typing import List, Optional

import torch
import torch.nn.functional as F
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

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Draw the parameters anew, as the constructor does."""
        raise NotImplementedError

    def forward(self, input):
        out, new_state = self.step(input[1], input[2])
        return T(out, new_state)


def _uniform_params(module, shapes, hidden_size, device, generator):
    """Each (name, shape) of `shapes` drawn from U(-1/sqrt(h),
    1/sqrt(h)) in that order, as the reference's init."""
    device = resolve_device(device)
    g = default_generator(generator)
    stdv = 1.0 / math.sqrt(hidden_size)
    init = RandomUniform(-stdv, stdv)
    for name, shape in shapes:
        setattr(module, name, nn.Parameter(init(g, shape, device=device)))


def _cell_params(module, input_size, hidden_size, gates, device,
                 generator):
    """`wi [in, gates*h]`, `wh [h, gates*h]` and `bias [gates*h]`, each
    drawn from U(-1/sqrt(h), 1/sqrt(h)) in that order, as the
    reference's init."""
    width = gates * hidden_size
    _uniform_params(module, (("wi", (input_size, width)),
                             ("wh", (hidden_size, width)),
                             ("bias", (width,))),
                    hidden_size, device, generator)


def _param_device(module):
    return next(module.parameters()).device


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

    def reset_parameters(self, generator=None):
        _cell_params(self, self.input_size, self.hidden_size, 1,
                     _param_device(self), generator)

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

    def reset_parameters(self, generator=None):
        _cell_params(self, self.input_size, self.hidden_size, 4,
                     _param_device(self), generator)

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


class LSTMPeepholeCell(Cell):
    """The LSTM cell with peephole connections: the input and forget
    gates see c_prev (`peep_i`, `peep_f`), the output gate the new c
    (`peep_o`); sigmoid gates, tanh candidate. `p` is accepted and
    ignored, as in the reference."""

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0,
                 name: Optional[str] = None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name)
        self.input_size, self.hidden_size = input_size, hidden_size
        self._init(device, generator)

    def _init(self, device, generator):
        h = self.hidden_size
        _uniform_params(self, (("wi", (self.input_size, 4 * h)),
                               ("wh", (h, 4 * h)), ("bias", (4 * h,)),
                               ("peep_i", (h,)), ("peep_f", (h,)),
                               ("peep_o", (h,))), h, device, generator)

    def reset_parameters(self, generator=None):
        self._init(_param_device(self), generator)

    def zero_state(self, batch, dtype=torch.float32, device=None):
        z = torch.zeros((batch, self.hidden_size), dtype=dtype,
                        device=device)
        return z, z

    def step(self, x, state):
        h_prev, c_prev = state
        z = x @ self.wi + h_prev @ self.wh + self.bias
        i, f, g, o = z.chunk(4, dim=-1)
        i = torch.sigmoid(i + self.peep_i * c_prev)
        f = torch.sigmoid(f + self.peep_f * c_prev)
        g = torch.tanh(g)
        c = f * c_prev + i * g
        o = torch.sigmoid(o + self.peep_o * c)
        h = o * torch.tanh(c)
        return h, (h, c)


#: the reference's alias
LSTMPeephole = LSTMPeepholeCell


class GRUCell(Cell):
    """The GRU of Cho et al. (the reference's): r, z =
    inner_activation(x @ wi_rz + h @ wh_rz + b_rz), n = activation(x @
    wi_n + (r * h) @ wh_n + b_n), h' = (1 - z) * n + z * h. The reset
    gate scales h before its product, where `torch.nn.GRU` scales the
    product. `p` is accepted and ignored, as in the reference."""

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0,
                 activation=torch.tanh, inner_activation=None,
                 name: Optional[str] = None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name)
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        self.inner_activation = inner_activation or torch.sigmoid
        self._init(device, generator)

    def _init(self, device, generator):
        h, d = self.hidden_size, self.input_size
        _uniform_params(self, (("wi_rz", (d, 2 * h)), ("wh_rz", (h, 2 * h)),
                               ("b_rz", (2 * h,)), ("wi_n", (d, h)),
                               ("wh_n", (h, h)), ("b_n", (h,))),
                        h, device, generator)

    def reset_parameters(self, generator=None):
        self._init(_param_device(self), generator)

    def zero_state(self, batch, dtype=torch.float32, device=None):
        return torch.zeros((batch, self.hidden_size), dtype=dtype,
                           device=device)

    def step(self, x, h_prev):
        rz = self.inner_activation(x @ self.wi_rz + h_prev @ self.wh_rz
                                   + self.b_rz)
        r, z = rz.chunk(2, dim=-1)
        n = self.activation(x @ self.wi_n + (r * h_prev) @ self.wh_n
                            + self.b_n)
        h = (1.0 - z) * n + z * h_prev
        return h, h


#: the reference's alias
GRU = GRUCell


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

    def reset_parameters(self, generator=None):
        g = default_generator(generator)
        for c in self.cells:
            c.reset_parameters(g)

    def step(self, x, state):
        new_states = []
        out = x
        for c, s in zip(self.cells, state):
            out, s = c.step(out, s)
            new_states.append(s)
        return out, tuple(new_states)


class _ConvLSTMBase(Cell):
    """The convolutional LSTM with peepholes over channels-last maps of
    `rank` spatial axes: the gates from `conv(x, wi) + conv(h, wh) +
    bias`, split i, f, g, o; with `with_peephole`, i and f see c_prev and
    o the new c. Kernels in the JAX layout (HWIO / DHWIO), drawn from
    N(0, 2 / fan) with fan = k^rank * (c_in + c_out); bias and peepholes
    zero. Stride 1 only, as the reference's."""

    rank = 2

    def __init__(self, input_size: int, output_size: int, kernel_i: int = 3,
                 kernel_c: int = 3, stride: int = 1,
                 with_peephole: bool = True, name: Optional[str] = None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(name)
        if stride != 1:
            raise NotImplementedError(
                f"{type(self).__name__} stride != 1 would shrink the state "
                "map each step; the reference only supports stride 1 in "
                "practice")
        self.c_in, self.c_out = input_size, output_size
        self.ki, self.kc = kernel_i, kernel_c
        self.with_peephole = with_peephole
        self.hidden_size = output_size
        self._init(device, generator)

    def _init(self, device, generator):
        device = resolve_device(device)
        g = default_generator(generator)
        r, c = self.rank, self.c_out
        std = math.sqrt(2.0 / (self.ki ** r * (self.c_in + c)))
        shapes = (("wi", (self.ki,) * r + (self.c_in, 4 * c)),
                  ("wh", (self.kc,) * r + (c, 4 * c)))
        for name, shape in shapes:
            w = std * torch.randn(shape, generator=g)
            setattr(self, name, nn.Parameter(w.to(device)))
        zeros = [("bias", 4 * c)] + ([("peep_i", c), ("peep_f", c),
                                     ("peep_o", c)]
                                    if self.with_peephole else [])
        for name, n in zeros:
            setattr(self, name, nn.Parameter(torch.zeros(n, device=device)))

    def reset_parameters(self, generator=None):
        self._init(_param_device(self), generator)

    def zero_state_for(self, x):
        """The zero (h, c) maps for one time step `x` (the state needs the
        spatial dims, so the cell has no `zero_state(batch)`)."""
        z = torch.zeros(tuple(x.shape[:-1]) + (self.c_out,), dtype=x.dtype,
                        device=x.device)
        return z, z

    def _conv(self, x, w):
        """The "same" convolution of channels-last x with a JAX-layout
        kernel."""
        r = self.rank
        xc = x.movedim(-1, 1)
        wc = w.permute(r + 1, r, *range(r))
        conv = F.conv2d if r == 2 else F.conv3d
        return conv(xc, wc, padding="same").movedim(1, -1)

    def step(self, x, state):
        h_prev, c_prev = state
        z = self._conv(x, self.wi) + self._conv(h_prev, self.wh) + self.bias
        i, f, g, o = z.chunk(4, dim=-1)
        if self.with_peephole:
            i = i + self.peep_i * c_prev
            f = f + self.peep_f * c_prev
        i, f, g = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g)
        c = f * c_prev + i * g
        if self.with_peephole:
            o = o + self.peep_o * c
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)


class ConvLSTMPeephole(_ConvLSTMBase):
    """The convolutional LSTM over NHWC maps [B, H, W, C]."""

    rank = 2


class ConvLSTMPeephole3D(_ConvLSTMBase):
    """The convolutional LSTM over NDHWC volumes [B, D, H, W, C]."""

    rank = 3


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


class BiRecurrent(Module):
    """Two `Recurrent` halves over [B, T, ...]: `fwd` over time in order,
    `bwd` (`reverse=True`) from the last step, their outputs merged by
    `merge`: "concat" (on the last axis), "sum", "mul" or "ave". Without
    `cell_bwd` the backward cell is a deep copy of `cell_fwd` with its
    parameters drawn anew from `generator` (default seed 0)."""

    def __init__(self, cell_fwd: Cell, cell_bwd: Optional[Cell] = None,
                 merge: str = "concat", name: Optional[str] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name)
        if cell_bwd is None:
            cell_bwd = copy.deepcopy(cell_fwd)
            cell_bwd.reset_parameters(generator)
        self.fwd = Recurrent(cell_fwd)
        self.bwd = Recurrent(cell_bwd, reverse=True)
        self.merge = merge

    def forward(self, x):
        a, b = self.fwd(x), self.bwd(x)
        if self.merge == "concat":
            return torch.cat([a, b], dim=-1)
        if self.merge == "sum":
            return a + b
        if self.merge == "mul":
            return a * b
        if self.merge == "ave":
            return (a + b) * 0.5
        raise ValueError(f"unknown merge '{self.merge}'")


class RecurrentDecoder(Module):
    """Run `cell` for `output_length` steps from the zero state, the first
    step on the input [B, ...] and each later one on the previous step's
    output: [B, output_length, ...]."""

    def __init__(self, cell: Cell, output_length: int,
                 name: Optional[str] = None):
        super().__init__(name)
        self.cell = cell
        self.output_length = output_length

    def forward(self, x):
        state = self.cell.zero_state_for(x)
        outs = []
        for _ in range(self.output_length):
            x, state = self.cell.step(x, state)
            outs.append(x)
        return torch.stack(outs, dim=1)
