"""Dense, bilinear and elementwise-affine layers (counterpart of
`bigdl_tpu/nn/linear.py`): `Linear`, `Bilinear`, `CMul`, `CAdd`, `Mul`,
`Add`, `MulConstant`, `AddConstant`, `Maxout`, `Highway`, `Scale`,
`Cosine` and `Euclidean`.

Layout rule: the port keeps the JAX package's `[in, out]` weight and
computes `y = x @ W + b`, as slice 1 does for the transformer's
projections, so a JAX weight is carried over as it is, with no transpose.
Every other leaf has the reference's shape and key too (`Bilinear`'s
`[out, in1, in2]`, `Cosine`'s and `Euclidean`'s `[out, in]`), and the
composite layers hold their parts under the reference's keys (`Maxout`'s
`linear`, `Highway`'s `h` and `t`, `Scale`'s `cmul` and `cadd`). Default
inits draw from U(-stdv, stdv) as the reference's do (stdv from the
layer's fan), from the layer's `generator` (default seed 0).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.nn.initialization import (InitializationMethod,
                                               RandomUniform,
                                               default_generator)
from bigdl_tpu_torch.nn.module import Module


class Linear(Module):
    """y = x @ W + b with W: [in, out]; leading axes beyond one are
    flattened and restored. Default init: U(-1/sqrt(in), 1/sqrt(in)) for
    the weight and the bias, the reference's `reset()`."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True,
                 weight_init: Optional[InitializationMethod] = None,
                 bias_init: Optional[InitializationMethod] = None,
                 name: Optional[str] = None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name)
        device = resolve_device(device)
        g = default_generator(generator)
        self.input_size, self.output_size = input_size, output_size
        self.with_bias = with_bias
        self.weight = nn.Parameter((weight_init or RandomUniform())(
            g, (input_size, output_size), device=device))
        self.bias = None
        if with_bias:
            if bias_init is None:
                stdv = 1.0 / math.sqrt(input_size)
                bias_init = RandomUniform(-stdv, stdv)
            self.bias = nn.Parameter(bias_init(g, (output_size,),
                                               device=device))

    def forward(self, x):
        lead = x.shape[:-1]
        y = x.reshape(-1, x.shape[-1]) @ self.weight
        if self.bias is not None:
            y = y + self.bias
        return y.reshape(*lead, self.output_size)


def _uniform(g, shape, stdv, device):
    return nn.Parameter(RandomUniform(-stdv, stdv)(g, shape, device=device))


class Bilinear(Module):
    """y_k = x1 @ W_k @ x2 + b_k over `T(x1 [B, in1], x2 [B, in2])`, W
    [out, in1, in2]."""

    def __init__(self, input_size1: int, input_size2: int, output_size: int,
                 bias_res: bool = True, name: Optional[str] = None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(name)
        device = resolve_device(device)
        g = default_generator(generator)
        self.n1, self.n2, self.out = input_size1, input_size2, output_size
        self.bias_res = bias_res
        stdv = 1.0 / math.sqrt(input_size1)
        self.weight = _uniform(g, (output_size, input_size1, input_size2),
                               stdv, device)
        self.bias = _uniform(g, (output_size,), stdv, device) \
            if bias_res else None

    def forward(self, xs):
        y = torch.einsum("bi,oij,bj->bo", xs[1], self.weight, xs[2])
        return y + self.bias if self.bias is not None else y


def _size_stdv(size) -> float:
    return 1.0 / math.sqrt(math.prod(size))


class CMul(Module):
    """A learned elementwise scale `weight` of shape `size`, broadcast over
    the input."""

    def __init__(self, size: Sequence[int], name: Optional[str] = None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(name)
        self.size = tuple(size)
        self.weight = _uniform(default_generator(generator), self.size,
                               _size_stdv(self.size), resolve_device(device))

    def forward(self, x):
        return x * self.weight


class CAdd(Module):
    """A learned elementwise bias `bias` of shape `size`, broadcast over
    the input."""

    def __init__(self, size: Sequence[int], name: Optional[str] = None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(name)
        self.size = tuple(size)
        self.bias = _uniform(default_generator(generator), self.size,
                             _size_stdv(self.size), resolve_device(device))

    def forward(self, x):
        return x + self.bias


class Mul(Module):
    """One learned scalar gain `weight` (0-d), from U(-1, 1)."""

    def __init__(self, name: Optional[str] = None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name)
        self.weight = _uniform(default_generator(generator), (), 1.0,
                               resolve_device(device))

    def forward(self, x):
        return x * self.weight


class Add(Module):
    """A learned bias vector `bias` [input_size]."""

    def __init__(self, input_size: int, name: Optional[str] = None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(name)
        self.input_size = input_size
        self.bias = _uniform(default_generator(generator), (input_size,),
                             1.0 / math.sqrt(input_size),
                             resolve_device(device))

    def forward(self, x):
        return x + self.bias


class MulConstant(Module):
    """x * `scalar`."""

    def __init__(self, scalar: float, name: Optional[str] = None):
        super().__init__(name)
        self.scalar = scalar

    def forward(self, x):
        return x * self.scalar


class AddConstant(Module):
    """x + `constant`."""

    def __init__(self, constant: float, name: Optional[str] = None):
        super().__init__(name)
        self.constant = constant

    def forward(self, x):
        return x + self.constant


class Maxout(Module):
    """The maximum over `maxout_number` linear pieces: one `Linear(in,
    out * k)` (`linear`), its output split into k groups of `out`."""

    def __init__(self, input_size: int, output_size: int,
                 maxout_number: int, name: Optional[str] = None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(name)
        self.linear = Linear(input_size, output_size * maxout_number,
                             device=device, generator=generator)
        self.output_size, self.k = output_size, maxout_number

    def forward(self, x):
        y = self.linear(x)
        y = y.reshape(*y.shape[:-1], self.k, self.output_size)
        return y.amax(dim=-2)


class Highway(Module):
    """t * activation(h(x)) + (1 - t) * x with t = sigmoid(t(x)), `h` and
    `t` two `Linear(size, size)`."""

    def __init__(self, size: int, with_bias: bool = True,
                 activation=torch.tanh, name: Optional[str] = None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(name)
        g = default_generator(generator)
        self.h = Linear(size, size, with_bias, device=device, generator=g)
        self.t = Linear(size, size, with_bias, device=device, generator=g)
        self.activation = activation

    def forward(self, x):
        h = self.activation(self.h(x))
        t = torch.sigmoid(self.t(x))
        return h * t + x * (1.0 - t)


class Scale(Module):
    """`CMul(size)` then `CAdd(size)` (`cmul`, `cadd`)."""

    def __init__(self, size: Sequence[int], name: Optional[str] = None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(name)
        g = default_generator(generator)
        self.size = tuple(size)
        self.cmul = CMul(size, device=device, generator=g)
        self.cadd = CAdd(size, device=device, generator=g)

    def forward(self, x):
        return self.cadd(self.cmul(x))


def _row_normalized(a):
    return a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-12)


class Cosine(Module):
    """The cosine similarity of each input row to each of the
    `output_size` rows of `weight` [out, in]."""

    def __init__(self, input_size: int, output_size: int,
                 name: Optional[str] = None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name)
        self.input_size, self.output_size = input_size, output_size
        self.weight = _uniform(default_generator(generator),
                               (output_size, input_size),
                               1.0 / math.sqrt(input_size),
                               resolve_device(device))

    def forward(self, x):
        return _row_normalized(x) @ _row_normalized(self.weight).T


class Euclidean(Module):
    """The L2 distance of each input row [B, in] to each row of `weight`
    [out, in]: sqrt(sum of squares + 1e-12)."""

    def __init__(self, input_size: int, output_size: int,
                 name: Optional[str] = None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name)
        self.input_size, self.output_size = input_size, output_size
        self.weight = _uniform(default_generator(generator),
                               (output_size, input_size),
                               1.0 / math.sqrt(input_size),
                               resolve_device(device))

    def forward(self, x):
        diff = x[:, None, :] - self.weight[None, :, :]
        return torch.sqrt((diff * diff).sum(-1) + 1e-12)
