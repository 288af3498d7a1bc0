"""Dense layer (counterpart of `bigdl_tpu/nn/linear.py`).

Layout rule: the port keeps the JAX package's `[in, out]` weight and
computes `y = x @ W + b`, as slice 1 does for the transformer's
projections, so a JAX weight is carried over as it is, with no transpose.
"""

from __future__ import annotations

import math
from typing import Optional

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
