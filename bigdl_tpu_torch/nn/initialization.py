"""Weight initialization (counterpart of `bigdl_tpu/nn/initialization.py`).

Ported: `Zeros`, `RandomUniform`, `Xavier` and `MsraFiller`, what the
transformer and the ResNets use, and `RandomNormal`, `LookupTable`'s
default. Each method is called with the weight's
shape in the JAX package's layout (`(in, out)` for a dense weight, HWIO for
a conv kernel), so fan-in and fan-out come out as the reference computes
them (`_fans`); a layer that stores another layout permutes the result.
Draws come from an explicit `torch.Generator` on the CPU and are then moved
to the target device, so one seed gives the same weights on every device.
(They are not `jax.random`'s numbers: tests that compare with the JAX
package carry its weights over instead.)
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch


def default_generator(generator: Optional[torch.Generator] = None
                      ) -> torch.Generator:
    """`generator`, or a fresh CPU generator seeded 0: weights never come
    from the global RNG."""
    return generator if generator is not None \
        else torch.Generator().manual_seed(0)


def _fans(shape: Sequence[int]) -> Tuple[int, int]:
    """(fan_in, fan_out) of a weight in the JAX layout: `(in, out)` for a
    dense weight, `(kh, kw, in, out)` for a conv kernel."""
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


class InitializationMethod:
    """`method(generator, shape, dtype, device)` -> a new tensor."""

    def __call__(self, generator: torch.Generator, shape: Sequence[int],
                 dtype=torch.float32, device=None) -> torch.Tensor:
        raise NotImplementedError


class Zeros(InitializationMethod):
    """Fill with zeros."""

    def __call__(self, generator, shape, dtype=torch.float32, device=None):
        return torch.zeros(tuple(shape), dtype=dtype, device=device)


class RandomUniform(InitializationMethod):
    """U(lower, upper); with no bounds, U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""

    def __init__(self, lower: Optional[float] = None,
                 upper: Optional[float] = None):
        self.lower, self.upper = lower, upper

    def __call__(self, generator, shape, dtype=torch.float32, device=None):
        if self.lower is None:
            stdv = 1.0 / math.sqrt(max(_fans(shape)[0], 1))
            lo, hi = -stdv, stdv
        else:
            lo, hi = self.lower, self.upper
        u = torch.rand(tuple(shape), generator=generator, dtype=dtype)
        return (u * (hi - lo) + lo).to(device)


class RandomNormal(InitializationMethod):
    """N(mean, stdv^2)."""

    def __init__(self, mean: float = 0.0, stdv: float = 1.0):
        self.mean, self.stdv = mean, stdv

    def __call__(self, generator, shape, dtype=torch.float32, device=None):
        z = torch.randn(tuple(shape), generator=generator, dtype=dtype)
        return (self.mean + self.stdv * z).to(device)


class Xavier(InitializationMethod):
    """Glorot uniform: U(-limit, limit), limit = sqrt(6 / (fan_in +
    fan_out))."""

    def __call__(self, generator, shape, dtype=torch.float32, device=None):
        fan_in, fan_out = _fans(shape)
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand(tuple(shape), generator=generator, dtype=dtype)
        return (u * (2 * limit) - limit).to(device)


class MsraFiller(InitializationMethod):
    """He init: N(0, 2 / fan_in)."""

    def __call__(self, generator, shape, dtype=torch.float32, device=None):
        std = math.sqrt(2.0 / max(_fans(shape)[0], 1))
        return (std * torch.randn(tuple(shape), generator=generator,
                                  dtype=dtype)).to(device)
