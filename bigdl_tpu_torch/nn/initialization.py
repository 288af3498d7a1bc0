"""Weight initialization (counterpart of `bigdl_tpu/nn/initialization.py`).

Only `Xavier` is ported: it is what `TransformerLM`, `MultiHeadAttention`
and `TransformerBlock` use. Draws come from an explicit `torch.Generator`
on the CPU and are then moved to the target device, so one seed gives the
same weights on every device. (They are not `jax.random`'s numbers: tests
that compare with the JAX package carry its weights over instead.)
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def default_generator(generator: Optional[torch.Generator] = None
                      ) -> torch.Generator:
    """`generator`, or a fresh CPU generator seeded 0: weights never come
    from the global RNG."""
    return generator if generator is not None \
        else torch.Generator().manual_seed(0)


class Xavier:
    """Glorot uniform over an (in, out) weight, the layout the layers
    compute `x @ W` in: U(-limit, limit), limit = sqrt(6 / (in + out))."""

    def __call__(self, generator: torch.Generator, shape: Tuple[int, int],
                 dtype=torch.float32, device=None) -> torch.Tensor:
        fan_in, fan_out = shape
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand(tuple(shape), generator=generator, dtype=dtype)
        return (u * (2 * limit) - limit).to(device)
