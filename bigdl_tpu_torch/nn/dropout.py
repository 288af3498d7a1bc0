"""Dropout (counterpart of `bigdl_tpu/nn/dropout.py`).

Ported: `Dropout`. The reference draws its masks from the apply context's
key, a fold of the optimizer's per-step key; the port draws them from a
`torch.Generator` on the activation's device that an optimizer lends
every `Dropout` for the step (`lend_generator`,
`optim/local_optimizer.py`). The bits differ from JAX's, so the masks
match the reference's in distribution only. A data-parallel optimizer
lends a factory instead, which derives each rank's generator at the
step's first draw.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Union

import torch

from bigdl_tpu_torch.nn.module import Module

#: the generators (or their factories) lent for the current step,
#: innermost last
_LENT: List[Union[torch.Generator, Callable[[], torch.Generator]]] = []


@contextlib.contextmanager
def lend_generator(generator: Union[torch.Generator,
                                    Callable[[], torch.Generator]]):
    """Every `Dropout` draws from `generator` inside the block: a
    `torch.Generator`, or a function that makes one, called at the
    block's first draw (a block that draws nothing never calls it)."""
    _LENT.append(generator)
    try:
        yield generator
    finally:
        _LENT.pop()


def _lent() -> torch.Generator:
    if not isinstance(_LENT[-1], torch.Generator):
        _LENT[-1] = _LENT[-1]()
    return _LENT[-1]


class Dropout(Module):
    """Inverted dropout at train time: each element kept with probability
    1 - `init_p` and, with `scale`, divided by it; the identity in eval
    mode and at `init_p <= 0`. `inplace` is accepted and ignored, as in
    the reference. On a `meta` tensor (a FLOP count) no mask is drawn."""

    def __init__(self, init_p: float = 0.5, inplace: bool = False,
                 scale: bool = True, name: Optional[str] = None):
        super().__init__(name)
        self.p = init_p
        self.scale = scale

    def forward(self, x):
        if not self.training or self.p <= 0.0:
            return x
        keep = 1.0 - self.p
        if x.device.type == "meta":
            return x / keep if self.scale else x
        if not _LENT:
            raise ValueError(
                "Dropout in training mode needs a generator: train through "
                "an optimizer (it lends its step generator), or wrap the "
                "call in lend_generator()")
        kept = torch.rand(x.shape, generator=_lent(),
                          device=x.device) < keep
        y = torch.where(kept, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))
        return y / keep if self.scale else y
