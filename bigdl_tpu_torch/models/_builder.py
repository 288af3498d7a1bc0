"""What the zoo's builders share: one device and one weight generator for
every layer of a model."""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.nn.initialization import default_generator


class Builder:
    """The `device` and `generator` keywords of every parameterised layer
    of one model: the device resolved once (default CUDA), the weights
    drawn in build order from one generator (default seed 0)."""

    def __init__(self, device=None,
                 generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        self.g = default_generator(generator)

    @property
    def kw(self) -> dict:
        return {"device": self.device, "generator": self.g}
