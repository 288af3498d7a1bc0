"""The MNIST autoencoder (counterpart of `bigdl_tpu/models/autoencoder.py`):
784 -> class_num -> 784 with a sigmoid output, trained against its input
with `MSECriterion`."""

from __future__ import annotations

from typing import Optional

import torch

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.models._builder import Builder


def Autoencoder(class_num: int = 32, *, device=None,
                generator: Optional[torch.Generator] = None
                ) -> nn.Sequential:
    """[B, 28, 28] (or any B x 784) images -> [B, 784] reconstructions, on
    `device` (default CUDA), weights drawn from `generator` (default seed
    0)."""
    b = Builder(device, generator)
    return (nn.Sequential(name="Autoencoder")
            .add(nn.Reshape((784,)))
            .add(nn.Linear(784, class_num, **b.kw))
            .add(nn.ReLU())
            .add(nn.Linear(class_num, 784, **b.kw))
            .add(nn.Sigmoid()))
