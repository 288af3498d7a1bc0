"""LeNet-5 (counterpart of `bigdl_tpu/models/lenet.py`): conv(1->6, 5x5)
tanh pool conv(6->12, 5x5) tanh pool fc(100) tanh fc(class_num)
logsoftmax on 28x28 images, NHWC; `lenet_graph` is the same network as
an `nn.Graph` (the reference's, its layers unnamed).
"""

from __future__ import annotations

from typing import Optional

import torch

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.models._builder import Builder


def LeNet5(class_num: int = 10, *, device=None,
           generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """[B, 28, 28] (or [B, 28, 28, 1]) images -> [B, class_num]
    log-probabilities, on `device` (default CUDA), weights drawn from
    `generator` (default seed 0)."""
    b = Builder(device, generator)
    return (nn.Sequential(name="LeNet5")
            .add(nn.Reshape((28, 28, 1)))
            .add(nn.SpatialConvolution(1, 6, 5, 5, name="conv1_5x5", **b.kw))
            .add(nn.Tanh())
            .add(nn.SpatialMaxPooling(2, 2, 2, 2))
            .add(nn.SpatialConvolution(6, 12, 5, 5, name="conv2_5x5",
                                       **b.kw))
            .add(nn.Tanh())
            .add(nn.SpatialMaxPooling(2, 2, 2, 2))
            .add(nn.Reshape((12 * 4 * 4,)))
            .add(nn.Linear(12 * 4 * 4, 100, name="fc_1", **b.kw))
            .add(nn.Tanh())
            .add(nn.Linear(100, class_num, name="fc_2", **b.kw))
            .add(nn.LogSoftMax()))


def lenet_graph(class_num: int = 10, *, device=None,
                generator: Optional[torch.Generator] = None) -> nn.Graph:
    """LeNet-5 as a `Graph` built with the node DSL (the reference's
    `LeNet5.graph`), on `device`, weights drawn from `generator`."""
    b = Builder(device, generator)
    inp = nn.InputNode()
    x = nn.Reshape((28, 28, 1)).inputs(inp)
    x = nn.SpatialConvolution(1, 6, 5, 5, **b.kw).inputs(x)
    x = nn.Tanh().inputs(x)
    x = nn.SpatialMaxPooling(2, 2, 2, 2).inputs(x)
    x = nn.SpatialConvolution(6, 12, 5, 5, **b.kw).inputs(x)
    x = nn.Tanh().inputs(x)
    x = nn.SpatialMaxPooling(2, 2, 2, 2).inputs(x)
    x = nn.Reshape((12 * 4 * 4,)).inputs(x)
    x = nn.Linear(12 * 4 * 4, 100, **b.kw).inputs(x)
    x = nn.Tanh().inputs(x)
    x = nn.Linear(100, class_num, **b.kw).inputs(x)
    out = nn.LogSoftMax().inputs(x)
    return nn.Graph([inp], [out])
