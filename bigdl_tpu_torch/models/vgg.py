"""VGG-16/19 for ImageNet and the CIFAR-10 VGG (counterpart of
`bigdl_tpu/models/vgg.py`), NHWC.

`VggForCifar10` has a BN -> ReLU pair in each of its 13 convolution blocks
and one more after its first `Linear` (a 1-D `BatchNormalization` over
[B, 512]): 14 fused sites (`nn/fusion.py`), each kernels 6 and 7 once a
training step.
"""

from __future__ import annotations

from typing import Optional

import torch

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.models._builder import Builder


def _block(b: Builder, n_in, n_out, convs):
    seq = nn.Sequential()
    for i in range(convs):
        seq.add(nn.SpatialConvolution(n_in if i == 0 else n_out, n_out, 3, 3,
                                      pad_w=1, pad_h=1, **b.kw))
        seq.add(nn.ReLU())
    seq.add(nn.SpatialMaxPooling(2, 2, 2, 2))
    return seq


def _vgg(cfg, class_num, device, generator):
    b = Builder(device, generator)
    m = nn.Sequential(name="VGG")
    n_in = 3
    for n_out, convs in cfg:
        m.add(_block(b, n_in, n_out, convs))
        n_in = n_out
    (m.add(nn.Reshape((512 * 7 * 7,)))
      .add(nn.Linear(512 * 7 * 7, 4096, **b.kw))
      .add(nn.ReLU())
      .add(nn.Dropout(0.5))
      .add(nn.Linear(4096, 4096, **b.kw))
      .add(nn.ReLU())
      .add(nn.Dropout(0.5))
      .add(nn.Linear(4096, class_num, **b.kw))
      .add(nn.LogSoftMax()))
    return m


def Vgg_16(class_num: int = 1000, *, device=None,
           generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """[B, 224, 224, 3] -> [B, class_num] log-probabilities, on `device`
    (default CUDA), weights from `generator` (default seed 0)."""
    return _vgg([(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)],
                class_num, device, generator)


def Vgg_19(class_num: int = 1000, *, device=None,
           generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """As `Vgg_16`, with 4 convolutions in each of the last three
    blocks."""
    return _vgg([(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)],
                class_num, device, generator)


def VggForCifar10(class_num: int = 10, has_dropout: bool = True, *,
                  device=None, generator: Optional[torch.Generator] = None
                  ) -> nn.Sequential:
    """[B, 32, 32, 3] -> [B, class_num] log-probabilities: conv + BN +
    ReLU stacks (with dropout after most when `has_dropout`), on `device`
    (default CUDA), weights from `generator` (default seed 0)."""
    b = Builder(device, generator)

    def conv_bn(n_in, n_out, dropout=None):
        seq = (nn.Sequential()
               .add(nn.SpatialConvolution(n_in, n_out, 3, 3, pad_w=1,
                                          pad_h=1, **b.kw))
               .add(nn.SpatialBatchNormalization(n_out, eps=1e-3,
                                                 device=b.device))
               .add(nn.ReLU()))
        if dropout and has_dropout:
            seq.add(nn.Dropout(dropout))
        return seq

    m = nn.Sequential(name="VggForCifar10")
    spec = [(3, 64, 0.3), (64, 64, None), ("pool",), (64, 128, 0.4),
            (128, 128, None), ("pool",), (128, 256, 0.4), (256, 256, 0.4),
            (256, 256, None), ("pool",), (256, 512, 0.4), (512, 512, 0.4),
            (512, 512, None), ("pool",), (512, 512, 0.4), (512, 512, 0.4),
            (512, 512, None), ("pool",)]
    for s in spec:
        if s[0] == "pool":
            m.add(nn.SpatialMaxPooling(2, 2, 2, 2))
        else:
            m.add(conv_bn(s[0], s[1], s[2]))
    (m.add(nn.Reshape((512,)))
      .add(nn.Dropout(0.5) if has_dropout else nn.Identity())
      .add(nn.Linear(512, 512, **b.kw))
      .add(nn.BatchNormalization(512, device=b.device))
      .add(nn.ReLU())
      .add(nn.Dropout(0.5) if has_dropout else nn.Identity())
      .add(nn.Linear(512, class_num, **b.kw))
      .add(nn.LogSoftMax()))
    return m
