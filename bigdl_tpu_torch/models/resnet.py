"""ResNet for ImageNet and CIFAR-10 (counterpart of
`bigdl_tpu/models/resnet.py`).

The same module tree as the reference, NHWC in and out: bottleneck and
basic blocks as `Sequential(ConcatTable(main, shortcut), CAddTable, ReLU)`,
shortcut types A/B/C, and the last BN of each block's main branch starting
at gamma = 0 (`zero_gamma`). Every BN immediately followed by a ReLU in a
`Sequential` runs as the fused tail (`nn/fusion.py`): in ResNet-50, the
stem's BN and bn1/bn2 of each of the 16 bottlenecks, 33 sites.

`remat=True` wraps every residual block in `nn.Remat`, as the reference
does: the blocks' activations are recomputed in the backward instead of
stored, so a training step runs each block's forward twice (32 of
ResNet-50's fused sites launch kernel 6 twice a step) for a lower peak
of memory. The CIFAR branch returns before it reads `remat`, as the
reference's does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.models._builder import Builder
from bigdl_tpu_torch.nn.initialization import MsraFiller


class _Builder(Builder):
    """Makes the layers of one model on one device from one generator."""

    def conv(self, n_in, n_out, k, stride=1, pad=None, name=None):
        if pad is None:
            pad = (k - 1) // 2
        return nn.SpatialConvolution(
            n_in, n_out, k, k, stride, stride, pad_w=pad, pad_h=pad,
            with_bias=False, weight_init=MsraFiller(), name=name,
            device=self.device, generator=self.g)

    def bn(self, n, zero_gamma=False, name=None):
        bn = nn.SpatialBatchNormalization(n, name=name, device=self.device)
        if zero_gamma:
            # residual branches start as the identity
            with torch.no_grad():
                bn.weight.zero_()
        return bn

    def shortcut(self, n_in, n_out, stride, shortcut_type="B"):
        if n_in != n_out or stride != 1:
            if shortcut_type in ("B", "C"):
                return (nn.Sequential()
                        .add(self.conv(n_in, n_out, 1, stride, 0))
                        .add(self.bn(n_out)))
            # type A: identity with zero-padded channels
            return (nn.Sequential()
                    .add(nn.SpatialAveragePooling(stride, stride, stride,
                                                  stride))
                    .add(_PadChannels(n_out - n_in)))
        return nn.Identity()


class _PadChannels(nn.Module):
    """Zero channels appended to an NHWC tensor."""

    def __init__(self, extra: int, name: Optional[str] = None):
        super().__init__(name)
        self.extra = extra

    def forward(self, x):
        return F.pad(x, (0, self.extra))


def _residual(b: _Builder, main, n_in, n_out, stride, shortcut_type):
    return (nn.Sequential()
            .add(nn.ConcatTable().add(main)
                 .add(b.shortcut(n_in, n_out, stride, shortcut_type)))
            .add(nn.CAddTable())
            .add(nn.ReLU()))


def basic_block(n_in, n_out, stride=1, shortcut_type="B", zero_gamma=True,
                *, device=None, generator=None):
    """3x3 -> BN -> ReLU -> 3x3 -> BN, plus the shortcut, then ReLU."""
    b = _Builder(device, generator)
    main = (nn.Sequential()
            .add(b.conv(n_in, n_out, 3, stride))
            .add(b.bn(n_out))
            .add(nn.ReLU())
            .add(b.conv(n_out, n_out, 3, 1))
            .add(b.bn(n_out, zero_gamma=zero_gamma)))
    return _residual(b, main, n_in, n_out, stride, shortcut_type)


def bottleneck(n_in, n_mid, stride=1, shortcut_type="B", zero_gamma=True,
               expansion=4, *, device=None, generator=None):
    """1x1 -> BN -> ReLU -> 3x3 (stride) -> BN -> ReLU -> 1x1 -> BN, plus
    the shortcut, then ReLU; n_mid * expansion channels out."""
    b = _Builder(device, generator)
    n_out = n_mid * expansion
    main = (nn.Sequential()
            .add(b.conv(n_in, n_mid, 1, 1, 0))
            .add(b.bn(n_mid))
            .add(nn.ReLU())
            .add(b.conv(n_mid, n_mid, 3, stride))
            .add(b.bn(n_mid))
            .add(nn.ReLU())
            .add(b.conv(n_mid, n_out, 1, 1, 0))
            .add(b.bn(n_out, zero_gamma=zero_gamma)))
    return _residual(b, main, n_in, n_out, stride, shortcut_type)


_IMAGENET_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def ResNet(class_num: int = 1000, depth: int = 50, shortcut_type: str = "B",
           data_set: str = "ImageNet", zero_gamma: bool = True,
           remat: bool = False, s2d_stem: bool = False, *, device=None,
           generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """[B, H, W, 3] NHWC images -> [B, class_num] log-probabilities, on
    `device` (default CUDA; `device="cpu"` for the CPU), weights drawn from
    `generator` (default seed 0). `s2d_stem=True` builds the stem as
    `SpaceToDepthStemConvolution` (same parameters and function as the
    plain 7x7/s2 stem). `remat=True` wraps every residual block in
    `nn.Remat` (ImageNet depths only, as the reference)."""
    b = _Builder(device, generator)
    if data_set.lower() in ("cifar10", "cifar-10"):
        return _cifar_resnet(class_num, depth, shortcut_type,
                             device=b.device, generator=b.g)
    kind, reps = _IMAGENET_CFG[depth]
    stem = (nn.SpaceToDepthStemConvolution(3, 64, 7, weight_init=MsraFiller(),
                                           name="conv1", device=b.device,
                                           generator=b.g)
            if s2d_stem else b.conv(3, 64, 7, 2, 3, name="conv1"))
    model = (nn.Sequential(name=f"ResNet{depth}")
             .add(stem)
             .add(b.bn(64))
             .add(nn.ReLU())
             .add(nn.SpatialMaxPooling(3, 3, 2, 2, pad_w=1, pad_h=1)))
    n_in = 64
    for stage, (w, r) in enumerate(zip([64, 128, 256, 512], reps)):
        for i in range(r):
            stride = 2 if (stage > 0 and i == 0) else 1
            if kind == "bottleneck":
                block = bottleneck(n_in, w, stride, shortcut_type,
                                   zero_gamma, device=b.device,
                                   generator=b.g)
                n_in = w * 4
            else:
                block = basic_block(n_in, w, stride, shortcut_type,
                                    zero_gamma, device=b.device,
                                    generator=b.g)
                n_in = w
            model.add(nn.Remat(block) if remat else block)
    model.add(nn.Pooler())
    model.add(nn.Linear(n_in, class_num, name="fc", device=b.device,
                        generator=b.g))
    model.add(nn.LogSoftMax())
    return model


def _cifar_resnet(class_num: int, depth: int, shortcut_type: str = "A", *,
                  device=None, generator=None):
    """CIFAR-10 ResNet of depth 6n+2 (16/32/64 channels, basic blocks)."""
    if (depth - 2) % 6:
        raise ValueError(f"CIFAR depth must be 6n+2, got {depth}")
    b = _Builder(device, generator)
    n = (depth - 2) // 6
    model = (nn.Sequential(name=f"ResNet{depth}-CIFAR")
             .add(b.conv(3, 16, 3, 1))
             .add(b.bn(16))
             .add(nn.ReLU()))
    n_in = 16
    for stage, w in enumerate([16, 32, 64]):
        for i in range(n):
            stride = 2 if (stage > 0 and i == 0) else 1
            model.add(basic_block(n_in, w, stride, shortcut_type,
                                  device=b.device, generator=b.g))
            n_in = w
    model.add(nn.Pooler())
    model.add(nn.Linear(64, class_num, device=b.device, generator=b.g))
    model.add(nn.LogSoftMax())
    return model


def ResNet50(class_num: int = 1000, **kw) -> nn.Sequential:
    return ResNet(class_num, depth=50, **kw)
