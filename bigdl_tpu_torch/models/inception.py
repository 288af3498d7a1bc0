"""Inception v1 (GoogLeNet) and v2 (BN-Inception) (counterpart of
`bigdl_tpu/models/inception.py`), NHWC.

The same module tree and names as the reference ("inception_3a/1x1",
"conv1/7x7_s2/bn", ...), so a module's path here is its path in the JAX
parameter tree and BN state. Each block is a `Concat` on the NHWC channel
axis; the auxiliary-head forms join their three [B, class_num] outputs on
the class axis (`Concat(axis=1)`).

- v1's stem with `s2d_stem=True` is a `SpaceToDepthStemConvolution` with
  a bias (kernel 5 when `BIGDL_TPU_PALLAS_STEM` is set or its
  `pallas_stem` is True).
- v2 has a BN -> ReLU pair after every convolution: 69 fused sites in
  `Inception_v2_NoAuxClassifier` (`nn/fusion.py`), each kernels 6 and 7
  once a training step.
"""

from __future__ import annotations

from typing import Optional

import torch

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.models._builder import Builder
from bigdl_tpu_torch.nn.initialization import Xavier


def _conv(b: Builder, n_in, n_out, k, stride=1, pad=0, name=None):
    return (nn.Sequential()
            .add(nn.SpatialConvolution(n_in, n_out, k, k, stride, stride,
                                       pad_w=pad, pad_h=pad,
                                       weight_init=Xavier(), name=name,
                                       **b.kw))
            .add(nn.ReLU()))


def _stem7(b: Builder, s2d: bool, name: str) -> nn.Sequential:
    """The 7x7/s2 stem; `s2d=True` builds it as the space-to-depth stem
    (the same parameters and function)."""
    if not s2d:
        return _conv(b, 3, 64, 7, 2, 3, name=name)
    conv = nn.SpaceToDepthStemConvolution(3, 64, 7, with_bias=True,
                                          weight_init=Xavier(), name=name,
                                          **b.kw)
    return nn.Sequential().add(conv).add(nn.ReLU())


def _module(b: Builder, n_in, c1, c3r, c3, c5r, c5, pool_proj, name):
    concat = nn.Concat(axis=3, name=name)
    concat.add(_conv(b, n_in, c1, 1, name=f"{name}1x1"))
    concat.add(nn.Sequential()
               .add(_conv(b, n_in, c3r, 1, name=f"{name}3x3reduce"))
               .add(_conv(b, c3r, c3, 3, pad=1, name=f"{name}3x3")))
    concat.add(nn.Sequential()
               .add(_conv(b, n_in, c5r, 1, name=f"{name}5x5reduce"))
               .add(_conv(b, c5r, c5, 5, pad=2, name=f"{name}5x5")))
    concat.add(nn.Sequential()
               .add(nn.SpatialMaxPooling(3, 3, 1, 1, pad_w=1, pad_h=1))
               .add(_conv(b, n_in, pool_proj, 1, name=f"{name}pool_proj")))
    return concat


def inception_module(n_in, c1, c3r, c3, c5r, c5, pool_proj, name="", *,
                     device=None, generator: Optional[torch.Generator] = None
                     ) -> nn.Concat:
    """One Inception block: 1x1, 3x3 reduce + 3x3, 5x5 reduce + 5x5, and
    3x3 max pool + 1x1 projection, joined on the channel axis."""
    return _module(Builder(device, generator), n_in, c1, c3r, c3, c5r, c5,
                   pool_proj, name)


def _v1_head(b: Builder, m: nn.Sequential, s2d_stem: bool) -> nn.Sequential:
    """The stem and the blocks up to inception_4a, added to `m`."""
    return (m.add(_stem7(b, s2d_stem, name="conv1/7x7_s2"))
            .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
            .add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75))
            .add(_conv(b, 64, 64, 1, name="conv2/3x3_reduce"))
            .add(_conv(b, 64, 192, 3, pad=1, name="conv2/3x3"))
            .add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75))
            .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
            .add(_module(b, 192, 64, 96, 128, 16, 32, 32, "inception_3a/"))
            .add(_module(b, 256, 128, 128, 192, 32, 96, 64,
                         "inception_3b/"))
            .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
            .add(_module(b, 480, 192, 96, 208, 16, 48, 64,
                         "inception_4a/")))


def _v1_tail(b: Builder, m: nn.Sequential, class_num: int,
             has_dropout: bool) -> nn.Sequential:
    """inception_5a onwards: the average pool, dropout and classifier."""
    (m.add(_module(b, 832, 256, 160, 320, 32, 128, 128, "inception_5a/"))
      .add(_module(b, 832, 384, 192, 384, 48, 128, 128, "inception_5b/"))
      .add(nn.SpatialAveragePooling(7, 7, 1, 1)))
    if has_dropout:
        m.add(nn.Dropout(0.4))
    return (m.add(nn.Reshape((1024,)))
            .add(nn.Linear(1024, class_num, name="loss3/classifier", **b.kw))
            .add(nn.LogSoftMax()))


def Inception_v1_NoAuxClassifier(class_num: int = 1000,
                                 has_dropout: bool = True,
                                 s2d_stem: bool = False, *, device=None,
                                 generator: Optional[torch.Generator] = None
                                 ) -> nn.Sequential:
    """[B, 224, 224, 3] -> [B, class_num] log-probabilities, on `device`
    (default CUDA), weights from `generator` (default seed 0)."""
    b = Builder(device, generator)
    m = _v1_head(b, nn.Sequential(name="Inception_v1"), s2d_stem)
    (m.add(_module(b, 512, 160, 112, 224, 24, 64, 64, "inception_4b/"))
      .add(_module(b, 512, 128, 128, 256, 24, 64, 64, "inception_4c/"))
      .add(_module(b, 512, 112, 144, 288, 32, 64, 64, "inception_4d/"))
      .add(_module(b, 528, 256, 160, 320, 32, 128, 128, "inception_4e/"))
      .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil()))
    return _v1_tail(b, m, class_num, has_dropout)


def _aux_head(b: Builder, n_in: int, class_num: int, side: int, name: str,
              has_dropout: bool = True) -> nn.Sequential:
    m = (nn.Sequential(name=name)
         .add(nn.SpatialAveragePooling(5, 5, 3, 3).ceil())
         .add(_conv(b, n_in, 128, 1, name=f"{name}conv"))
         .add(nn.Reshape((128 * side * side,)))
         .add(nn.Linear(128 * side * side, 1024, name=f"{name}fc", **b.kw))
         .add(nn.ReLU()))
    if has_dropout:
        m.add(nn.Dropout(0.7))
    return (m.add(nn.Linear(1024, class_num, name=f"{name}classifier",
                            **b.kw))
            .add(nn.LogSoftMax()))


def Inception_v1(class_num: int = 1000, has_dropout: bool = True,
                 s2d_stem: bool = False, *, device=None,
                 generator: Optional[torch.Generator] = None
                 ) -> nn.Sequential:
    """The training form with the two auxiliary heads: [B, 3 * class_num]
    = (main, aux2, aux1) joined on the class axis."""
    b = Builder(device, generator)
    feature1 = _v1_head(b, nn.Sequential(name="feature1"), s2d_stem)
    output1 = _aux_head(b, 512, class_num, 4, "loss1/", has_dropout)
    feature2 = (nn.Sequential(name="feature2")
                .add(_module(b, 512, 160, 112, 224, 24, 64, 64,
                             "inception_4b/"))
                .add(_module(b, 512, 128, 128, 256, 24, 64, 64,
                             "inception_4c/"))
                .add(_module(b, 512, 112, 144, 288, 32, 64, 64,
                             "inception_4d/")))
    output2 = _aux_head(b, 528, class_num, 4, "loss2/", has_dropout)
    output3 = (nn.Sequential(name="output3")
               .add(_module(b, 528, 256, 160, 320, 32, 128, 128,
                            "inception_4e/"))
               .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil()))
    output3 = _v1_tail(b, output3, class_num, has_dropout)
    split2 = nn.Concat(axis=1, name="split2").add(output3).add(output2)
    main_branch = nn.Sequential().add(feature2).add(split2)
    split1 = nn.Concat(axis=1, name="split1").add(main_branch).add(output1)
    return nn.Sequential(name="Inception_v1_aux").add(feature1).add(split1)


# ---------------------------------------------------------------- v2 (BN)
def _conv_bn(b: Builder, n_in, n_out, k, stride=1, pad=0, name=None):
    """Convolution, BN (eps 1e-3), ReLU: one fused site."""
    return (nn.Sequential()
            .add(nn.SpatialConvolution(n_in, n_out, k, k, stride, stride,
                                       pad_w=pad, pad_h=pad, name=name,
                                       **b.kw))
            .add(nn.SpatialBatchNormalization(n_out, eps=1e-3,
                                              name=f"{name}/bn",
                                              device=b.device))
            .add(nn.ReLU()))


def _layer_v2(b: Builder, n_in, c1, c3, d3, pool, name):
    c3r, c3o = c3
    d3r, d3o = d3
    pool_type, pool_proj = pool
    reduction = pool_type == "max" and pool_proj == 0
    s = 2 if reduction else 1
    concat = nn.Concat(axis=3, name=f"{name}output")
    if c1:
        concat.add(_conv_bn(b, n_in, c1, 1, name=f"{name}1x1"))
    concat.add(nn.Sequential()
               .add(_conv_bn(b, n_in, c3r, 1, name=f"{name}3x3_reduce"))
               .add(_conv_bn(b, c3r, c3o, 3, stride=s, pad=1,
                             name=f"{name}3x3")))
    concat.add(nn.Sequential()
               .add(_conv_bn(b, n_in, d3r, 1,
                             name=f"{name}double3x3_reduce"))
               .add(_conv_bn(b, d3r, d3o, 3, pad=1,
                             name=f"{name}double3x3a"))
               .add(_conv_bn(b, d3o, d3o, 3, stride=s, pad=1,
                             name=f"{name}double3x3b")))
    pool_branch = nn.Sequential()
    if pool_type == "max":
        if pool_proj:
            pool_branch.add(nn.SpatialMaxPooling(3, 3, 1, 1, pad_w=1,
                                                 pad_h=1).ceil())
        else:
            pool_branch.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    else:
        pool_branch.add(nn.SpatialAveragePooling(3, 3, 1, 1, pad_w=1,
                                                 pad_h=1).ceil())
    if pool_proj:
        pool_branch.add(_conv_bn(b, n_in, pool_proj, 1,
                                 name=f"{name}pool_proj"))
    concat.add(pool_branch)
    return concat


def inception_layer_v2(n_in, c1, c3, d3, pool, name="", *, device=None,
                       generator: Optional[torch.Generator] = None
                       ) -> nn.Concat:
    """One BN-Inception block. c1: the 1x1 width (0: no such branch); c3:
    (reduce, out) of the 3x3 branch; d3: (reduce, out) of the double 3x3;
    pool: (type, proj), type "avg" or "max", proj 0 with "max" making the
    stride-2 reduction block (3x3 branches at stride 2, a bare max
    pool)."""
    return _layer_v2(Builder(device, generator), n_in, c1, c3, d3, pool,
                     name)


def _v2_stem(b: Builder, name: str) -> nn.Sequential:
    m = nn.Sequential()
    m.name = name  # named after construction, as the reference's (its
    # model file records no name argument)
    return (m.add(_conv_bn(b, 3, 64, 7, 2, 3, name="conv1/7x7_s2"))
            .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
            .add(_conv_bn(b, 64, 64, 1, name="conv2/3x3_reduce"))
            .add(_conv_bn(b, 64, 192, 3, pad=1, name="conv2/3x3"))
            .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil()))


def _v2_3abc(b: Builder, m: nn.Sequential) -> nn.Sequential:
    return (m.add(_layer_v2(b, 192, 64, (64, 64), (64, 96), ("avg", 32),
                            "inception_3a/"))
            .add(_layer_v2(b, 256, 64, (64, 96), (64, 96), ("avg", 64),
                           "inception_3b/"))
            .add(_layer_v2(b, 320, 0, (128, 160), (64, 96), ("max", 0),
                           "inception_3c/")))


def _v2_4(b: Builder, m: nn.Sequential) -> nn.Sequential:
    return (m.add(_layer_v2(b, 576, 224, (64, 96), (96, 128), ("avg", 128),
                            "inception_4a/"))
            .add(_layer_v2(b, 576, 192, (96, 128), (96, 128), ("avg", 128),
                           "inception_4b/"))
            .add(_layer_v2(b, 576, 160, (128, 160), (128, 160), ("avg", 96),
                           "inception_4c/"))
            .add(_layer_v2(b, 576, 96, (128, 192), (160, 192), ("avg", 96),
                           "inception_4d/"))
            .add(_layer_v2(b, 576, 0, (128, 192), (192, 256), ("max", 0),
                           "inception_4e/")))


def _v2_5(b: Builder, m: nn.Sequential, class_num: int) -> nn.Sequential:
    return (m.add(_layer_v2(b, 1024, 352, (192, 320), (160, 224),
                            ("avg", 128), "inception_5a/"))
            .add(_layer_v2(b, 1024, 352, (192, 320), (192, 224),
                           ("max", 128), "inception_5b/"))
            .add(nn.SpatialAveragePooling(7, 7, 1, 1).ceil())
            .add(nn.Reshape((1024,)))
            .add(nn.Linear(1024, class_num, name="loss3/classifier", **b.kw))
            .add(nn.LogSoftMax()))


def Inception_v2_NoAuxClassifier(class_num: int = 1000, *, device=None,
                                 generator: Optional[torch.Generator] = None
                                 ) -> nn.Sequential:
    """[B, 224, 224, 3] -> [B, class_num] log-probabilities, on `device`
    (default CUDA), weights from `generator` (default seed 0)."""
    b = Builder(device, generator)
    m = _v2_3abc(b, _v2_stem(b, "Inception_v2"))
    return _v2_5(b, _v2_4(b, m), class_num)


def _v2_aux_head(b: Builder, n_in, class_num, side, name):
    return (nn.Sequential(name=name)
            .add(nn.SpatialAveragePooling(5, 5, 3, 3).ceil())
            .add(_conv_bn(b, n_in, 128, 1, name=f"{name}conv"))
            .add(nn.Reshape((128 * side * side,)))
            .add(nn.Linear(128 * side * side, 1024, name=f"{name}fc",
                           **b.kw))
            .add(nn.ReLU())
            .add(nn.Linear(1024, class_num, name=f"{name}classifier",
                           **b.kw))
            .add(nn.LogSoftMax()))


def Inception_v2(class_num: int = 1000, *, device=None,
                 generator: Optional[torch.Generator] = None
                 ) -> nn.Sequential:
    """The training form with both BN auxiliary heads: [B, 3 * class_num]
    = (main, aux2, aux1) joined on the class axis."""
    b = Builder(device, generator)
    features1 = _v2_3abc(b, _v2_stem(b, "features1"))
    output1 = _v2_aux_head(b, 576, class_num, 4, "loss1/")
    features2 = _v2_4(b, nn.Sequential(name="features2"))
    output2 = _v2_aux_head(b, 1024, class_num, 2, "loss2/")
    output3 = _v2_5(b, nn.Sequential(name="output3"), class_num)
    split2 = nn.Concat(axis=1, name="split2").add(output3).add(output2)
    main_branch = nn.Sequential().add(features2).add(split2)
    split1 = nn.Concat(axis=1, name="split1").add(main_branch).add(output1)
    return (nn.Sequential(name="Inception_v2_aux")
            .add(features1).add(split1))
