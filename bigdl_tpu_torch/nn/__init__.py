"""Layers (counterpart of `bigdl_tpu.nn`): the transformer and the ResNet
paths."""

from bigdl_tpu_torch.nn.activation import LogSoftMax, ReLU
from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                          ScaledDotProductAttention,
                                          TransformerBlock, cache_commit,
                                          cache_write, rope)
from bigdl_tpu_torch.nn.containers import (CAddTable, ConcatTable, Container,
                                           Identity, Sequential)
from bigdl_tpu_torch.nn.conv import (SpaceToDepthStemConvolution,
                                     SpatialConvolution)
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.fusion import fusion_enabled, fusion_scope, set_fusion
from bigdl_tpu_torch.nn.initialization import (MsraFiller, RandomUniform,
                                               Xavier, Zeros)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.normalization import (BatchNormalization,
                                              LayerNormalization,
                                              SpatialBatchNormalization)
from bigdl_tpu_torch.nn.pooling import (Pooler, SpatialAveragePooling,
                                        SpatialMaxPooling)

__all__ = ["BatchNormalization", "CAddTable", "ClassNLLCriterion",
           "ConcatTable", "Container", "Identity", "LayerNormalization",
           "Linear", "LogSoftMax", "Module", "MsraFiller",
           "MultiHeadAttention", "Pooler", "RandomUniform", "ReLU",
           "ScaledDotProductAttention", "Sequential",
           "SpaceToDepthStemConvolution", "SpatialAveragePooling",
           "SpatialBatchNormalization", "SpatialConvolution",
           "SpatialMaxPooling", "TimeDistributedCriterion", "TransformerBlock",
           "Xavier", "Zeros",
           "cache_commit", "cache_write", "fusion_enabled", "fusion_scope",
           "rope", "set_fusion"]
