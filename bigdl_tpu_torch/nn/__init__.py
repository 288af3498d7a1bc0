"""Layers (counterpart of `bigdl_tpu.nn`): the transformer, the ResNet and
the feed-forward model zoo's paths."""

from bigdl_tpu_torch.nn.activation import LogSoftMax, ReLU, Sigmoid, Tanh
from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                          ScaledDotProductAttention,
                                          TransformerBlock, cache_commit,
                                          cache_write, rope)
from bigdl_tpu_torch.nn.containers import (CAddTable, Concat, ConcatTable,
                                           Container, Identity, Sequential)
from bigdl_tpu_torch.nn.conv import (SpaceToDepthStemConvolution,
                                     SpatialConvolution)
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion, MSECriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.dropout import Dropout, lend_generator
from bigdl_tpu_torch.nn.fusion import fusion_enabled, fusion_scope, set_fusion
from bigdl_tpu_torch.nn.initialization import (MsraFiller, RandomUniform,
                                               Xavier, Zeros)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.normalization import (BatchNormalization,
                                              LayerNormalization,
                                              SpatialBatchNormalization)
from bigdl_tpu_torch.nn.pooling import (Pooler, SpatialAveragePooling,
                                        SpatialCrossMapLRN, SpatialMaxPooling)
from bigdl_tpu_torch.nn.shape_ops import Reshape

__all__ = ["BatchNormalization", "CAddTable", "ClassNLLCriterion", "Concat",
           "ConcatTable", "Container", "Dropout", "Identity",
           "LayerNormalization", "Linear", "LogSoftMax", "MSECriterion",
           "Module", "MsraFiller", "MultiHeadAttention", "Pooler",
           "RandomUniform", "ReLU", "Reshape", "ScaledDotProductAttention",
           "Sequential", "Sigmoid", "SpaceToDepthStemConvolution",
           "SpatialAveragePooling", "SpatialBatchNormalization",
           "SpatialConvolution", "SpatialCrossMapLRN", "SpatialMaxPooling",
           "Tanh", "TimeDistributedCriterion", "TransformerBlock", "Xavier",
           "Zeros", "cache_commit", "cache_write", "fusion_enabled",
           "fusion_scope", "lend_generator", "rope", "set_fusion"]
