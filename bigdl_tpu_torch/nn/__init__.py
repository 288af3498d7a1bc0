"""Layers (counterpart of `bigdl_tpu.nn`): the transformer path only."""

from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                          ScaledDotProductAttention,
                                          TransformerBlock, cache_commit,
                                          cache_write, rope)
from bigdl_tpu_torch.nn.initialization import Xavier
from bigdl_tpu_torch.nn.normalization import LayerNormalization

__all__ = ["LayerNormalization", "MultiHeadAttention",
           "ScaledDotProductAttention", "TransformerBlock", "Xavier",
           "cache_commit", "cache_write", "rope"]
