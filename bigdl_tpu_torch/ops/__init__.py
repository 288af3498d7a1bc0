"""Ops with hand-written kernels (attention, the fused BN+ReLU tail, the
stem), the kernels' build helper, the forward-only `Operation` base and
the feature-column ops (counterpart of `bigdl_tpu.ops`)."""

from bigdl_tpu_torch.ops.feature_col import (BucketizedCol,
                                             CategoricalColHashBucket,
                                             CategoricalColVocaList,
                                             CrossCol, IndicatorCol,
                                             Kv2Tensor, MkString, Substr)
from bigdl_tpu_torch.ops.operation import Operation

__all__ = ["BucketizedCol", "CategoricalColHashBucket",
           "CategoricalColVocaList", "CrossCol", "IndicatorCol", "Kv2Tensor",
           "MkString", "Operation", "Substr"]
