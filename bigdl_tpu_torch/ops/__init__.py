"""Ops with hand-written kernels (attention, the fused BN+ReLU tail, the
stem), the kernels' build helper, the forward-only `Operation` base and
the feature-column ops (counterpart of `bigdl_tpu.ops`)."""

from bigdl_tpu_torch.ops.attention_kernel import (attention_state_finish,
                                                  attention_state_init,
                                                  blockwise_attention,
                                                  flash_attention,
                                                  flash_attention_forward,
                                                  naive_attention)
from bigdl_tpu_torch.ops.bn_relu_kernel import (bn_relu, bn_relu_backward,
                                                bn_relu_forward)
from bigdl_tpu_torch.ops.feature_col import (BucketizedCol,
                                             CategoricalColHashBucket,
                                             CategoricalColVocaList,
                                             CrossCol, IndicatorCol,
                                             Kv2Tensor, MkString, Substr)
from bigdl_tpu_torch.ops.operation import Operation

__all__ = ["attention_state_finish", "attention_state_init",
           "blockwise_attention", "bn_relu", "bn_relu_backward",
           "bn_relu_forward", "flash_attention", "flash_attention_forward",
           "naive_attention", "BucketizedCol", "CategoricalColHashBucket",
           "CategoricalColVocaList", "CrossCol", "IndicatorCol", "Kv2Tensor",
           "MkString", "Operation", "Substr"]
