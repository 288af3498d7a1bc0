"""Tensors (counterpart of `bigdl_tpu.tensor`): the COO `SparseTensor`
and `SparseTensorMath`, the int8 `QuantizedTensor` and `TensorNumeric`.
The Torch-style `Tensor` facade and `Storage` are not ported
(`ROADMAP.md` queue 1 item 10)."""

from bigdl_tpu_torch.tensor.numeric import TensorNumeric
from bigdl_tpu_torch.tensor.quantized import QuantizedTensor
from bigdl_tpu_torch.tensor.sparse import SparseTensor, SparseTensorMath

__all__ = ["QuantizedTensor", "SparseTensor", "SparseTensorMath",
           "TensorNumeric"]
