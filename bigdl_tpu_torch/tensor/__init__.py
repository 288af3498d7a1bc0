"""Tensors (counterpart of `bigdl_tpu.tensor`): the COO `SparseTensor`
and `SparseTensorMath`. The Torch-style `Tensor` facade, `Storage`,
`QuantizedTensor` and `TensorNumeric` are not ported (`ROADMAP.md` queue
1 item 10)."""

from bigdl_tpu_torch.tensor.sparse import SparseTensor, SparseTensorMath

__all__ = ["SparseTensor", "SparseTensorMath"]
