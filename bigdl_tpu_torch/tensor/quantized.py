"""Int8 quantized tensor (counterpart of `bigdl_tpu/tensor/quantized.py`,
the reference's `QuantizedTensor`, DL/tensor/QuantizedTensor.scala).

Symmetric int8 with max-abs scales, per tensor or per channel (the
BigQuant scheme's local scales). `matmul_t` quantizes x per row on the
fly and multiplies int8 x int8 -> int32 through `nn.quantized.int8_mm`
(`torch._int_mm`), then rescales once: the reference's MixPrecisionGEMM
contract (DL/nn/quantized/Linear.scala:79-92).
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.quantized import _quantize_activation, int8_mm


class QuantizedTensor:
    """Symmetric int8 tensor: value ~= data * scale; `channel_axis` None
    means one scale for the whole tensor."""

    def __init__(self, data, scale, channel_axis: Optional[int] = None):
        self.data = torch.as_tensor(data).to(torch.int8)
        self.scale = torch.as_tensor(scale, dtype=torch.float32,
                                     device=self.data.device)
        self.channel_axis = channel_axis
        self.shape = tuple(self.data.shape)

    @classmethod
    def from_float(cls, arr, channel_axis: Optional[int] = 0
                   ) -> "QuantizedTensor":
        """Symmetric max-abs quantization of `arr` (a tensor or array, as
        f32): per channel along `channel_axis` (the reference's local
        scheme), or per tensor for None."""
        x = torch.as_tensor(arr).float()
        if channel_axis is None:
            dims = tuple(range(x.dim()))
        else:
            dims = tuple(d for d in range(x.dim()) if d != channel_axis)
        q, scale = _quantize_activation(x, dims)
        return cls(q, scale if channel_axis is not None else scale.reshape(()),
                   channel_axis)

    def dequantize(self) -> torch.Tensor:
        return self.data.float() * self.scale

    def nElement(self) -> int:
        return self.data.numel()

    def matmul_t(self, x) -> torch.Tensor:
        """x [B, K] @ self[N, K].T -> [B, N] f32, x quantized per row."""
        if self.data.dim() != 2:
            raise ValueError("matmul_t expects a 2-D quantized weight")
        if self.channel_axis not in (None, 0):
            # per-K scales cannot be applied after the K-contraction
            raise ValueError(
                "matmul_t needs per-tensor or output-channel (axis 0) scales;"
                f" got channel_axis={self.channel_axis}")
        x = torch.as_tensor(x, device=self.data.device).float()
        xq, xs = _quantize_activation(x, (-1,))
        acc = int8_mm(xq, self.data.t())
        w_scale = self.scale.reshape(1, -1) \
            if self.channel_axis is not None else self.scale
        return acc.float() * xs * w_scale

    def __repr__(self):
        kind = ("per-tensor" if self.channel_axis is None
                else f"per-channel(axis={self.channel_axis})")
        return f"QuantizedTensor(shape={list(self.shape)}, {kind})"
