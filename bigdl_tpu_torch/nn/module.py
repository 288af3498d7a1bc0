"""The port's layer base (counterpart of `bigdl_tpu/nn/module.py`).

A layer is a `torch.nn.Module`: parameters and buffers live on the module,
`train()` / `eval()` set the mode the JAX package passes as
`ApplyContext.training`, and autograd replaces `jax.grad`. What the base
adds is the reference's `name` (default: the class name), which the
containers use to key their children as the JAX package keys its parameter
tree and BN state (`"<index>_<name>"`), so the two trees line up one to one
(`interop/jax_params.py`).
"""

from __future__ import annotations

from typing import Optional

from torch import nn


class Module(nn.Module):
    """`torch.nn.Module` with the reference's `name`."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name or type(self).__name__

    def quantize(self, weight_only: bool = False) -> "Module":
        """Post-training int8 quantization of the supported layers
        (reference `Module.quantize`): a new model from
        `nn.quantized.Quantizer.quantize`, this one left intact.
        `weight_only=True` stores int8 weights and keeps bf16 / f32
        compute."""
        from bigdl_tpu_torch.nn.quantized import Quantizer
        return Quantizer.quantize(self, weight_only=weight_only)


def check_nhwc(data_format: str, layer: str) -> None:
    """The port's spatial layers take NHWC only; the reference's
    `data_format="NCHW"` (a transpose around the NHWC layer) is not
    ported and raises rather than being dropped."""
    if data_format != "NHWC":
        raise NotImplementedError(
            f"{layer}(data_format={data_format!r}) is not ported: the port's "
            "spatial layers take NHWC input")
