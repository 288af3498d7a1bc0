"""The port's layer base (counterpart of `bigdl_tpu/nn/module.py`).

A layer is a `torch.nn.Module`: parameters and buffers live on the module,
`train()` / `eval()` set the mode the JAX package passes as
`ApplyContext.training`, and autograd replaces `jax.grad`. What the base
adds is the reference's `name` (default: the class name), which the
containers use to key their children as the JAX package keys its parameter
tree and BN state (`"<index>_<name>"`), so the two trees line up one to one
(`interop/jax_params.py`).

Each subclass's `__init__` also records how it was called, as the
reference's does: the outermost call sets `_ctor_spec = (class name,
args, kwargs)`, the record the model-file format
(`serialization/module_serializer.py`) rebuilds a layer from. The port's
own keywords (`PORT_ONLY_KWARGS`: the device and the weight generators)
stay out of it, so both packages record the same spec for the same call.
"""

from __future__ import annotations

import functools
import inspect
from typing import Optional

from torch import nn

#: keyword-only parameters the port's layers add to the reference's, left
#: out of `_ctor_spec`
PORT_ONLY_KWARGS = frozenset({"device", "generator", "dropout_generator"})


class Module(nn.Module):
    """`torch.nn.Module` with the reference's `name` and constructor
    record."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name or type(self).__name__

    def __init_subclass__(cls, **kwargs):
        """Wrap the subclass's own `__init__` so the outermost call records
        `_ctor_spec` (the reference's `Module.__init_subclass__`)."""
        super().__init_subclass__(**kwargs)
        orig = cls.__dict__.get("__init__")
        if orig is None or getattr(orig, "_ctor_capture", False):
            return

        @functools.wraps(orig)
        def wrapper(self, *args, **kw):
            if "_ctor_spec" not in self.__dict__:
                object.__setattr__(self, "_ctor_spec", (
                    type(self).__name__, args,
                    {k: v for k, v in kw.items()
                     if k not in PORT_ONLY_KWARGS}))
            orig(self, *args, **kw)

        wrapper._ctor_capture = True
        cls.__init__ = wrapper

    def _record_ctor_arg(self, name: str, value) -> None:
        """Set constructor argument `name` to `value` in `_ctor_spec`, for
        a builder that changes what the constructor set: in place where
        the call bound it positionally, else as a keyword."""
        spec = self.__dict__.get("_ctor_spec")
        if spec is None:
            return
        cls_name, args, kwargs = spec
        positional = [p.name for p in list(inspect.signature(
            type(self).__init__).parameters.values())[1:]
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
        if name in positional and positional.index(name) < len(args):
            args = list(args)
            args[positional.index(name)] = value
            args = tuple(args)
        else:
            kwargs = {**kwargs, name: value}
        object.__setattr__(self, "_ctor_spec", (cls_name, args, kwargs))

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
