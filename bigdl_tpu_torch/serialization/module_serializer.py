"""The model-file format (counterpart of
`bigdl_tpu/serialization/module_serializer.py`): a module tree with typed
constructor attributes, parameters and BN state stored flat by path, and
tensor-storage dedup, in the reference's `ModelProto` (`proto/bigdl_model.py`,
the port's own codec: no protobuf package).

A file rebuilds the model from each layer's constructor record
(`nn/module.py` `_ctor_spec`: the reference's record, the port's device
and generator keywords left out), its children, its `name` and its mode
(`evaluating` is `not module.training`), then fills it:

- parameters in the JAX tree layout (`interop/jax_params.py`): conv
  kernels HWIO, each leaf at its "/"-joined path, in the tree's sorted key
  order; a bf16 leaf stored as its `uint16` view with dtype "bfloat16";
- the BN running statistics at the reference's `"<path>::mean"` /
  `"<path>::var"` keys;
- one storage per tensor object: a tied `nn.Parameter` is written once.

So the two packages read each other's files for the module types both
register. A `Graph` is written as the reference writes it: no
constructor arguments, its nodes in `exec_order` in the `graph` field,
each with its key, its module and its inputs' indices. Loading rebuilds
the nodes with the saved keys, so parameter paths survive the load
(node ids, per-process counters, differ); a `graph` field on a type that
is not a graph is ignored, as the reference ignores it. A `DynamicGraph`
is written so too, and refused on load: the format has no field for a
consumer's Switch port, and the reference cannot read its own such file
(its nodes come before their inputs). Loading matches
a saved path against the paths of the model it
rebuilds, so a layer name holding "/" (Inception's "conv1/7x7_s2") finds
its place; a saved leaf with no place is dropped with the reference's
warning. Refused as the reference refuses: an unregistered class
(`ValueError`), a constructor argument of a type the format has no field
for (`TypeError`, so `ResNet50`'s `MsraFiller` and Inception-v1's `Xavier`
refuse). A type the reference registers but the port lacks raises
`NotImplementedError` (`ROADMAP.md` queue 1 item 5).

    ModuleSerializer.save(model, "m.bigdl")
    model = ModuleSerializer.load("m.bigdl", device="cpu")   # default: CUDA
"""

from __future__ import annotations

import inspect
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.proto import bigdl_model as pb
from bigdl_tpu_torch.tensor.numeric import TensorNumeric

__all__ = ["ModuleSerializer", "register_module", "registered_modules",
           "FRAMEWORK_VERSION"]

FRAMEWORK_VERSION = "bigdl_tpu-0.1"

_ITEM5 = "ROADMAP.md queue 1 item 5"

# ------------------------------------------------------------------ registry
_REGISTRY: Dict[str, type] = {}
_SCANNED = False


def register_module(cls: type, name: Optional[str] = None):
    """Register a layer class under `name` (default: its class name)."""
    _REGISTRY[name or cls.__name__] = cls
    return cls


def _ensure_registry():
    global _SCANNED
    if _SCANNED:
        return
    _SCANNED = True
    import bigdl_tpu_torch.nn as nn
    import bigdl_tpu_torch.ops as ops
    from bigdl_tpu_torch.nn.module import Module
    for pkg in (nn, ops):
        for attr in dir(pkg):
            obj = getattr(pkg, attr)
            if isinstance(obj, type) and issubclass(obj, Module):
                _REGISTRY.setdefault(attr, obj)


def registered_modules() -> Dict[str, type]:
    """Registry key -> class: every `Module` subclass `bigdl_tpu_torch.nn`
    and `bigdl_tpu_torch.ops` export, and what `register_module` added."""
    _ensure_registry()
    return dict(_REGISTRY)


def _type_name(module) -> str:
    _ensure_registry()
    cls = type(module)
    for name, c in _REGISTRY.items():
        if c is cls:
            return name
    raise ValueError(
        f"{cls.__name__} is not a registered module type; call "
        "register_module() for custom layers before saving")


# ------------------------------------------------------------------ tensors
class _SaveCtx:
    def __init__(self):
        self.storages: Dict[int, int] = {}  # id(tensor object) -> storage id
        self.blobs: List[bytes] = []
        self._refs: List[Any] = []  # keep objects alive so ids stay unique

    def storage_id(self, obj, arr: np.ndarray) -> int:
        key = id(obj)
        if key not in self.storages:
            self.storages[key] = len(self.blobs)
            self.blobs.append(np.ascontiguousarray(arr).tobytes())
            self._refs.append(obj)
        return self.storages[key]


def _host_array(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A tensor's bytes as numpy and the file's dtype name (bf16 as its
    uint16 view)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16), \
            "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _encode_tensor(value, tp: pb.TensorProto, ctx: _SaveCtx, key=None):
    """Fill `tp`; `key` is the object the storage is deduped on (default:
    the value itself)."""
    if isinstance(value, torch.Tensor):
        arr, dtype = _host_array(value)
    else:
        arr = np.asarray(value)
        dtype = str(arr.dtype)
    tp.dtype = dtype
    tp.shape.extend(int(s) for s in arr.shape)
    tp.storage_id = ctx.storage_id(value if key is None else key, arr)


def _decode_array(tp: pb.TensorProto, storages: Dict[int, bytes]
                  ) -> np.ndarray:
    raw = storages[tp.storage_id]
    dtype = np.uint16 if tp.dtype == "bfloat16" else np.dtype(tp.dtype)
    return np.frombuffer(raw, dtype).reshape(tuple(tp.shape))


def _decode_tensor(tp: pb.TensorProto, storages: Dict[int, bytes],
                   device) -> torch.Tensor:
    arr = _decode_array(tp, storages)
    if tp.dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


# ------------------------------------------------------------------- attrs
def _encode_attr(value, av: pb.AttrValue, ctx: _SaveCtx):
    from bigdl_tpu_torch.nn.module import Module
    if value is None:
        av.none = True
    elif isinstance(value, bool):
        av.b = value
    elif isinstance(value, (int, np.integer)):
        av.i = int(value)
    elif isinstance(value, (float, np.floating)):
        av.d = float(value)
    elif isinstance(value, str):
        av.s = value
    elif isinstance(value, Module):
        av.module = pb.BigDLModule()
        _encode_module(value, av.module, ctx)
    elif isinstance(value, (list, tuple)):
        av.list = pb.ListValue()
        av.is_tuple = isinstance(value, tuple)
        for item in value:
            _encode_attr(item, av.list.items.add(), ctx)
    elif isinstance(value, (np.ndarray, torch.Tensor)):
        av.tensor = pb.TensorProto()
        _encode_tensor(value, av.tensor, ctx)
    elif isinstance(value, (np.dtype, torch.dtype)) or (
            isinstance(value, type) and issubclass(value, np.generic)):
        av.dtype = TensorNumeric.name_of(value)
    else:
        raise TypeError(
            f"cannot serialize constructor argument of type {type(value)}: "
            f"{value!r}")


class _LoadCtx:
    def __init__(self, storages: Dict[int, bytes], device):
        self.storages = storages
        self.device = device


def _decode_attr(av: pb.AttrValue, ctx: _LoadCtx):
    kind = av.WhichOneof("value")
    if kind == "none" or kind is None:
        return None
    if kind == "b":
        return av.b
    if kind == "i":
        return int(av.i)
    if kind == "d":
        return av.d
    if kind == "s":
        return av.s
    if kind == "module":
        return _decode_module(av.module, ctx)
    if kind == "list":
        items = [_decode_attr(x, ctx) for x in av.list.items]
        return tuple(items) if av.is_tuple else items
    if kind == "tensor":
        arr = _decode_array(av.tensor, ctx.storages)
        if av.tensor.dtype == "bfloat16":
            return torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        return arr.copy()
    if kind == "dtype":
        return TensorNumeric.dtype(av.dtype)
    raise ValueError(f"bad AttrValue kind {kind}")


# ------------------------------------------------------------------ modules
def _encode_module(module, bm: pb.BigDLModule, ctx: _SaveCtx):
    from bigdl_tpu_torch.nn.containers import Container, Graph
    bm.module_type = _type_name(module)
    bm.name = module.name
    bm.evaluating = not module.training
    if isinstance(module, Graph):
        # the wiring goes in the GraphDef; the (inputs, outputs) arguments
        # are nodes, not attributes
        bm.graph = pb.GraphDef()
        _encode_graph(module, bm.graph, ctx)
        return
    _, args, kwargs = getattr(module, "_ctor_spec",
                              (type(module).__name__, (), {}))
    for a in args:
        _encode_attr(a, bm.ctor_args.add(), ctx)
    for k, v in kwargs.items():
        bm.ctor_kwargs[k] = pb.AttrValue()
        _encode_attr(v, bm.ctor_kwargs[k], ctx)
    if isinstance(module, Container):
        # children added with .add(); on load, the ones the constructor
        # itself built are skipped by count
        for child in module.children_in_order():
            _encode_module(child, bm.children.add(), ctx)


def _encode_graph(graph, gd: pb.GraphDef, ctx: _SaveCtx):
    index = {id(n): i for i, n in enumerate(graph.exec_order)}
    for n in graph.exec_order:
        gn = gd.nodes.add(key=n.key, module=pb.BigDLModule())
        _encode_module(n.module, gn.module, ctx)
        gn.prev.extend(index[id(p)] for p in n.prev)
    gd.input_nodes.extend(index[id(n)] for n in graph.input_nodes)
    gd.output_nodes.extend(index[id(n)] for n in graph.output_nodes)


def _decode_graph(cls, bm: pb.BigDLModule, ctx: "_LoadCtx"):
    from bigdl_tpu_torch.nn.module import Node
    nodes: List[Node] = []
    for gn in bm.graph.nodes:
        node = Node(_decode_module(gn.module, ctx),
                    [nodes[i] for i in gn.prev])
        node.key = gn.key  # the saved key: parameter paths survive
        nodes.append(node)
    graph = cls([nodes[i] for i in bm.graph.input_nodes],
                [nodes[i] for i in bm.graph.output_nodes])
    graph.name = bm.name
    graph.training = not bm.evaluating
    return graph


def _takes_device(cls) -> bool:
    """Whether `cls(...)` takes the port's `device` keyword: in its own
    signature, or through `**kwargs` handed to a base that takes it."""
    for klass in cls.__mro__:
        init = klass.__dict__.get("__init__")
        if init is None:
            continue
        params = inspect.signature(init).parameters
        if "device" in params:
            return True
        if not any(p.kind == p.VAR_KEYWORD for p in params.values()):
            return False
    return False


def _decode_module(bm: pb.BigDLModule, ctx: _LoadCtx):
    from bigdl_tpu_torch.nn.containers import Container, Graph
    from bigdl_tpu_torch.serialization._reference_modules import (
        REFERENCE_ONLY)
    _ensure_registry()
    if bm.module_type not in _REGISTRY:
        if bm.module_type in REFERENCE_ONLY:
            raise NotImplementedError(
                f"{bm.module_type} is registered by the reference but not "
                f"ported yet ({_ITEM5})")
        raise ValueError(f"unknown module type: {bm.module_type}")
    cls = _REGISTRY[bm.module_type]
    if bm.HasField("graph") and issubclass(cls, Graph):
        from bigdl_tpu_torch.nn.dynamic_graph import DynamicGraph
        if issubclass(cls, DynamicGraph):
            raise NotImplementedError(
                "a DynamicGraph file cannot be read back: the format has "
                "no field for the Switch port each consumer reads "
                "(switch_port), and its nodes come before their inputs, "
                "which the reference's own load fails on too")
        return _decode_graph(cls, bm, ctx)
    args = [_decode_attr(a, ctx) for a in bm.ctor_args]
    kwargs = {k: _decode_attr(v, ctx) for k, v in bm.ctor_kwargs.items()}
    if _takes_device(cls):
        kwargs["device"] = ctx.device
    module = cls(*args, **kwargs)
    module.name = bm.name
    module.training = not bm.evaluating  # this module's flag alone
    if bm.children and isinstance(module, Container):
        pre_built = len(module.children_in_order())
        for child_pb in bm.children[pre_built:]:
            module.add(_decode_module(child_pb, ctx))
    return module


# ---------------------------------------------------------- parameter trees
def _flat_targets(module) -> List[Tuple[str, Any]]:
    """(path, target) of every parameter leaf of the module's JAX-layout
    tree, in the tree's sorted key order; a target is an `nn.Parameter` or
    a conv weight's `_HwioToOihw` marker."""
    from bigdl_tpu_torch.interop.jax_params import _module_targets
    out = []

    def walk(node, prefix):
        for key in sorted(node):
            path = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(node[key], dict):
                walk(node[key], path)
            else:
                out.append((path, node[key]))

    walk(_module_targets(module), "")
    return out


def _bn_modules(module) -> List[Tuple[str, Any]]:
    from bigdl_tpu_torch.interop.jax_params import _bn_modules
    return [("/".join(path), bn)
            for path, bn in _bn_modules(module).items()]  # module order


def _leaf_value(target) -> torch.Tensor:
    from bigdl_tpu_torch.interop.jax_params import _HwioToOihw
    if isinstance(target, _HwioToOihw):
        return target.param.detach().permute(2, 3, 1, 0)
    return target.detach()


def _leaf_param(target):
    from bigdl_tpu_torch.interop.jax_params import _HwioToOihw
    return target.param if isinstance(target, _HwioToOihw) else target


def _assign(target, value: torch.Tensor, where: str):
    """Set a parameter to a saved leaf (JAX layout), in the file's dtype
    and the parameter's own strides (a channels-last kernel stays so)."""
    from bigdl_tpu_torch.interop.jax_params import _HwioToOihw
    if isinstance(target, _HwioToOihw):
        value = value.permute(3, 2, 0, 1)
    p = _leaf_param(target)
    if tuple(value.shape) != tuple(p.shape):
        raise ValueError(f"{where}: saved shape {tuple(value.shape)} != "
                         f"model shape {tuple(p.shape)}")
    if value.dtype == p.dtype:
        p.copy_(value)
    else:
        p.data = torch.empty_like(p, dtype=value.dtype).copy_(value)


# -------------------------------------------------------------------- API
class ModuleSerializer:
    @staticmethod
    def save(module, path: str):
        """Serialize a module (construction + params + state) to `path`."""
        ctx = _SaveCtx()
        mp = pb.ModelProto(framework_version=FRAMEWORK_VERSION,
                           module=pb.BigDLModule())
        _encode_module(module, mp.module, ctx)
        for p, target in _flat_targets(module):
            nt = mp.parameters.add(path=p, tensor=pb.TensorProto())
            _encode_tensor(_leaf_value(target), nt.tensor, ctx,
                           key=_leaf_param(target))
        for prefix, bn in _bn_modules(module):
            for sub in ("mean", "var"):
                buf = getattr(bn, sub)
                nt = mp.state.add(path=f"{prefix}::{sub}",
                                  tensor=pb.TensorProto())
                _encode_tensor(buf, nt.tensor, ctx)
        for i, blob in enumerate(ctx.blobs):
            mp.storages.add(id=i, data=blob)
        from bigdl_tpu_torch.utils import filesystem as fsys
        with fsys.open_file(path, "wb") as f:
            f.write(mp.SerializeToString())

    @staticmethod
    def load(path: str, *, device=None):
        """Rebuild the module on `device` (default: the CUDA device; pass
        "cpu" to load on the CPU) and fill its parameters and BN state."""
        from bigdl_tpu_torch._device import resolve_device
        from bigdl_tpu_torch.utils import filesystem as fsys
        device = resolve_device(device)
        with fsys.open_file(path, "rb") as f:
            mp = pb.ModelProto.FromString(f.read())
        storages = {s.id: s.data for s in mp.storages}
        module = _decode_module(mp.module or pb.BigDLModule(),
                                _LoadCtx(storages, device))
        targets = dict(_flat_targets(module))
        bns = dict(_bn_modules(module))
        dropped: List[str] = []
        with torch.no_grad():
            for nt in mp.parameters:
                target = targets.get(nt.path)
                if target is None:
                    dropped.append(f"/{nt.path}")
                    continue
                _assign(target, _decode_tensor(nt.tensor, storages, device),
                        nt.path)
            for nt in mp.state:
                prefix, sub = nt.path.split("::", 1)
                bn = bns.get(prefix)
                if bn is None or sub not in ("mean", "var"):
                    dropped.append(nt.path)
                    continue
                value = _decode_tensor(nt.tensor, storages, device)
                buf = getattr(bn, sub)
                if tuple(value.shape) != tuple(buf.shape):
                    raise ValueError(f"{nt.path}: saved shape "
                                     f"{tuple(value.shape)} != model shape "
                                     f"{tuple(buf.shape)}")
                buf.copy_(value)
        if dropped:
            warnings.warn(
                f"ModuleSerializer.load: {len(dropped)} saved parameter "
                f"leaves have no slot in the reconstructed module and were "
                f"dropped: {dropped[:5]}{'...' if len(dropped) > 5 else ''}. "
                f"The loaded model will NOT match the saved one.",
                stacklevel=2)
        return module
