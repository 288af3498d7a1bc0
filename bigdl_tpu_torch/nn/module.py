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

Gradient gating (the reference's `freeze` / `stop_gradient`): a frozen
module's parameters, its sub-modules' included, reach its forward
detached, and a gradient-cut module's output leaves it detached. Both
hold at every call site, a module called inside a composite one too:
the first `freeze` or `stop_gradient` of a module installs a forward
pre-hook and an always-called forward hook on it (module-level functions,
so a `copy.deepcopy` carries them), which read the flags at each call.

The graph DSL: `layer.inputs(node, ...)` makes a `Node`, and
`nn.containers.Graph(inputs, outputs)` runs the nodes in `topo_sort`
order. `functional_apply` is the reference's pure entry point over
`torch.func.functional_call`: parameters and state in, `(output,
new_state)` out, the module's own tensors untouched.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

#: keyword-only parameters the port's layers add to the reference's, left
#: out of `_ctor_spec`
PORT_ONLY_KWARGS = frozenset({"device", "generator", "dropout_generator"})


Activity = Any  # a tensor, a `Table` or a list of them (the reference's)

#: bumped by every freeze / unfreeze / stop_gradient: a cached fusion plan
#: (`nn.containers.Graph`) that read the flags is stale once it moves
_GATE_EPOCH = [0]


def gate_epoch() -> int:
    """How many times a freeze or gradient-cut flag has been set."""
    return _GATE_EPOCH[0]


def _detach_tree(out):
    from bigdl_tpu_torch.utils.table import Table
    if isinstance(out, torch.Tensor):
        return out.detach()
    if isinstance(out, Table):
        cut = Table()
        for k, v in out._d.items():
            cut[k] = _detach_tree(v)
        return cut
    if isinstance(out, (list, tuple)):
        return type(out)(_detach_tree(v) for v in out)
    return out


def _gate_pre_hook(module, args):
    """A frozen module's parameters (its sub-modules' too) are swapped for
    detached views for the call; `_gate_post_hook` puts them back."""
    saved = []
    if module.__dict__.get("_frozen", False):
        for m in module.modules():
            for k, p in m._parameters.items():
                if p is not None:
                    saved.append((m, k, p))
                    m._parameters[k] = p.detach()
    module.__dict__.setdefault("_gate_saved", []).append(saved)


def _gate_post_hook(module, args, output):
    stack = module.__dict__.get("_gate_saved")
    if stack:
        for m, k, p in stack.pop():
            m._parameters[k] = p
    if module.__dict__.get("_stop_gradient", False):
        return _detach_tree(output)
    return None


class Module(nn.Module):
    """`torch.nn.Module` with the reference's `name`, constructor record,
    gradient gating and graph DSL."""

    _frozen = False
    _stop_gradient = False

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name or type(self).__name__

    # -- freeze / gradient gating (the reference's Module.freeze) -------- #
    def freeze(self, names: Optional[Sequence[str]] = None) -> "Module":
        """Freeze this module (or the named sub-modules, searched
        recursively): their parameters reach the forward detached at every
        call, so they get no gradient (zero through the optimizers'
        `materialize_grads`) and the fused BN tail skips them."""
        for m in self._modules_by_name(names):
            _set_gate(m, "_frozen", True)
        return self

    def unfreeze(self, names: Optional[Sequence[str]] = None) -> "Module":
        for m in self._modules_by_name(names):
            _set_gate(m, "_frozen", False)
        return self

    def stop_gradient(self, names: Sequence[str]) -> "Module":
        """Cut backprop at the named sub-modules (the reference's
        `Graph.stopGradient`): their outputs leave them detached, so
        neither they nor anything upstream of them receives a gradient
        through them."""
        for m in self._modules_by_name(list(names)):
            _set_gate(m, "_stop_gradient", True)
        return self

    def _modules_by_name(self, names: Optional[Sequence[str]]
                         ) -> List[nn.Module]:
        """This module for None, else every sub-module (itself included)
        whose `name` is in `names`; raises `KeyError` naming those none
        has."""
        if names is None:
            return [self]
        wanted = set(names)
        found = [m for m in self.modules()
                 if getattr(m, "name", None) in wanted]
        missing = wanted - {m.name for m in found}
        if missing:
            raise KeyError(f"no sub-module named {sorted(missing)}")
        return found

    # -- the graph DSL: layer.inputs(node, ...) -------------------------- #
    def inputs(self, *nodes) -> "Node":
        """A `Node` applying this module to the outputs of `nodes` (lists
        of nodes are flattened); several make a 1-based `Table` input."""
        flat: List[Node] = []
        for n in nodes:
            if isinstance(n, (list, tuple)):
                flat.extend(n)
            else:
                flat.append(n)
        return Node(self, flat)

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


def _set_gate(m: nn.Module, flag: str, value: bool) -> None:
    if value and not m.__dict__.get("_gate_hooked", False):
        m.register_forward_pre_hook(_gate_pre_hook)
        m.register_forward_hook(_gate_post_hook, always_call=True)
        m.__dict__["_gate_hooked"] = True
    m.__dict__[flag] = value
    _GATE_EPOCH[0] += 1


class Node:
    """A node of a model graph: a module and the nodes feeding it. `key`,
    `"<module name>_<id>"` from a process-wide counter (the reference's),
    is the name the `Graph` registers the module under."""

    _count = 0

    def __init__(self, module: nn.Module, prev: Sequence["Node"]):
        Node._count += 1
        self.id = Node._count
        self.module = module
        self.prev = list(prev)
        self.key = f"{module.name}_{self.id}"

    def __repr__(self):
        return f"Node({self.key})"


def topo_sort(outputs: Sequence[Node]) -> List[Node]:
    """The nodes that `outputs` depend on, each after its inputs: the
    reference's depth-first post-order (inputs in their `prev` order,
    outputs in theirs), walked with an explicit stack so a deep chain
    needs no recursion. Raises `ValueError("cycle detected in graph")`."""
    order: List[Node] = []
    seen = set()
    for out in outputs:
        if id(out) in seen:
            continue
        stack = [(out, iter(out.prev))]
        on_path = {id(out)}
        while stack:
            node, it = stack[-1]
            nxt = next(it, None)
            if nxt is None:
                stack.pop()
                on_path.discard(id(node))
                seen.add(id(node))
                order.append(node)
            elif id(nxt) in on_path:
                raise ValueError("cycle detected in graph")
            elif id(nxt) not in seen:
                on_path.add(id(nxt))
                stack.append((nxt, iter(nxt.prev)))
    return order


class ApplyContext:
    """The record of one `functional_apply` call: the mode, the generator
    lent to the dropout layers, the state read and the state written
    (`{module path tuple: {buffer name: tensor}}`, the reference's BN
    state keys). The port's modules never see it."""

    def __init__(self, training: bool = False,
                 rng: Optional[torch.Generator] = None,
                 state: Optional[Dict[Tuple[str, ...], Any]] = None):
        self.training = training
        self.generator = rng
        self.state = state or {}
        self.new_state: Dict[Tuple[str, ...], Any] = {}


def _flat_params(params: Mapping, prefix: str = "") -> Dict[str, Any]:
    """A nested parameter tree (the reference's keys) as the dotted names
    `functional_call` takes; dotted keys pass through."""
    out = {}
    for key, value in params.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(_flat_params(value, name))
        else:
            out[name] = value
    return out


def functional_apply(module: nn.Module, params: Mapping, input: Activity, *,
                     state: Optional[Dict] = None, training: bool = False,
                     rng: Optional[torch.Generator] = None):
    """`(output, new_state)` of `module` on `input` with the parameters of
    `params` (the nested tree of the module's parameters under the
    reference's keys, `{"0_Linear": {"weight": ..., "bias": ...}}`, or a
    flat `named_parameters()`-style dict; leaves absent from it are the
    module's own) through `torch.func.functional_call`, in `training`
    mode, the dropout layers drawing from `rng`. `state` gives buffers by
    module path (`{("0_BatchNormalization",): {"mean": t, "var": t}}`);
    paths that name no module are ignored, as the reference ignores them.
    The module's own tensors and those of `state` are left as they were:
    each buffer runs on a copy, and `new_state` holds the entries a
    buffer of which the call wrote (the BN running statistics in
    training)."""
    from torch.func import functional_call

    from bigdl_tpu_torch.ir.ir_graph import _is_orphan_state
    from bigdl_tpu_torch.nn.dropout import lend_generator
    ctx = ApplyContext(training=training, rng=rng, state=state)
    given = {}
    for path, entry in ctx.state.items():
        if not _is_orphan_state(module, tuple(path)):
            for k, v in entry.items():
                given[".".join(tuple(path) + (k,))] = v
    buffers = {name: given.get(name, b).clone()
               for name, b in module.named_buffers()}
    versions = {name: b._version for name, b in buffers.items()}
    modes = [(m, m.training) for m in module.modules()]
    module.train(training)
    try:
        with (lend_generator(rng) if rng is not None
              else contextlib.nullcontext()):
            out = functional_call(module, {**_flat_params(params),
                                           **buffers}, (input,))
    finally:
        for m, mode in modes:
            m.training = mode
    for name, b in buffers.items():
        if b._version != versions[name]:
            path, _, leaf = name.rpartition(".")
            key = tuple(path.split(".")) if path else ()
            ctx.new_state.setdefault(key, {})[leaf] = b
    return out, ctx.new_state


def merge_state(old: Dict, new: Dict) -> Dict:
    """`old` updated with `new`'s entries (the BN statistics after a
    step)."""
    merged = dict(old)
    merged.update(new)
    return merged


def param_count(params) -> int:
    """Total element count of a parameter tree (nested mappings or lists
    of tensors or arrays)."""
    if isinstance(params, Mapping):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    n = 1
    for s in params.shape:
        n *= int(s)
    return n


def check_nhwc(data_format: str, layer: str) -> None:
    """The port's spatial layers take NHWC only; the reference's
    `data_format="NCHW"` (a transpose around the NHWC layer) is not
    ported and raises rather than being dropped."""
    if data_format != "NHWC":
        raise NotImplementedError(
            f"{layer}(data_format={data_format!r}) is not ported: the port's "
            "spatial layers take NHWC input")
