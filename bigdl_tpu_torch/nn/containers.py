"""Containers (counterpart of `bigdl_tpu/nn/containers.py`).

`Sequential` (with the BN->ReLU matcher), `ConcatTable`, `Concat`,
`ParallelTable`, `MapTable` and `Bottle`; the table layers (`CAddTable`
and its family, `JoinTable`, `SplitTable`, `FlattenTable`,
`SelectTable`, `NarrowTable`, `MixtureTable`, `BifurcateSplitTable`),
`Identity` and `Echo`; `Remat` (activation recomputation); and the
static graph, `Graph` (alias `StaticGraph`) with `Input` / `InputNode`.

Children are registered under the reference's keys, `"<index>_<child
name>"` (a `Graph`: each node's `key`), so a module's path in the port
(`named_modules`, split on ".") is its path in the JAX package's
parameter tree and BN state. Table outputs are the 1-based `Table`
(`utils/table.py`), as the reference's; axes are 0-based, as the
reference's.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from bigdl_tpu_torch.nn.module import Module, Node, gate_epoch, topo_sort
from bigdl_tpu_torch.utils.table import T, Table


class Container(Module):
    """Holds child modules in order, keyed `"<index>_<name>"`."""

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)

    def add(self, module: Module) -> "Container":
        self.add_module(f"{len(self._modules)}_{module.name}", module)
        return self

    def children_in_order(self) -> List[Module]:
        return list(self._modules.values())


class Sequential(Container):
    """Feed-forward chain of children. A fusible BN child immediately
    followed by a fusible ReLU child runs as one fused tail (`nn/fusion.py`)
    while fusion is on; the ReLU child, which holds nothing, is skipped."""

    def forward(self, x):
        from bigdl_tpu_torch.nn.fusion import (fusible_activation, fusible_bn,
                                               fusion_enabled)
        fuse = fusion_enabled()
        children = self.children_in_order()
        i, n = 0, len(children)
        while i < n:
            child = children[i]
            if fuse and i + 1 < n and fusible_bn(child) \
                    and fusible_activation(children[i + 1]):
                x = child.forward_with_activation(x)
                i += 2
                continue
            x = child(x)
            i += 1
        return x


class ConcatTable(Container):
    """Each child applied to the same input; a 1-based `Table` of their
    outputs (`out[1]` is the first child's)."""

    def forward(self, x):
        return T(*[child(x) for child in self.children_in_order()])


class Concat(Container):
    """Each child applied to the same input, the outputs joined along
    `axis` (0-based, as the reference's): 3 is the NHWC channel axis of an
    Inception block, 1 the class axis of the auxiliary heads. Autograd
    hands each child a slice of the joined gradient, a strided view."""

    def __init__(self, axis: int = 1, name: Optional[str] = None):
        super().__init__(name)
        self.axis = axis

    def forward(self, x):
        return torch.cat([child(x) for child in self.children_in_order()],
                         dim=self.axis)


class ParallelTable(Container):
    """Child i applied to input entry i (a `Table` or a sequence); a
    `Table` of the outputs."""

    def forward(self, xs):
        children = self.children_in_order()
        return T(*[children[i](x) for i, x in enumerate(xs)])


class MapTable(Container):
    """The one child applied to every input entry; a `Table` of the
    outputs."""

    def forward(self, xs):
        child = self.children_in_order()[0]
        return T(*[child(x) for x in xs])


class Bottle(Container):
    """The leading dims folded into one so `module` sees an
    `n_input_dim`-D input (batch included), then restored."""

    def __init__(self, module: Module, n_input_dim: int = 2,
                 name: Optional[str] = None):
        super().__init__(name)
        self.add(module)
        if n_input_dim < 1:
            raise ValueError("n_input_dim must be >= 1")
        self.n_input_dim = n_input_dim

    def forward(self, x):
        child = self.children_in_order()[0]
        shape = tuple(x.shape)
        if len(shape) <= self.n_input_dim:
            return child(x)
        trail = self.n_input_dim - 1
        lead = shape[:len(shape) - trail]
        y = child(x.reshape((-1,) + shape[len(shape) - trail:]))
        return y.reshape(lead + tuple(y.shape[1:]))


class Remat(Container):
    """Recompute the wrapped module's activations in the backward instead
    of storing them (the reference's `jax.checkpoint` wrapper): training
    mode with grad enabled runs the child under
    `torch.utils.checkpoint.checkpoint(use_reentrant=False)`, which keeps
    only the child's input; eval mode or no grad runs it directly.

    The reference recomputes a pure function; the port's recompute
    re-runs modules that write state and draw random numbers, so it
    replays the forward as it was (`_Replay`): the parameter tensors the
    forward used (a `functional_call`'s bf16 copies, say, which are gone
    from the modules by the backward), each module's training flag, and
    the lent dropout generator's state before the forward, put back
    afterwards as the forward left it; and it writes the buffers of
    throwaway copies, so BN's running statistics move once a step, as
    without `Remat`. The result is the unwrapped module's, bit for bit,
    its kernel launches aside (the recompute launches the forward's
    again)."""

    def __init__(self, module: Module, name: Optional[str] = None):
        super().__init__(name)
        self.add(module)

    def forward(self, x):
        child = self.children_in_order()[0]
        if not (self.training and torch.is_grad_enabled()):
            return child(x)
        from torch.utils.checkpoint import checkpoint
        replay = _Replay(child)
        return checkpoint(replay.run, x, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=replay.contexts)


class _Replay:
    """What one `Remat` forward ran with, for its recompute: the child's
    parameter and buffer tensors, the sub-modules' training flags, and the
    state of the lent dropout generator before the forward (taken only
    when an active `Dropout` in the child will draw)."""

    def __init__(self, child: Module):
        from bigdl_tpu_torch.nn import dropout
        self.child = child
        self.params = dict(child.named_parameters())
        self.buffers = dict(child.named_buffers())
        self.modes = [(m, m.training) for m in child.modules()]
        self.generator = self.state = None
        if dropout._LENT and any(isinstance(m, dropout.Dropout)
                                 and m.training and m.p > 0.0
                                 for m in child.modules()):
            self.generator = dropout._lent()
            self.state = self.generator.get_state()
        self.recomputing = False

    def run(self, x):
        if not self.recomputing:
            return self.child(x)
        from torch.func import functional_call
        tensors = {**self.params,
                   **{k: b.clone() for k, b in self.buffers.items()}}
        return functional_call(self.child, tensors, (x,))

    def contexts(self):
        return contextlib.nullcontext(), self._recompute()

    @contextlib.contextmanager
    def _recompute(self):
        from bigdl_tpu_torch.nn.dropout import lend_generator
        now = [(m, m.training) for m, _ in self.modes]
        gen = self.generator
        after = gen.get_state() if gen is not None else None
        for m, mode in self.modes:
            m.training = mode
        self.recomputing = True
        try:
            if gen is None:
                yield
            else:
                gen.set_state(self.state)
                with lend_generator(gen):
                    yield
        finally:
            self.recomputing = False
            for m, mode in now:
                m.training = mode
            if gen is not None:
                gen.set_state(after)


class _TableReduce(Module):
    """Folds a `Table` of tensors (or any sequence of them), its values in
    key order, with `_reduce`."""

    def _reduce(self, a, b):
        raise NotImplementedError

    def forward(self, xs):
        vals = list(xs)
        out = vals[0]
        for v in vals[1:]:
            out = self._reduce(out, v)
        return out


class CAddTable(_TableReduce):
    """Elementwise sum of a `Table` of tensors."""

    def _reduce(self, a, b):
        return a + b


class CSubTable(_TableReduce):
    """Elementwise difference of two `Table` entries."""

    def _reduce(self, a, b):
        return a - b


class CMulTable(_TableReduce):
    """Elementwise product of a `Table` of tensors."""

    def _reduce(self, a, b):
        return a * b


class CDivTable(_TableReduce):
    """Elementwise quotient of two `Table` entries."""

    def _reduce(self, a, b):
        return a / b


class CMaxTable(_TableReduce):
    """Elementwise maximum of a `Table` of tensors."""

    def _reduce(self, a, b):
        return torch.maximum(a, b)


class CMinTable(_TableReduce):
    """Elementwise minimum of a `Table` of tensors."""

    def _reduce(self, a, b):
        return torch.minimum(a, b)


class CAveTable(Module):
    """Elementwise mean of a `Table` of tensors."""

    def forward(self, xs):
        vals = list(xs)
        return sum(vals) / float(len(vals))


class JoinTable(Module):
    """The entries of a `Table` joined along `axis` (0-based)."""

    def __init__(self, axis: int = 1, name: Optional[str] = None):
        super().__init__(name)
        self.axis = axis

    def forward(self, xs):
        return torch.cat(list(xs), dim=self.axis)


class SplitTable(Module):
    """A tensor split along `axis` into a `Table` of its slices, the axis
    dropped."""

    def __init__(self, axis: int = 1, name: Optional[str] = None):
        super().__init__(name)
        self.axis = axis

    def forward(self, x):
        return T(*torch.unbind(x, dim=self.axis))


class FlattenTable(Module):
    """Nested `Table`s flattened into one, depth first."""

    def forward(self, xs):
        flat = []

        def walk(t):
            if isinstance(t, Table):
                for v in t:
                    walk(v)
            else:
                flat.append(t)

        walk(xs)
        return T(*flat)


class SelectTable(Module):
    """Entry `index` of a `Table`: 1-based, or from the end when
    negative."""

    def __init__(self, index: int, name: Optional[str] = None):
        super().__init__(name)
        self.index = index

    def forward(self, xs):
        vals = list(xs)
        return vals[self.index - 1 if self.index > 0 else self.index]


class NarrowTable(Module):
    """The `length` entries of a `Table` from the 1-based `offset`."""

    def __init__(self, offset: int, length: int = 1,
                 name: Optional[str] = None):
        super().__init__(name)
        self.offset, self.length = offset, length

    def forward(self, xs):
        vals = list(xs)
        return T(*vals[self.offset - 1: self.offset - 1 + self.length])


class MixtureTable(Module):
    """`T(gates [B, K], experts)`: the experts (a `Table` of K tensors, or
    one tensor with K on axis 1) summed with the gates' weights."""

    def forward(self, xs):
        gates, experts = xs[1], xs[2]
        stacked = torch.stack(list(experts), dim=1) \
            if isinstance(experts, Table) else experts
        g = gates.reshape(tuple(gates.shape)
                          + (1,) * (stacked.dim() - gates.dim()))
        return torch.sum(stacked * g, dim=1)


class Identity(Module):
    """Returns its input."""

    def forward(self, x):
        return x


class Echo(Module):
    """Returns its input and prints its shape (the reference prints once a
    trace; the port at every call)."""

    def forward(self, x):
        shape = tuple(x.shape) if hasattr(x, "shape") else None
        print(f"[Echo {self.name}] shape={shape}")
        return x


class BifurcateSplitTable(Module):
    """A tensor split along `axis` (0-based) into `T(first half, rest)`."""

    def __init__(self, axis: int = 1, name: Optional[str] = None):
        super().__init__(name)
        self.axis = axis

    def forward(self, x):
        n = x.shape[self.axis]
        a, b = torch.split(x, [n // 2, n - n // 2], dim=self.axis)
        return T(a, b)


# ---------------------------------------------------------------------- #
# Graph
# ---------------------------------------------------------------------- #

class Input(Module):
    """A graph input placeholder: returns its input."""

    def forward(self, x):
        return x


def InputNode(name: Optional[str] = None) -> Node:
    """A graph input node (an `Input` module with no inputs)."""
    return Node(Input(name or "Input"), [])


class Graph(Container):
    """A static DAG of modules, built with the node DSL:

        inp = InputNode()
        h = Linear(10, 4).inputs(inp)
        model = Graph([inp], [Linear(4, 2).inputs(ReLU().inputs(h))])

    The nodes run in `topo_sort` order (`exec_order`), each module
    registered under its node's `key`, so parameter and buffer names are
    the reference's tree keys. A node with several inputs gets the 1-based
    `Table` of their outputs; the graph's output is one tensor, or a
    `Table` with several outputs; it takes one input, or a `Table` or
    list of them. A key holding a "." (a module named so), which a torch
    submodule name cannot hold, raises `ValueError` with the key; it is
    never renamed.

    BN -> ReLU fusion over the DAG: a ReLU node whose only input is a
    fusible BN node that feeds nothing else and is not a graph output
    runs inside the BN's `forward_with_activation` (kernels 6-7 on a
    card). The plan (`_fusion_plan`, exec_order indices) is computed once
    per structure: it is cached under the nodes' modules and the freeze
    flags' epoch, so a pass that swaps a node's module (`set_node_module`)
    or a freeze recomputes it; `fusion_enabled()` is read at each forward.

    Node keys come from a process-wide counter, as the reference's: a
    checkpoint of a graph loads into a graph built with the same node ids,
    or into one read from a model file (which keeps the keys).
    `copy.deepcopy` rebuilds the nodes in a loop (no recursion along
    `prev` chains), the copied node's module the copied registered child.
    """

    def __init__(self, inputs: Sequence[Node], outputs: Sequence[Node],
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_nodes = list(inputs)
        self.output_nodes = list(outputs)
        self.exec_order = topo_sort(self.output_nodes)
        for node in self.exec_order:
            if "." in node.key:
                raise ValueError(
                    f"node key {node.key!r} holds a '.', which a torch "
                    "submodule name cannot: name the module without one")
            self.add_module(node.key, node.module)
        self._plan = None

    def set_node_module(self, i: int, module: Module) -> None:
        """Swap the module of `exec_order[i]`: the node and the registered
        child together, under the node's key."""
        node = self.exec_order[i]
        node.module = module
        self._modules[node.key] = module

    def _fusion_plan(self) -> Tuple[frozenset, Dict[int, int]]:
        """(indices of fused BN nodes, {ReLU index: its BN's index}) in
        `exec_order`; cached per structure."""
        from bigdl_tpu_torch.nn.fusion import fusible_activation, fusible_bn
        key = (gate_epoch(), tuple(n.module for n in self.exec_order))
        if self._plan is not None and self._plan[0] == key:
            return self._plan[1]
        index = {id(n): i for i, n in enumerate(self.exec_order)}
        consumers: Dict[int, int] = {}
        for node in self.exec_order:
            for p in node.prev:
                consumers[id(p)] = consumers.get(id(p), 0) + 1
        outs = {id(n) for n in self.output_nodes}
        fused, skip = set(), {}
        for i, node in enumerate(self.exec_order):
            if fusible_activation(node.module) and len(node.prev) == 1:
                p = node.prev[0]
                if (fusible_bn(p.module) and consumers.get(id(p)) == 1
                        and id(p) not in outs):
                    fused.add(index[id(p)])
                    skip[i] = index[id(p)]
        self._plan = (key, (frozenset(fused), skip))
        return self._plan[1]

    def forward(self, input):
        from bigdl_tpu_torch.nn.fusion import fusion_enabled
        if isinstance(input, (Table, list, tuple)):
            inputs = list(input)
        else:
            inputs = [input]
        if len(inputs) != len(self.input_nodes):
            raise ValueError(f"graph expects {len(self.input_nodes)} "
                             f"inputs, got {len(inputs)}")
        fused, skip = self._fusion_plan() if fusion_enabled() \
            else (frozenset(), {})
        values = {id(n): x for n, x in zip(self.input_nodes, inputs)}
        order = self.exec_order
        for i, node in enumerate(order):
            if i in skip:
                # the ReLU ran inside its BN's fused tail
                values[id(node)] = values[id(order[skip[i]])]
            else:
                prev = node.prev
                if not prev:
                    x = values.get(id(node))
                elif len(prev) == 1:
                    x = values[id(prev[0])]
                else:
                    x = T(*[values[id(p)] for p in prev])
                values[id(node)] = node.module.forward_with_activation(x) \
                    if i in fused else node.module(x)
        outs = [values[id(n)] for n in self.output_nodes]
        return outs[0] if len(outs) == 1 else T(*outs)

    def __deepcopy__(self, memo):
        new = type(self).__new__(type(self))
        memo[id(self)] = new
        copies = {}
        for node in itertools.chain(self.exec_order, self.input_nodes,
                                    self.output_nodes):
            if id(node) in copies:
                continue
            c = Node.__new__(Node)
            c.__dict__.update({k: v for k, v in node.__dict__.items()
                               if k not in ("module", "prev")})
            # topological order: a node's inputs are copied before it
            c.prev = [copies[id(p)] for p in node.prev]
            copies[id(node)] = c
            memo[id(node)] = c
        new.__dict__.update(copy.deepcopy(
            {k: v for k, v in self.__dict__.items() if k != "_plan"}, memo))
        new._plan = None
        for node in itertools.chain(self.exec_order, self.input_nodes):
            # the registered child's copy, from the memo
            copies[id(node)].module = copy.deepcopy(node.module, memo)
        return new


# The reference's StaticGraph is this container (its DynamicGraph, the
# data-dependent variant, is not ported).
StaticGraph = Graph
