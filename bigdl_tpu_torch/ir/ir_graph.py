"""Graph-level IR and the inference conversion passes (counterpart of
`bigdl_tpu/ir/ir_graph.py`).

`ConversionUtils.convert` rewrites a module tree for inference, in place,
with the reference's passes:

- `_drop_inference_noise`: noise layers (matched by class name, as the
  reference matches them) become `Identity`.
- `_fold_batchnorm`: along `Sequential` chains, a BN that directly follows
  a plain `SpatialConvolution` or `Linear` (the exact types: a subclass
  such as the space-to-depth stem is not folded, as in the reference) is
  folded into that layer's weight and bias,
  `w' = w * g`, `b' = (b - mean) * g + beta`, `g = gamma / sqrt(var + eps)`,
  computed in float64 from the BN's running stats. A layer without a bias
  gains one. The BN becomes an `Identity` under the BN's own name, so the
  container keys (and `interop.load_module_params` paths) stay the same.
- `_restate_s2d_stem`: an eligible stem convolution (7x7/s2-like, at most
  4 input planes) becomes a `SpaceToDepthStemConvolution` holding the same
  `Parameter` objects under the same name.

The walks follow every `Container`. In a `Graph` they follow
`exec_order`, and a pass that swaps a node's module swaps the node's and
the registered child together (`Graph.set_node_module`), under the node's
key. `_fold_batchnorm` skips a `Graph` (and what it holds), as the
reference's does: a served graph keeps its BNs, and their fused sites run
kernel 6. `_is_orphan_state` says whether a state path still names a
module (`nn.module.functional_apply` ignores one that does not).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from bigdl_tpu_torch.nn.module import Module


class IRElement:
    """One IR node: the module's type name, the module, and its own
    parameters by name."""

    def __init__(self, op_type: str, module: Module,
                 params: Dict[str, torch.nn.Parameter]):
        self.op_type = op_type
        self.module = module
        self.params = params

    def __repr__(self):
        return f"IRElement({self.op_type})"


class IRGraph:
    """IR over a module tree (children order = execution order for
    `Sequential` chains). The passes edit the tree in place."""

    def __init__(self, root: Module):
        self.root = root

    @staticmethod
    def from_module(module: Module) -> "IRGraph":
        return IRGraph(module)

    def to_module(self) -> Module:
        return self.root

    def elements(self) -> List[IRElement]:
        """The leaf modules in execution order."""
        from bigdl_tpu_torch.nn.containers import Container, Graph
        out: List[IRElement] = []

        def walk(m):
            if isinstance(m, Graph):
                for n in m.exec_order:
                    walk(n.module)
            elif isinstance(m, Container):
                for c in m.children_in_order():
                    walk(c)
            else:
                out.append(IRElement(type(m).__name__, m,
                                     dict(m.named_parameters(recurse=False))))

        walk(self.root)
        return out


class ConversionUtils:
    """convert(model, inference=True): run the IR passes for the phase
    (reference `ConversionUtils.convert`)."""

    @staticmethod
    def convert(module: Module, inference: bool = True,
                restatements: bool = True) -> Module:
        ir = IRGraph.from_module(module)
        if inference:
            _drop_inference_noise(ir)
            _fold_batchnorm(ir)
        if restatements:
            _restate_s2d_stem(ir)
        return ir.to_module()

    @staticmethod
    def apply_tpu_restatements(module: Module) -> Module:
        """Only the restatement passes, which re-express the compute and
        never change a parameter's value (safe for training too)."""
        ir = IRGraph.from_module(module)
        _restate_s2d_stem(ir)
        return ir.to_module()


# ------------------------------------------------------------------ passes
_NOISE = ("Dropout", "GaussianNoise", "GaussianDropout", "SpatialDropout1D",
          "SpatialDropout2D", "SpatialDropout3D")


def _drop_inference_noise(ir: IRGraph):
    """Replace noise layers with `Identity`, keeping their names and keys."""
    from bigdl_tpu_torch.nn.containers import Container, Graph, Identity

    def walk(m):
        if isinstance(m, Graph):
            for i, n in enumerate(m.exec_order):
                if type(n.module).__name__ in _NOISE:
                    m.set_node_module(i, Identity(name=n.module.name))
                elif isinstance(n.module, Container):
                    walk(n.module)
            return
        for key, c in list(m._modules.items()):
            if type(c).__name__ in _NOISE:
                m._modules[key] = Identity(name=c.name)
            elif isinstance(c, Container):
                walk(c)

    if isinstance(ir.root, Container):
        walk(ir.root)


def _fold_pair(prev, bn):
    """Fold `bn` into `prev` (a conv with an OIHW weight or a Linear with an
    [in, out] weight), in float64. A BN without the affine folds as gamma
    1, beta 0."""
    with torch.no_grad():
        gamma = 1.0 if bn.weight is None else bn.weight.detach().double()
        g = gamma / torch.sqrt(bn.var.double() + bn.eps)
        beta = 0.0 if bn.bias is None else bn.bias.detach().double()
        w = prev.weight.detach().double()
        if w.dim() == 4:                  # conv OIHW: scale O
            w2 = w * g.reshape(-1, 1, 1, 1)
        else:                             # Linear [in, out]: scale out
            w2 = w * g.reshape(1, -1)
        b = prev.bias.detach().double() if prev.bias is not None \
            else torch.zeros_like(g)
        b2 = (b - bn.mean.double()) * g + beta
        prev.weight.copy_(w2)
        if prev.bias is None:
            prev.bias = torch.nn.Parameter(
                b2.to(prev.weight.dtype).to(prev.weight.device))
            prev.with_bias = True
        else:
            prev.bias.copy_(b2)


def _fold_batchnorm(ir: IRGraph):
    """Fold each BN that directly follows a plain conv or Linear in a
    `Sequential` into it (the parameter-changing half of the reference's
    conv+bn fusion). The BN becomes an `Identity` of the same name. A
    `Graph` is left whole, as the reference leaves it."""
    from bigdl_tpu_torch.nn.containers import (Container, Graph, Identity,
                                               Sequential)
    from bigdl_tpu_torch.nn.conv import SpatialConvolution
    from bigdl_tpu_torch.nn.linear import Linear
    from bigdl_tpu_torch.nn.normalization import BatchNormalization

    def walk(m):
        if not isinstance(m, Container) or isinstance(m, Graph):
            return
        if isinstance(m, Sequential):
            keys = list(m._modules)
            for i in range(1, len(keys)):
                prev, cur = m._modules[keys[i - 1]], m._modules[keys[i]]
                if type(prev) in (SpatialConvolution, Linear) \
                        and isinstance(cur, BatchNormalization):
                    _fold_pair(prev, cur)
                    m._modules[keys[i]] = Identity(name=cur.name)
        for c in m.children_in_order():
            walk(c)

    walk(ir.root)


def _stem_eligible(c) -> bool:
    """A real image stem: a plain `SpatialConvolution` with a square
    kernel k % 4 == 3, stride 2, pad (k-1)//2, one group and at most 4
    input planes (the reference's test, `bigdl_tpu/ir/ir_graph.py:223`)."""
    from bigdl_tpu_torch.nn.conv import SpatialConvolution
    return (type(c) is SpatialConvolution
            and c.kw == c.kh and c.kw % 4 == 3
            and c.sw == 2 and c.sh == 2
            and c.pad_w == c.pad_h == (c.kw - 1) // 2
            and c.groups == 1 and c.n_in <= 4)


def _restate(c) -> Module:
    from bigdl_tpu_torch.nn.conv import SpaceToDepthStemConvolution
    repl = SpaceToDepthStemConvolution(c.n_in, c.n_out, kernel=c.kw,
                                       with_bias=c.with_bias, name=c.name,
                                       device=c.weight.device)
    repl.weight = c.weight  # the same Parameters, as the reference moves
    repl.bias = c.bias      # its parameter subtree
    return repl


def _restate_s2d_stem(ir: IRGraph):
    """Re-express an eligible stem convolution as a
    `SpaceToDepthStemConvolution` (the same function and parameters); the
    container key keeps the module's name (a graph node its key)."""
    from bigdl_tpu_torch.nn.containers import Container, Graph

    def walk(m):
        if isinstance(m, Graph):
            for i, n in enumerate(m.exec_order):
                if _stem_eligible(n.module):
                    m.set_node_module(i, _restate(n.module))
                elif isinstance(n.module, Container):
                    walk(n.module)
            return
        for key, c in list(m._modules.items()):
            if _stem_eligible(c):
                m._modules[key] = _restate(c)
            elif isinstance(c, Container):
                walk(c)

    if isinstance(ir.root, Container):
        walk(ir.root)


def _is_orphan_state(root, path: Tuple[str, ...]) -> bool:
    """Whether the state path `path` (module keys from `root`: a graph's
    node keys, a container's child keys) names no module of the tree."""
    from bigdl_tpu_torch.nn.containers import Graph
    m = root
    for part in path:
        if isinstance(m, Graph):
            m = next((n.module for n in m.exec_order if n.key == part),
                     None)
        else:
            m = m._modules.get(part)
        if m is None:
            return True
    return False
