"""Containers (counterpart of `bigdl_tpu/nn/containers.py`).

Ported: `Sequential` (with the BN->ReLU matcher), `ConcatTable`,
`CAddTable` and `Identity`, what the ResNets use. Children are registered
under the reference's keys, `"<index>_<child name>"`, so a module's path
in the port (`named_modules`, split on ".") is its path in the JAX
package's parameter tree and BN state. `ConcatTable` returns a Python list
where the reference returns a 1-based `Table`.
"""

from __future__ import annotations

from typing import List

from bigdl_tpu_torch.nn.module import Module


class Container(Module):
    """Holds child modules in order, keyed `"<index>_<name>"`."""

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
    """Each child applied to the same input; a list of their outputs."""

    def forward(self, x):
        return [child(x) for child in self.children_in_order()]


class CAddTable(Module):
    """Elementwise sum of a list of tensors."""

    def forward(self, xs):
        out = xs[0]
        for v in xs[1:]:
            out = out + v
        return out


class Identity(Module):
    """Returns its input."""

    def forward(self, x):
        return x
