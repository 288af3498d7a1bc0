"""Containers (counterpart of `bigdl_tpu/nn/containers.py`).

Ported: `Sequential` (with the BN->ReLU matcher), `ConcatTable`,
`CAddTable` and `Identity` (the ResNets), and `Concat` (Inception).
Children are registered under the reference's keys, `"<index>_<child
name>"`, so a module's path
in the port (`named_modules`, split on ".") is its path in the JAX
package's parameter tree and BN state. `ConcatTable` returns a 1-based
`Table` (`utils/table.py`), as the reference's does.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import T


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


class CAddTable(Module):
    """Elementwise sum of a `Table` of tensors (or any sequence of them),
    its values taken in key order."""

    def forward(self, xs):
        vals = list(xs)
        out = vals[0]
        for v in vals[1:]:
            out = out + v
        return out


class Identity(Module):
    """Returns its input."""

    def forward(self, x):
        return x
