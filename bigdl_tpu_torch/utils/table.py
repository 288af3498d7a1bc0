"""The 1-based `Table` (counterpart of `bigdl_tpu/utils/table.py`).

The reference's heterogeneous container, the second half of its
`Activity = Tensor | Table` union: positional items take the keys 1, 2,
..., keyword items their names. A `ConcatTable` returns one, a
`CAddTable` sums one, and a recurrent cell's single step takes
`T(x, state)` and returns `T(out, new_state)`. The JAX package registers
it as a pytree so that it passes through `jit`; the port needs no such
registration (autograd sees the tensors inside).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator

import numpy as np
import torch


class Table:
    """1-indexed heterogeneous container, `T(a, b, ...)` in the reference.
    Indexing is by key: `t[1]` is the first positional item, and `t[0]`
    raises `KeyError`."""

    def __init__(self, *items: Any, **kwitems: Any):
        self._d: Dict[Any, Any] = {}
        for i, v in enumerate(items):
            self._d[i + 1] = v
        self._d.update(kwitems)

    def __getitem__(self, k):
        return self._d[k]

    def __setitem__(self, k, v):
        self._d[k] = v

    def __contains__(self, k):
        return k in self._d

    def __len__(self):
        return len(self._d)

    @staticmethod
    def _key_order(k):
        # integer keys sort numerically (the 1..n case), before string keys
        return (0, k, "") if isinstance(k, int) else (1, 0, str(k))

    def __iter__(self) -> Iterator:
        for k in self.keys():
            yield self._d[k]

    def keys(self):
        return sorted(self._d, key=self._key_order)

    def values(self):
        return [self._d[k] for k in self.keys()]

    def insert(self, v):
        """Append `v` under the key len(self) + 1."""
        self._d[len(self._d) + 1] = v
        return self

    def __eq__(self, other):
        if not isinstance(other, Table):
            return NotImplemented
        if self.keys() != other.keys():
            return False
        for k in self.keys():
            a, b = self._d[k], other._d[k]
            if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
                if not (isinstance(a, torch.Tensor)
                        and isinstance(b, torch.Tensor)
                        and torch.equal(a, b)):
                    return False
            elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                if not np.array_equal(a, b):
                    return False
            elif a != b:
                return False
        return True

    def __repr__(self):
        inner = ", ".join(f"{k}: {self._d[k]!r}" for k in self.keys())
        return f"T({inner})"


def T(*items, **kwitems) -> Table:
    """Builder mirroring the reference's `T()` constructor."""
    return Table(*items, **kwitems)
