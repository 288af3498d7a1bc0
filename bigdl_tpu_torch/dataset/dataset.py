"""Datasets (counterpart of `bigdl_tpu/dataset/dataset.py`).

Ported: `LocalDataSet`, an in-memory list of items
(MiniBatches for the optimizers). Training iteration loops forever, each
pass in a fresh random order, as the reference's does; the order comes
from an explicit `torch.Generator` (seed 1 by default), so it is not the
reference's numpy order. The checkpoint cursor is not ported.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import torch


class LocalDataSet:
    """`data(train=False)`: the items once, in order. `data(train=True)`:
    an endless stream, each pass a permutation of the items."""

    def __init__(self, items: Sequence,
                 generator: Optional[torch.Generator] = None):
        self.items = list(items)
        self._g = generator if generator is not None \
            else torch.Generator().manual_seed(1)

    def data(self, train: bool) -> Iterator:
        if not train:
            return iter(self.items)

        def looped():
            while True:
                for i in torch.randperm(len(self.items),
                                        generator=self._g).tolist():
                    yield self.items[i]

        return looped()

    def size(self) -> int:
        return len(self.items)

    def shuffle(self):
        """Reorder the items in place (the epoch-boundary shuffle)."""
        idx = torch.randperm(len(self.items), generator=self._g).tolist()
        self.items = [self.items[i] for i in idx]
