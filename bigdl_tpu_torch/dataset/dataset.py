"""Datasets (counterpart of `bigdl_tpu/dataset/dataset.py`).

Ported: `AbstractDataSet` (with `transform`), `LocalDataSet`, an in-memory
list of items (Samples, or MiniBatches for the optimizers), and
`DataSet.from_arrays`. Training iteration loops forever, each pass in a
fresh random order, as the reference's does; the order comes from an
explicit `torch.Generator` (seed 1 by default), so it is not the
reference's numpy order. The checkpoint cursor and the distributed
(per-host shard) dataset are not ported.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.dataset.sample import Sample


class AbstractDataSet:
    """`data(train)` iterates the items, `size()` counts them (records, not
    batches), `shuffle()` reorders them at an epoch boundary."""

    def data(self, train: bool) -> Iterator:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self):
        pass

    def transform(self, transformer) -> "AbstractDataSet":
        """This dataset seen through `transformer`, an iterator-to-iterator
        function (for example `SampleToMiniBatch`)."""
        return _TransformedDataSet(self, transformer)


class LocalDataSet(AbstractDataSet):
    """`data(train=False)`: the items once, in order. `data(train=True)`:
    an endless stream, each pass a permutation of the items, drawn from
    `generator` (default: a torch generator seeded with `seed`; the
    permutations are torch's, not the reference's numpy ones)."""

    def __init__(self, items: Sequence, seed: int = 1, *,
                 generator: Optional[torch.Generator] = None):
        self.items = list(items)
        self._g = generator if generator is not None \
            else torch.Generator().manual_seed(seed)

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


class _TransformedDataSet(AbstractDataSet):
    def __init__(self, base: AbstractDataSet, transformer):
        self.base = base
        self.transformer = transformer

    def data(self, train: bool) -> Iterator:
        return self.transformer(self.base.data(train))

    def size(self) -> int:
        return self.base.size()

    def shuffle(self):
        self.base.shuffle()


class DataSet:
    @staticmethod
    def from_arrays(features: np.ndarray, labels: Optional[np.ndarray] = None,
                    *, generator: Optional[torch.Generator] = None
                    ) -> LocalDataSet:
        """One `Sample` per row of `features` (and `labels`)."""
        return LocalDataSet(
            [Sample(features[i], None if labels is None else labels[i])
             for i in range(len(features))], generator=generator)
