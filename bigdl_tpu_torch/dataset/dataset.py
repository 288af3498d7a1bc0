"""Datasets (counterpart of `bigdl_tpu/dataset/dataset.py`).

Ported: `AbstractDataSet` (with `transform`), `LocalDataSet`, an in-memory
list of items (Samples, or MiniBatches for the optimizers), and
`DataSet.from_arrays`. Training iteration loops forever, each pass in a
fresh random order, as the reference's does; the order comes from an
explicit `torch.Generator` (seed 1 by default), so it is not the
reference's numpy order. The checkpoint cursor (`position`, `cursor`,
`restore_cursor`) is the reference's, with the torch generator's state in
place of numpy's. `DistributedDataSet` is one rank's shard of the items
(item `i` on rank `i % num_hosts`, by default the process group's rank
and world size), and `DataSet.array` picks it above world size 1.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.parallel import collectives


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
    permutations are torch's, not the reference's numpy ones).

    It carries the reference's restorable iteration cursor: the
    generator's state and the item order are kept at the start of each
    training pass, and an epoch-boundary `shuffle()` that lands mid-pass
    records its stream position. `cursor()` captures that and
    `restore_cursor()` reproduces the exact item stream, so a resumed run
    continues mid-epoch at the next untrained item."""

    def __init__(self, items: Sequence, seed: int = 1, *,
                 generator: Optional[torch.Generator] = None):
        self.items = list(items)
        self._g = generator if generator is not None \
            else torch.Generator().manual_seed(seed)
        # cursor bookkeeping: `_order` maps positions to original item
        # indices; `_pass_*` describe the current training pass
        self._order = list(range(len(self.items)))
        self._pass_counter = 0
        self._pass_rng_state = None
        self._pass_order = None
        self._pass_served = 0
        self._pass_shuffles: list = []
        self._replay_shuffles = None  # armed by restore_cursor
        self._skip_items = 0          # armed by restore_cursor

    def data(self, train: bool) -> Iterator:
        if not train:
            return iter(self.items)

        def looped():
            while True:
                self._pass_counter += 1
                self._pass_rng_state = self._g.get_state()
                self._pass_order = list(self._order)
                self._pass_shuffles = []
                self._pass_served = 0
                idx = torch.randperm(len(self.items),
                                     generator=self._g).tolist()
                # after restore_cursor: replay the original run's mid-pass
                # shuffles at their positions and drop the items it had
                # already trained on
                replay = self._replay_shuffles
                self._replay_shuffles = None
                skip = self._skip_items
                self._skip_items = 0
                for i in idx:
                    while replay and replay[0] <= self._pass_served:
                        replay.pop(0)
                        self.shuffle()
                    self._pass_served += 1
                    if skip > 0:
                        skip -= 1
                        continue
                    yield self.items[i]
                while replay:
                    replay.pop(0)
                    self.shuffle()

        return looped()

    def size(self) -> int:
        return len(self.items)

    def shuffle(self):
        """Reorder the items in place (the epoch-boundary shuffle)."""
        idx = torch.randperm(len(self.items), generator=self._g).tolist()
        self.items = [self.items[i] for i in idx]
        self._order = [self._order[i] for i in idx]
        if self._pass_rng_state is not None:
            self._pass_shuffles.append(self._pass_served)

    def position(self) -> dict:
        """The training stream's position: the pass, and the items of it
        served so far."""
        return {"pass": self._pass_counter, "served": self._pass_served}

    def cursor(self, position: Optional[dict] = None) -> dict:
        """The training stream at `position` (a `position()` sample;
        default: now), for a checkpoint: the current pass's starting
        generator state (as a numpy uint8 array) and item order, its
        mid-pass shuffle positions, and the items of it consumed. Raises
        `ValueError` for a position outside the current pass."""
        n = len(self.items)
        if position is None:
            position = self.position()
        if self._pass_rng_state is None:  # no training pass started yet
            return {"version": 2, "generator": "torch", "n_items": n,
                    "pass_rng_state": self._g.get_state().numpy(),
                    "pass_order": list(self._order),
                    "shuffles_at": [], "skip": 0}
        if position["pass"] == self._pass_counter:
            skip = int(position["served"])
        elif position["pass"] == self._pass_counter - 1 and \
                position["served"] >= n:
            skip = 0  # on the previous pass's end: this pass from item 0
        else:
            raise ValueError(
                f"position {position} does not fall in the current pass "
                f"({self._pass_counter})")
        return {"version": 2, "generator": "torch", "n_items": n,
                "pass_rng_state": self._pass_rng_state.numpy(),
                "pass_order": list(self._pass_order),
                "shuffles_at": list(self._pass_shuffles), "skip": skip}

    def restore_cursor(self, cur: dict):
        """Rewind to a `cursor()` snapshot: item order and generator back
        to the pass start, its shuffles armed for replay, the trained
        items skipped. Call before the first training pull. Raises
        `ValueError` for a cursor of another dataset, or one that holds a
        numpy generator state (the reference's), which a torch generator
        cannot continue."""
        if cur.get("generator") != "torch":
            raise ValueError("the cursor holds a numpy RandomState (the "
                             "reference's); this dataset permutes with a "
                             "torch generator")
        order = list(cur["pass_order"])
        if cur.get("n_items") != len(self.items) or \
                sorted(order) != list(range(len(self.items))):
            raise ValueError(
                f"cursor does not match this dataset: cursor has "
                f"{cur.get('n_items')} items, dataset has "
                f"{len(self.items)}")
        original = [None] * len(self.items)
        for pos, oi in enumerate(self._order):
            original[oi] = self.items[pos]
        self.items = [original[oi] for oi in order]
        self._order = order
        self._g.set_state(torch.from_numpy(
            np.array(cur["pass_rng_state"], dtype=np.uint8)))
        self._replay_shuffles = list(cur.get("shuffles_at") or [])
        self._skip_items = int(cur.get("skip", 0))
        self._pass_rng_state = None
        self._pass_order = None
        self._pass_served = 0
        self._pass_shuffles = []


class DistributedDataSet(LocalDataSet):
    """This rank's shard of `items`: item `i` when `i % num_hosts ==
    host_index`. The defaults are the process group's rank and world size
    (`Engine.init(distributed=True)` joins it), so one script runs on one
    process or many; on one it is a `LocalDataSet` of every item. Under a
    model axis the ranks of a model group must share a shard: pass the
    process mesh's `data_index` and data axis size (`DistriOptimizer`
    refuses a shard that does not match its mesh). `global_size` counts
    the items of every shard, so the epoch triggers see global
    progress."""

    def __init__(self, items: Sequence, host_index: Optional[int] = None,
                 num_hosts: Optional[int] = None, seed: int = 1):
        if host_index is None:
            host_index = collectives.rank()
        if num_hosts is None:
            num_hosts = collectives.world_size()
        if not 0 <= host_index < num_hosts:
            raise ValueError(f"host_index {host_index} is not in "
                             f"[0, {num_hosts})")
        shard = [x for i, x in enumerate(items)
                 if i % num_hosts == host_index]
        super().__init__(shard, seed)
        self.global_size = len(items)
        self.host_index, self.num_hosts = host_index, num_hosts


class _TransformedDataSet(AbstractDataSet):
    def __init__(self, base: AbstractDataSet, transformer):
        self.base = base
        self.transformer = transformer
        # the shard's accounting, so the loop counts global progress
        for attr in ("global_size", "num_hosts", "host_index"):
            if hasattr(base, attr):
                setattr(self, attr, getattr(base, attr))

    def data(self, train: bool) -> Iterator:
        return self.transformer(self.base.data(train))

    def size(self) -> int:
        return self.base.size()

    def shuffle(self):
        self.base.shuffle()

    def position(self) -> dict:
        return self.base.position()

    def cursor(self, position: Optional[dict] = None) -> dict:
        return self.base.cursor(position=position)

    def restore_cursor(self, cur: dict):
        return self.base.restore_cursor(cur)


class DataSet:
    @staticmethod
    def array(items: Sequence, host_index: Optional[int] = None,
              num_hosts: Optional[int] = None) -> LocalDataSet:
        """`items` as a dataset: this rank's `DistributedDataSet` shard
        when there is more than one host (by default, the process group's
        world size), else a `LocalDataSet` of them all."""
        if num_hosts is None:
            num_hosts = collectives.world_size()
        if num_hosts > 1:
            return DistributedDataSet(items, host_index, num_hosts)
        return LocalDataSet(items)

    @staticmethod
    def from_arrays(features: np.ndarray, labels: Optional[np.ndarray] = None,
                    *, generator: Optional[torch.Generator] = None
                    ) -> LocalDataSet:
        """One `Sample` per row of `features` (and `labels`)."""
        return LocalDataSet(
            [Sample(features[i], None if labels is None else labels[i])
             for i in range(len(features))], generator=generator)
