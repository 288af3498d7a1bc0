"""Data transformers (counterpart of `bigdl_tpu/dataset/transformer.py`).

A `Transformer` maps an iterator of items to an iterator of items and
composes with `>>` (or `chain`), as the reference's `->`.
`FuncTransformer` wraps an element-wise function; `SampleToMiniBatch`
batches Samples, padding ragged records (`PaddingParam`).
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, List, Optional

from bigdl_tpu_torch.dataset.sample import MiniBatch, PaddingParam, Sample


class Transformer:
    """Iterator -> iterator mapper; compose with a >> b. An element-wise
    stage (one item in, one out) sets `elementwise`."""

    elementwise: bool = False

    def apply(self, it: Iterator) -> Iterator:
        raise NotImplementedError

    def __call__(self, it: Iterable) -> Iterator:
        return self.apply(iter(it))

    def apply_one(self, item):
        """The transform of a single item (element-wise stages)."""
        return next(iter(self([item])))

    def __rshift__(self, other: "Transformer") -> "Transformer":
        return _Chained(self, other)


class _Chained(Transformer):
    def __init__(self, first: Transformer, second: Transformer):
        self.first, self.second = first, second

    @property
    def elementwise(self) -> bool:
        return self.first.elementwise and self.second.elementwise

    def apply(self, it):
        return self.second(self.first(it))


def chain(*transformers: Transformer) -> Transformer:
    """t1 >> t2 >> ... of the given transformers."""
    out = transformers[0]
    for t in transformers[1:]:
        out = out >> t
    return out


class FuncTransformer(Transformer):
    """An element-wise function as a transformer."""

    elementwise = True

    def __init__(self, fn: Callable):
        self.fn = fn

    def apply(self, it):
        return (self.fn(x) for x in it)


class SampleToMiniBatch(Transformer):
    """Group Samples into MiniBatches of `batch_size`; the last, partial
    batch is dropped only with `drop_remainder`. Records of different
    shapes are padded (`MiniBatch.from_samples`): with `feature_padding`
    / `label_padding` to their value and length, else with 0 to the
    batch's largest shape."""

    def __init__(self, batch_size: int,
                 feature_padding: Optional[PaddingParam] = None,
                 label_padding: Optional[PaddingParam] = None,
                 drop_remainder: bool = False):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.batch_size = batch_size
        self.feature_padding = feature_padding
        self.label_padding = label_padding
        self.drop_remainder = drop_remainder

    def apply(self, it) -> Iterator[MiniBatch]:
        buf: List[Sample] = []
        for s in it:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield MiniBatch.from_samples(buf, self.feature_padding,
                                             self.label_padding)
                buf = []
        if buf and not self.drop_remainder:
            yield MiniBatch.from_samples(buf, self.feature_padding,
                                         self.label_padding)
