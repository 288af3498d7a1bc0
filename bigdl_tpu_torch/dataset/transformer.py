"""Data transformers (counterpart of `bigdl_tpu/dataset/transformer.py`).

Ported: `SampleToMiniBatch`, what the `Optimizer` factory needs. A
transformer maps an iterator of items to an iterator of items. Chaining
(`>>`), the element-wise transformers and padding are not ported.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List

from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample


class SampleToMiniBatch:
    """Group Samples into MiniBatches of `batch_size`; the last, partial
    batch is dropped only with `drop_remainder`."""

    def __init__(self, batch_size: int, drop_remainder: bool = False):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder

    def __call__(self, items: Iterable) -> Iterator[MiniBatch]:
        buf: List[Sample] = []
        for s in items:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield MiniBatch.from_samples(buf)
                buf = []
        if buf and not self.drop_remainder:
            yield MiniBatch.from_samples(buf)
