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
    batch is dropped only with `drop_remainder`. The reference's
    `feature_padding` / `label_padding` (padding ragged samples to one
    shape) are not ported and raise."""

    def __init__(self, batch_size: int, feature_padding=None,
                 label_padding=None, drop_remainder: bool = False):
        if feature_padding is not None or label_padding is not None:
            raise NotImplementedError(
                "SampleToMiniBatch feature_padding / label_padding are not "
                "ported: samples must share one shape")
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
