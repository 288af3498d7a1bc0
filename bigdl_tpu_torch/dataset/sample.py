"""Sample and MiniBatch (counterpart of `bigdl_tpu/dataset/sample.py`).

A `Sample` is one record: feature and label arrays. A `MiniBatch` is a
batch of stacked inputs and targets. Host batches are numpy arrays; a
torch tensor (for example a batch placed on the card once and reused
every step, the benchmark's resident batch) passes through untouched, so
it never makes a round trip through the host. `from_samples` pads ragged
records (`PaddingParam`), as the reference does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class Sample:
    """One training record: feature array(s) and label array(s)."""

    def __init__(self, features, labels=None):
        self.features = [np.asarray(f) for f in _as_list(features)]
        self.labels = [np.asarray(t) for t in _as_list(labels)]

    @property
    def feature(self):
        return self.features[0]

    @property
    def label(self):
        return self.labels[0] if self.labels else None


def _norm(x):
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


class MiniBatch:
    def __init__(self, inputs, targets=None):
        self.inputs = [_norm(i) for i in _as_list(inputs)]
        self.targets = [_norm(t) for t in _as_list(targets)]

    def get_input(self):
        return self.inputs[0] if len(self.inputs) == 1 else self.inputs

    def get_target(self):
        if not self.targets:
            return None
        return self.targets[0] if len(self.targets) == 1 else self.targets

    def size(self) -> int:
        return self.inputs[0].shape[0]

    @staticmethod
    def from_samples(samples: Sequence[Sample],
                     feature_padding: Optional["PaddingParam"] = None,
                     label_padding: Optional["PaddingParam"] = None
                     ) -> "MiniBatch":
        """Stack the samples' features and labels, position by position;
        ragged records are padded (`_stack`)."""
        inputs = [_stack([s.features[i] for s in samples], feature_padding)
                  for i in range(len(samples[0].features))]
        targets = [_stack([s.labels[i] for s in samples], label_padding)
                   for i in range(len(samples[0].labels))]
        return MiniBatch(inputs, targets or None)


class PaddingParam:
    """How `from_samples` pads ragged records: fill with `padding_value`;
    with `padding_length`, the first axis padded to that length (else to
    the batch's longest, the reference's "pad to max")."""

    def __init__(self, padding_value: float = 0.0,
                 padding_length: Optional[int] = None):
        self.padding_value = padding_value
        self.padding_length = padding_length


def _stack(arrs: List[np.ndarray], padding: Optional[PaddingParam]):
    """The records stacked on a new first axis. Records of one shape
    without `padding` stack as they are; otherwise every axis is padded
    to the largest record's (records of fewer axes gain trailing axes of
    1), the first to `padding.padding_length` when set, filled with
    `padding.padding_value` (0 without `padding`)."""
    shapes = {a.shape for a in arrs}
    if len(shapes) == 1 and padding is None:
        return np.stack(arrs)
    nd = max(a.ndim for a in arrs)
    arrs = [a.reshape(a.shape + (1,) * (nd - a.ndim)) for a in arrs]
    maxshape = [max(a.shape[d] for a in arrs) for d in range(nd)]
    value = 0.0
    if padding is not None:
        value = padding.padding_value
        if padding.padding_length is not None:
            maxshape[0] = padding.padding_length
    out = np.full((len(arrs),) + tuple(maxshape), value, dtype=arrs[0].dtype)
    for i, a in enumerate(arrs):
        out[(i,) + tuple(slice(0, s) for s in a.shape)] = a
    return out
