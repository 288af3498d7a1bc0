"""Sample and MiniBatch (counterpart of `bigdl_tpu/dataset/sample.py`).

A `Sample` is one record: feature and label arrays. A `MiniBatch` is a
batch of stacked inputs and targets. Host batches are numpy arrays; a
torch tensor (for example a batch placed on the card once and reused
every step, the benchmark's resident batch) passes through untouched, so
it never makes a round trip through the host. Variable-length padding
(`PaddingParam`) is not ported: `from_samples` stacks records of one
shape.
"""

from __future__ import annotations

from typing import Sequence

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
    def from_samples(samples: Sequence[Sample]) -> "MiniBatch":
        """Stack the samples' features and labels, position by position.
        Raises on records of different shapes (padding is not ported)."""
        def stack(arrays):
            shapes = {a.shape for a in arrays}
            if len(shapes) != 1:
                raise ValueError(f"samples of different shapes {shapes} need "
                                 "padding, which is not ported")
            return np.stack(arrays)

        inputs = [stack([s.features[i] for s in samples])
                  for i in range(len(samples[0].features))]
        targets = [stack([s.labels[i] for s in samples])
                   for i in range(len(samples[0].labels))]
        return MiniBatch(inputs, targets or None)
