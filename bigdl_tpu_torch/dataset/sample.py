"""MiniBatch (counterpart of `bigdl_tpu/dataset/sample.py`).

A batch of stacked inputs and targets. Host batches are numpy arrays;
a torch tensor (for example a batch placed on the card once and reused
every step, the benchmark's resident batch) passes through untouched, so
it never makes a round trip through the host.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


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
