"""The `Operation` base (counterpart of `bigdl_tpu/ops/operation.py:32-38`).

An `Operation` is a forward-only module: it has no parameters, and its
`backward` raises, as the reference's does. The feature-column ops
(`ops/feature_col.py`) derive from it. The TF-style ops of the
reference's file are not ported (`ROADMAP.md` queue 1 item 10).
"""

from __future__ import annotations

from bigdl_tpu_torch.nn.module import Module


class Operation(Module):
    """Base class: a forward-only module."""

    def backward(self, *a, **k):
        raise RuntimeError("Operation does not support backward "
                           "(reference Operation.scala contract)")
