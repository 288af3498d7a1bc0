"""BatchNorm+ReLU fusion: pattern matching over the module tree
(counterpart of `bigdl_tpu/nn/fusion.py`).

`Sequential` collapses a `BatchNormalization` child immediately followed
by a `ReLU` child into one `forward_with_activation` call, the fused tail
of `ops/bn_relu_kernel.py` (ResNet's blocks and stem all hit this), with
no model edit. Matching is conservative: exact `ReLU` only (every port
BatchNorm is NHWC). It runs at every forward, so toggling fusion needs no
rebuild.

The toggle is process-global and on by default; `fusion_scope` sets it
for a block, which is how a twin without the kernel is run.
"""

from __future__ import annotations

import contextlib

from bigdl_tpu_torch.nn.activation import ReLU
from bigdl_tpu_torch.nn.normalization import BatchNormalization

_ENABLED = True


def set_fusion(enabled: bool = True) -> bool:
    """Enable/disable BN+ReLU fusion process-wide; returns the previous
    setting."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(enabled)
    return prev


def fusion_enabled() -> bool:
    """Whether BN+ReLU fusion is on (the containers ask at each forward)."""
    return _ENABLED


@contextlib.contextmanager
def fusion_scope(enabled: bool):
    """Set fusion on or off for the block; restores the previous setting."""
    prev = set_fusion(enabled)
    try:
        yield
    finally:
        set_fusion(prev)


def fusible_bn(m) -> bool:
    """A BN module the fused tail can stand in for: any port BN (NHWC,
    the trailing axis is the channel)."""
    return isinstance(m, BatchNormalization)


def fusible_activation(m) -> bool:
    """Exact ReLU only: a subclass would change the fused math."""
    return type(m) is ReLU
