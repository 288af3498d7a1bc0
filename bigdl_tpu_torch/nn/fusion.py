"""BatchNorm+ReLU fusion: pattern matching over the module tree
(counterpart of `bigdl_tpu/nn/fusion.py`).

`Sequential` collapses a `BatchNormalization` child immediately followed
by a `ReLU` child into one `forward_with_activation` call, the fused tail
of `ops/bn_relu_kernel.py` (ResNet's blocks and stem all hit this), with
no model edit; `Graph` does the same for a ReLU node whose only input is
a BN node that feeds nothing else and is not a graph output. Matching is
conservative: exact `ReLU` only (every port BatchNorm is NHWC), and a
frozen or gradient-cut module is left to its own call, where the gate
(`nn/module.py`) acts. `Sequential` matches at every forward; `Graph`
caches its plan per structure. Toggling fusion needs no rebuild.

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
    """A BN module the fused tail can stand in for: a port BN (NHWC, the
    trailing axis is the channel) that is neither frozen nor
    gradient-cut."""
    return (isinstance(m, BatchNormalization)
            and not getattr(m, "_frozen", False)
            and not getattr(m, "_stop_gradient", False))


def fusible_activation(m) -> bool:
    """Exact ReLU only (a subclass would change the fused math), not
    gradient-cut."""
    return type(m) is ReLU and not getattr(m, "_stop_gradient", False)
