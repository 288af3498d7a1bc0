"""Shape layers (counterpart of `bigdl_tpu/nn/shape_ops.py`).

Ported: `Reshape`, what the feed-forward models use, `Mean` (an
embedding model's pooling over the sequence), and `DenseToSparse`, the
identity (the sparse layers take the padded `T(indices, values)` form,
not a COO tensor), as in the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence

from bigdl_tpu_torch.nn.module import Module


class Reshape(Module):
    """Reshape the non-batch axes to `size` (`batch_mode=False`: the whole
    tensor). The port's activations are NHWC tensors whatever their
    memory layout, so `Reshape((H * W * C,))` flattens in (H, W, C) order,
    the order the reference's `Linear` weights after it are laid out in.
    (Flattening the channels_last NCHW view the convolutions run on would
    give (C, H, W) order and silently permute the features.)"""

    def __init__(self, size: Sequence[int], batch_mode: Optional[bool] = True,
                 name: Optional[str] = None):
        super().__init__(name)
        self.size = tuple(size)
        self.batch_mode = batch_mode

    def forward(self, x):
        if self.batch_mode is False:
            return x.reshape(self.size)
        return x.reshape((x.shape[0],) + self.size)


class Mean(Module):
    """The mean over the 0-based axis `dimension` (reference `Mean`);
    `squeeze=False` keeps the axis. `n_input_dims` is the reference's,
    unused there too."""

    def __init__(self, dimension: int = 0, n_input_dims: int = -1,
                 squeeze: bool = True, name: Optional[str] = None):
        super().__init__(name)
        self.dimension, self.squeeze = dimension, squeeze

    def forward(self, x):
        return x.mean(self.dimension, keepdim=not self.squeeze)


class DenseToSparse(Module):
    """The identity, as in the reference: the sparse layers downstream
    read a dense input through their gathers (the reference's
    `DenseToSparse` converts to COO; neither package does)."""

    def forward(self, input):
        return input
