"""Batch inference (counterpart of `bigdl_tpu/optim/predictor.py`).

`LocalPredictor` runs a model's forward over batches on one device, under
`torch.inference_mode()`, with the reference's bounded in-flight window:
up to `inflight` batches are dispatched ahead of the blocking
device-to-host fetch, so the device never waits for the host between
batches and host memory stays bounded. With `convert=True` it serves a
converted copy of the caller's model (`ir.ConversionUtils.convert`: BN
fold, noise elision, the space-to-depth stem restatement) and leaves the
caller's model untouched.

Not ported yet: `DistriPredictor` (the mesh-sharded predictor) and the
`PredictionService` facade.
"""

from __future__ import annotations

import copy
import itertools
from collections import deque
from typing import Iterable, List

import numpy as np
import torch

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.dataset.sample import MiniBatch
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch


def model_device(model: torch.nn.Module):
    """The device of the model's first parameter or buffer (None for a
    model that holds neither)."""
    for t in itertools.chain(model.parameters(), model.buffers()):
        return t.device
    return None


def to_numpy_rows(y: torch.Tensor) -> np.ndarray:
    """A batch of outputs fetched to the host as a numpy array (bf16 is
    widened to f32: numpy has no bf16)."""
    y = y.detach().cpu()
    return (y.float() if y.dtype == torch.bfloat16 else y).numpy()


class LocalPredictor:
    """Single-device batched inference (reference `LocalPredictor`).

    model : the trained module. With `convert=True` (default) the predictor
        takes a `copy.deepcopy` of it, puts the copy in eval mode and
        converts it for inference; otherwise it serves `model` itself,
        switched to eval mode.
    batch_size : rows per forward when `predict` batches the input.
    device : where the predictor runs; the model must live there. Default
        CUDA (see `resolve_device`).
    """

    #: dispatched-but-unfetched forwards kept in flight by `predict`
    inflight = 4

    def __init__(self, model: torch.nn.Module, batch_size: int = 32,
                 convert: bool = True, *, device=None):
        self.device = resolve_device(device)
        where = model_device(model)
        if where is not None and where != self.device:
            raise ValueError(f"the model lives on {where}, the predictor "
                             f"was asked to run on {self.device}")
        if convert:
            from bigdl_tpu_torch.ir import ConversionUtils
            model = ConversionUtils.convert(copy.deepcopy(model).eval(),
                                            inference=True)
        self.model = model.eval()
        self.batch_size = batch_size

    def _forward(self, x):
        """One forward of a batch already on the device. A model that
        returns a list (a `ConcatTable`) gives its first element, the
        reference's convention for a `Table` output."""
        with torch.inference_mode():
            y = self.model(x)
        return y[0] if isinstance(y, (list, tuple)) else y

    def _to_device(self, x):
        if isinstance(x, list):
            return [self._to_device(v) for v in x]
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        return t.to(self.device)

    def predict(self, dataset) -> List[np.ndarray]:
        """Per-sample outputs (numpy rows) for `dataset`: an array or
        tensor of samples (batched along its first axis), an
        `AbstractDataSet`, or an iterable of `Sample`s or `MiniBatch`es.
        Forwards are dispatched ahead through the in-flight window; the
        fetch trails `inflight` batches behind."""
        outs: List[np.ndarray] = []
        pending: deque = deque()
        for batch in self._batches(dataset):
            pending.append(self._forward(self._to_device(batch.get_input())))
            if len(pending) > self.inflight:
                outs.extend(to_numpy_rows(pending.popleft()))
        while pending:
            outs.extend(to_numpy_rows(pending.popleft()))
        return outs

    def predict_class(self, dataset) -> List[int]:
        """1-based class predictions (reference `predictClass`)."""
        return [int(np.argmax(o)) + 1 for o in self.predict(dataset)]

    def _batches(self, dataset) -> Iterable[MiniBatch]:
        if isinstance(dataset, (np.ndarray, torch.Tensor)):
            for i in range(0, len(dataset), self.batch_size):
                yield MiniBatch(dataset[i:i + self.batch_size])
            return
        if callable(getattr(dataset, "data", None)):
            it = iter(dataset.data(train=False))
        else:
            it = iter(dataset)
        try:
            first = next(it)
        except StopIteration:
            return
        chained = itertools.chain([first], it)
        if isinstance(first, MiniBatch):
            yield from chained
        else:
            yield from SampleToMiniBatch(self.batch_size)(chained)


#: distributed predict is local predict on each host's shard; alias for
#: parity with the reference
Predictor = LocalPredictor
