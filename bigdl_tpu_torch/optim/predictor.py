"""Batch inference (counterpart of `bigdl_tpu/optim/predictor.py`).

`LocalPredictor` runs a model's forward over batches on one device, under
`torch.inference_mode()`, with the reference's bounded in-flight window:
up to `inflight` batches are dispatched ahead of the blocking
device-to-host fetch, so the device never waits for the host between
batches and host memory stays bounded. With `convert=True` it serves a
converted copy of the caller's model (`ir.ConversionUtils.convert`: BN
fold, noise elision, the space-to-depth stem restatement) and leaves the
caller's model untouched. A batch of several inputs reaches the model
as the 1-based `Table`, as in the training loop.

`DistriPredictor` is the mesh-sharded predictor: each batch (a ragged
last one padded by repeating its last row) splits over the mesh's data
axis, and each distinct device runs one forward over the shards of its
positions on its own placed copy of the model.

`PredictionService` is the reference's thread-safe `predict(sample)`
facade over a `serving.InferenceEngine`: concurrent callers coalesce into
padded micro-batches of one forward each.
"""

from __future__ import annotations

import copy
import itertools
import threading
from collections import deque
from typing import Iterable, List, Optional

import numpy as np
import torch

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.dataset.sample import MiniBatch
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
from bigdl_tpu_torch.optim.local_optimizer import _meta, _to_device
from bigdl_tpu_torch.utils.table import Table


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
    instrument : route the forward through a `CompiledFunction`
        (`observability/compilation.py`): one cost count on the meta
        device and one `compile` record a batch signature, the FLOPs of
        the last forward in `self._jitted.last_info` (the serving engines
        read them).
    label : the stem of the compile records' label when instrumented:
        the records read `<label>/<class of the served model>`.
    telemetry : where the compile records go when instrumented (default
        none: the counts are kept, no record is emitted).
    device : where the predictor runs; the model must live there. Default
        CUDA (see `resolve_device`).
    """

    #: dispatched-but-unfetched forwards kept in flight by `predict`
    inflight = 4

    def __init__(self, model: torch.nn.Module, batch_size: int = 32,
                 convert: bool = True, instrument: bool = False, *,
                 label: str = "predict.forward", telemetry=None,
                 device=None):
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
        self._jitted = None
        if instrument:
            from bigdl_tpu_torch.observability.compilation import \
                CompiledFunction
            self._meta_lock = threading.Lock()
            self._meta_model = None
            self._jitted = CompiledFunction(
                self._plain_forward,
                label=f"{label}/{type(self.model).__name__}",
                telemetry=telemetry, sig_argnums=(0,),
                meta=self._meta_forward,
                device=str(self.device))

    def _plain_forward(self, x, model=None):
        """One forward of `model` (default the served one) under
        `torch.inference_mode()`; a `Table` output gives its first entry,
        `y[1]`, the reference's convention."""
        with torch.inference_mode():
            y = (self.model if model is None else model)(x)
        return y[1] if isinstance(y, Table) else y

    def _meta_forward(self, x):
        """The same forward on a meta copy of the served model (made at
        the first count), for `CompiledFunction`'s cost count."""
        from bigdl_tpu_torch.observability.compilation import to_meta
        with self._meta_lock:
            if self._meta_model is None:
                self._meta_model = _meta(self.model)
        return self._plain_forward, (to_meta(x), self._meta_model)

    def _forward(self, x):
        """One forward of a batch already on the device (through the
        `CompiledFunction` when instrumented)."""
        if self._jitted is not None:
            return self._jitted(x)
        return self._plain_forward(x)

    def _to_device(self, x):
        """A batch's inputs (or targets) on the predictor's device; a list
        of them becomes the 1-based `Table`, and string and bytes columns
        stay on the host, as the reference's predictor gives them."""
        return _to_device(x, self.device)

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


class DistriPredictor(LocalPredictor):
    """Mesh-sharded batch inference (reference `DistriPredictor`).

    mesh : a `parallel.Mesh` with a "data" axis; default `build_mesh()`
        over every CUDA device (raises without one). Each batch is padded
        by repeating its last row up to a multiple of the data axis, split
        into one shard a data position (positions along other axes hold
        the same shard and compute it once), and the result sliced back.
        A mesh that names one device several times (n positions on one
        card) runs that device's shards as one forward: one forward per
        distinct device per batch. A `ProcessMesh` (one process per
        device) runs the rank's own batch whole on the rank's device, as
        the reference's multi-host rule feeds each host its shard.
    model, batch_size, convert : as `LocalPredictor`; the converted model
        stays on the device the caller's model lives on (the first data
        position's device for a model without tensors), and each other
        distinct device gets its own placed copy, placed again when the
        parameters or buffers change (their version counters), as the
        reference re-places on a new parameter tree.
    """

    def __init__(self, model: torch.nn.Module, batch_size: int = 32,
                 mesh=None, convert: bool = True):
        from bigdl_tpu_torch.parallel.mesh import ProcessMesh, build_mesh
        self.mesh = mesh if mesh is not None else build_mesh()
        if isinstance(self.mesh, ProcessMesh):
            self._devices = [resolve_device(self.mesh.device_type)]
        else:
            self._devices = self.mesh.axis_devices("data")
        where = model_device(model)
        super().__init__(model, batch_size, convert,
                         device=self._devices[0] if where is None else where)
        self._placed = {}
        self._placed_src = None

    def _model_on(self, device: torch.device) -> torch.nn.Module:
        """The served model's copy on `device` (the model itself on its
        own device), placed again after any parameter or buffer changed."""
        key = tuple((id(t), t._version) for t in itertools.chain(
            self.model.parameters(), self.model.buffers()))
        if key != self._placed_src:
            self._placed, self._placed_src = {}, key
        if device not in self._placed:
            self._placed[device] = self.model if device == self.device \
                else copy.deepcopy(self.model).to(device)
        return self._placed[device]

    def _forward(self, x):
        from bigdl_tpu_torch.parallel.mesh import tree_map
        n = len(self._devices)
        lead = _leading_rows(x)
        padded = -lead % n
        if padded:
            x = tree_map(lambda v: torch.cat(
                [v, v[-1:].expand(padded, *v.shape[1:])]), x)
        rows = (lead + padded) // n
        by_device = {}
        for i, dev in enumerate(self._devices):
            by_device.setdefault(dev, []).append(i)
        outs = [None] * n
        for dev, positions in by_device.items():
            if positions == list(range(positions[0], positions[-1] + 1)):
                lo, hi = positions[0] * rows, (positions[-1] + 1) * rows
                part = tree_map(lambda v: v[lo:hi].to(dev), x)
            else:
                part = tree_map(lambda v: torch.cat(
                    [v[i * rows:(i + 1) * rows] for i in positions]).to(dev),
                    x)
            with torch.inference_mode():
                y = self._model_on(dev)(part)
            y = y[1] if isinstance(y, Table) else y
            for i, chunk in zip(positions, y.split(rows)):
                outs[i] = chunk.to(self.device)
        y = outs[0] if n == 1 else torch.cat(outs)
        return y[:lead] if padded else y


def _leading_rows(x) -> int:
    """The batch size of a batch's inputs (a tensor or a `Table`)."""
    if isinstance(x, Table):
        return _leading_rows(x[1])
    return x.shape[0]


class PredictionService:
    """Thread-safe serving (the reference's `PredictionService`): a facade
    over the micro-batching `serving.InferenceEngine`, so concurrent
    `predict` calls coalesce into padded batches of one forward each
    rather than one forward per caller.

    `predict(sample) -> np.ndarray` gives one sample's output row;
    `close()` (or the context manager) joins the engine's non-daemon
    dispatcher. Engine knobs (`max_wait_ms`, `admission`, `buckets`,
    `device`, ...) pass through as keyword arguments. `max_wait_ms`
    defaults to 0 here: a serial caller blocked on its own future cannot
    send a second request, so holding the window open would only add
    latency; concurrent callers still coalesce through the backlog that
    builds while the previous batch runs. The service serves the engine's
    converted copy (`model`), never the caller's module."""

    def __init__(self, model: torch.nn.Module, batch_size: int = 32,
                 **engine_kw):
        from bigdl_tpu_torch.serving import InferenceEngine
        engine_kw.setdefault("max_wait_ms", 0.0)
        self.engine = InferenceEngine(model, max_batch_size=batch_size,
                                      **engine_kw)
        self.predictor = self.engine._pred
        self.model = self.engine.model

    def predict(self, sample, timeout: Optional[float] = None) -> np.ndarray:
        return self.engine.predict(sample, timeout=timeout)

    def close(self):
        """Serve the queued requests and join the dispatcher thread."""
        self.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
