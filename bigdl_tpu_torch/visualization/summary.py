"""Training and validation summaries, and the event-file reader
(counterpart of `bigdl_tpu/visualization/summary.py`).

`TrainSummary` / `ValidationSummary` attach to either training loop
(`set_train_summary`, `set_validation_summary`): Loss, LearningRate and
Throughput scalars at every sync point, `Parameters` histograms behind a
trigger, validation scores. `FileReader` reads scalars back.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from bigdl_tpu_torch.visualization.event_writer import EventWriter
from bigdl_tpu_torch.visualization.record_writer import read_records
from bigdl_tpu_torch.visualization.wire import (Event, HistogramProto,
                                                SummaryValue)


def scalar_event(tag: str, value: float, step: int) -> Event:
    return Event(wall_time=time.time(), step=step,
                 summary=[SummaryValue(tag, simple_value=float(value))])


def histogram_event(tag: str, values, step: int) -> Event:
    """TF-style exponential-bucket histogram of a flat array."""
    vals = np.asarray(values).reshape(-1).astype(np.float64)
    ev = Event(wall_time=time.time(), step=step,
               summary=[SummaryValue(tag)])
    if vals.size == 0:
        return ev
    h = ev.summary[0].histo = HistogramProto()
    h.min, h.max = float(vals.min()), float(vals.max())
    h.num = float(vals.size)
    h.sum = float(vals.sum())
    h.sum_squares = float((vals * vals).sum())
    limits = _bucket_limits()
    counts, _ = np.histogram(vals, bins=[-np.inf] + limits)
    # drop empty leading/trailing buckets like TF's writer
    nz = np.nonzero(counts)[0]
    if nz.size:
        lo, hi = nz[0], nz[-1] + 1
        h.bucket_limit = list(limits[lo:hi])
        h.bucket = [float(c) for c in counts[lo:hi]]
    return ev


_LIMITS: Optional[List[float]] = None


def _bucket_limits() -> List[float]:
    global _LIMITS
    if _LIMITS is None:
        pos = []
        v = 1e-12
        while v < 1e20:
            pos.append(v)
            v *= 1.1
        _LIMITS = [-x for x in reversed(pos)] + [0.0] + pos + [float("inf")]
    return _LIMITS


class Summary:
    """Base writer bound to <log_dir>/<app_name>/<phase>."""

    def __init__(self, log_dir: str, app_name: str, phase: str):
        self.log_dir = os.path.join(log_dir, app_name, phase)
        self._writer = EventWriter(self.log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> "Summary":
        self._writer.add_event(scalar_event(tag, value, step))
        return self

    def add_histogram(self, tag: str, values, step: int) -> "Summary":
        self._writer.add_event(histogram_event(tag, values, step))
        return self

    def read_scalar(self, tag: str) -> List[Tuple[int, float]]:
        self._writer.flush()
        return FileReader.read_scalar(self.log_dir, tag)

    def close(self):
        self._writer.close()


class TrainSummary(Summary):
    """Per-sync-point Loss/Throughput/LearningRate scalars; `Parameters`
    histograms gated by a trigger."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "train")
        self._triggers: Dict[str, object] = {}

    def set_summary_trigger(self, name: str, trigger) -> "TrainSummary":
        if name not in ("Loss", "Throughput", "LearningRate", "Parameters"):
            raise ValueError(f"unknown summary name: {name}")
        self._triggers[name] = trigger
        return self

    def get_summary_trigger(self, name: str):
        return self._triggers.get(name)


class ValidationSummary(Summary):
    """ValidationMethod results per validation pass."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "validation")


class FileReader:
    """Read scalars (and histograms) back from events files."""

    @staticmethod
    def list_events(path: str) -> List[str]:
        if os.path.isfile(path):
            return [path]
        return sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.startswith("events.out.tfevents"))

    @staticmethod
    def _values(path: str, tag: str):
        for fname in FileReader.list_events(path):
            for record in read_records(fname):
                ev = Event.FromString(record)
                for v in ev.summary or ():
                    if v.tag == tag:
                        yield int(ev.step), v

    @staticmethod
    def read_scalar(path: str, tag: str) -> List[Tuple[int, float]]:
        return sorted((step, float(v.simple_value))
                      for step, v in FileReader._values(path, tag))

    @staticmethod
    def read_histogram(path: str,
                       tag: str) -> List[Tuple[int, HistogramProto]]:
        """(step, `HistogramProto`) of every histogram under `tag`, by
        step."""
        return sorted(((step, v.histo)
                       for step, v in FileReader._values(path, tag)
                       if v.histo is not None), key=lambda p: p[0])
