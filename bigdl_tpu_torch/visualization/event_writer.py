"""TensorBoard event-file writer (counterpart of
`bigdl_tpu/visualization/event_writer.py`): events are queued and drained
by a background thread into `events.out.tfevents.<ts>.<host>`, starting
with a file-version event ("brain.Event:2").
"""

from __future__ import annotations

import os
import queue
import socket
import threading
import time

from bigdl_tpu_torch.visualization.record_writer import RecordWriter
from bigdl_tpu_torch.visualization.wire import Event


class EventWriter:
    """Background-thread writer of `Event`s to one events file."""

    _FLUSH_SECS = 5.0

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}." \
            f"{socket.gethostname()}"
        self.path = os.path.join(logdir, fname)
        self._fh = open(self.path, "wb")
        self._writer = RecordWriter(self._fh)
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = threading.Event()
        self._queue.put(Event(wall_time=time.time(),
                              file_version="brain.Event:2"))
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="bigdl-event-writer")
        self._thread.start()

    def add_event(self, event: Event):
        if self._closed.is_set():
            raise RuntimeError("EventWriter is closed")
        self._queue.put(event)

    def _run(self):
        last_flush = time.time()
        while True:
            try:
                ev = self._queue.get(timeout=0.2)
            except queue.Empty:
                if self._closed.is_set():
                    break
                continue
            if ev is None:
                self._queue.task_done()
                break
            self._writer.write_record(ev.SerializeToString())
            self._queue.task_done()
            if time.time() - last_flush > self._FLUSH_SECS:
                self._writer.flush()
                last_flush = time.time()
        self._writer.flush()

    def flush(self):
        """Block until queued events hit the file."""
        self._queue.join()
        self._writer.flush()

    def close(self):
        if not self._closed.is_set():
            self._closed.set()
            self._queue.put(None)
            self._thread.join()
            self._fh.close()
