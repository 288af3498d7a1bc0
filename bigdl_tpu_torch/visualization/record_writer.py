"""TFRecord framing writer and reader (counterpart of
`bigdl_tpu/visualization/record_writer.py`).

Each payload is framed as
  uint64 length | uint32 masked_crc32c(length) | data | masked_crc32c(data)
with the masked CRC32C (Castagnoli), computed here from a 256-entry
table in plain Python (the reference's fallback,
`bigdl_tpu/native/__init__.py`; the port keeps its own copy).
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterator, List

_POLY = 0x82F63B78  # CRC32C, reflected
_TABLE: List[int] = []


def _table() -> List[int]:
    if not _TABLE:
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (_POLY if crc & 1 else 0)
            _TABLE.append(crc)
    return _TABLE


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C of `data` (incremental via `crc`)."""
    table = _table()
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = (c >> 8) ^ table[(c ^ b) & 0xFF]
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """The TFRecord masked CRC (the reference's masking constant)."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


class RecordWriter:
    def __init__(self, fileobj: BinaryIO):
        self.f = fileobj

    def write_record(self, data: bytes):
        header = struct.pack("<Q", len(data))
        self.f.write(header)
        self.f.write(struct.pack("<I", masked_crc32c(header)))
        self.f.write(data)
        self.f.write(struct.pack("<I", masked_crc32c(data)))

    def flush(self):
        self.f.flush()


class TFRecordFileWriter:
    """Standalone .tfrecord file writer (a local path)."""

    def __init__(self, path: str):
        self._fh = open(path, "wb")
        self._writer = RecordWriter(self._fh)

    def write(self, record: bytes):
        self._writer.write_record(record)

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: str) -> Iterator[bytes]:
    """The payloads of a TFRecord file, each frame's two CRCs checked
    (`ValueError` naming the offset on a mismatch or a truncated
    frame)."""
    with open(path, "rb") as f:
        while True:
            offset = f.tell()
            header = f.read(8)
            if not header:
                return
            if len(header) < 8:
                raise ValueError(f"{path}: truncated record at {offset}")
            (n,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            if hcrc != masked_crc32c(header):
                raise ValueError(f"{path}: length CRC mismatch at {offset}")
            data = f.read(n)
            tail = f.read(4)
            if len(data) < n or len(tail) < 4:
                raise ValueError(f"{path}: truncated record at {offset}")
            if struct.unpack("<I", tail)[0] != masked_crc32c(data):
                raise ValueError(f"{path}: data CRC mismatch at {offset}")
            yield data
