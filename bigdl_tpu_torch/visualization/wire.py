"""The few protobuf messages TensorBoard's event files hold, encoded and
decoded by hand (no protobuf package): `Event`, `Summary.Value`,
`HistogramProto` and the `NodeDef` / `GraphDef` of the graph view.

Field numbers and types are those of the reference's schemas
(`protos/tb_event.proto`, `protos/tf_graph.proto`, field-compatible with
TensorFlow's `event.proto`, `summary.proto` and `graph.proto`), and the
encoding is proto3's: fields in field-number order, scalars at their
default value left out, repeated doubles packed. A file this module writes
decodes through the reference's `FileReader`, and stock TensorBoard reads
it; `decode_event` reads the reference's files (packed or not).

Example:
    >>> ev = Event(wall_time=1.5, step=3,
    ...            summary=[SummaryValue("Loss", simple_value=0.25)])
    >>> back = Event.FromString(ev.SerializeToString())
    >>> back.step, back.summary[0].tag, back.summary[0].simple_value
    (3, 'Loss', 0.25)
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Tuple

# wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64  # int64: ten bytes of two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len_field(field: int, data: bytes) -> bytes:
    return _key(field, _LEN) + _varint(len(data)) + data


def _double(field: int, v: float) -> bytes:
    return _key(field, _I64) + struct.pack("<d", v) if v else b""


def _packed_doubles(field: int, vs) -> bytes:
    vs = [float(v) for v in vs]
    if not vs:
        return b""
    return _len_field(field, struct.pack(f"<{len(vs)}d", *vs))


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of each field of one message: an
    int for a varint, bytes for the others."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == _VARINT:
            v, i = _read_varint(buf, i)
        elif wire == _I64:
            v, i = buf[i:i + 8], i + 8
        elif wire == _LEN:
            size, i = _read_varint(buf, i)
            v, i = buf[i:i + size], i + size
        elif wire == _I32:
            v, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _int64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _doubles(wire: int, v: bytes) -> List[float]:
    """A repeated double field's values: packed or one element."""
    if wire == _I64:
        return [struct.unpack("<d", v)[0]]
    return list(struct.unpack(f"<{len(v) // 8}d", v))


class HistogramProto:
    """min, max, num, sum, sum_squares (fields 1-5, doubles);
    bucket_limit and bucket (6, 7, packed doubles)."""

    def __init__(self, min: float = 0.0, max: float = 0.0, num: float = 0.0,
                 sum: float = 0.0, sum_squares: float = 0.0,
                 bucket_limit=(), bucket=()):
        self.min, self.max, self.num = min, max, num
        self.sum, self.sum_squares = sum, sum_squares
        self.bucket_limit = list(bucket_limit)
        self.bucket = list(bucket)

    def SerializeToString(self) -> bytes:  # noqa: N802 (protobuf's name)
        return (_double(1, self.min) + _double(2, self.max)
                + _double(3, self.num) + _double(4, self.sum)
                + _double(5, self.sum_squares)
                + _packed_doubles(6, self.bucket_limit)
                + _packed_doubles(7, self.bucket))

    @classmethod
    def FromString(cls, buf: bytes) -> "HistogramProto":  # noqa: N802
        h = cls()
        names = {1: "min", 2: "max", 3: "num", 4: "sum", 5: "sum_squares"}
        for field, wire, v in _fields(buf):
            if field in names:
                setattr(h, names[field], struct.unpack("<d", v)[0])
            elif field == 6:
                h.bucket_limit += _doubles(wire, v)
            elif field == 7:
                h.bucket += _doubles(wire, v)
        return h


class SummaryValue:
    """`Summary.Value`: tag (1), simple_value (2, float32), histo (5)."""

    def __init__(self, tag: str = "", simple_value: float = 0.0,
                 histo: Optional[HistogramProto] = None):
        self.tag = tag
        self.simple_value = simple_value
        self.histo = histo

    def SerializeToString(self) -> bytes:  # noqa: N802
        out = _len_field(1, self.tag.encode()) if self.tag else b""
        if self.simple_value:
            out += _key(2, _I32) + struct.pack("<f", self.simple_value)
        if self.histo is not None:
            out += _len_field(5, self.histo.SerializeToString())
        return out

    @classmethod
    def FromString(cls, buf: bytes) -> "SummaryValue":  # noqa: N802
        val = cls()
        for field, _, v in _fields(buf):
            if field == 1:
                val.tag = v.decode()
            elif field == 2:
                val.simple_value = struct.unpack("<f", v)[0]
            elif field == 5:
                val.histo = HistogramProto.FromString(v)
        return val


class Event:
    """wall_time (1, double), step (2, int64) and one of file_version
    (3), graph_def (4, bytes) or summary (5: a `Summary`, its repeated
    `value` field 1, here a list of `SummaryValue`)."""

    def __init__(self, wall_time: float = 0.0, step: int = 0,
                 file_version: Optional[str] = None,
                 graph_def: Optional[bytes] = None,
                 summary: Optional[List[SummaryValue]] = None):
        self.wall_time = wall_time
        self.step = step
        self.file_version = file_version
        self.graph_def = graph_def
        self.summary = summary

    def SerializeToString(self) -> bytes:  # noqa: N802
        out = _double(1, self.wall_time)
        if self.step:
            out += _key(2, _VARINT) + _varint(int(self.step))
        if self.file_version is not None:
            out += _len_field(3, self.file_version.encode())
        if self.graph_def is not None:
            out += _len_field(4, bytes(self.graph_def))
        if self.summary is not None:
            out += _len_field(5, b"".join(
                _len_field(1, v.SerializeToString()) for v in self.summary))
        return out

    @classmethod
    def FromString(cls, buf: bytes) -> "Event":  # noqa: N802
        ev = cls()
        for field, _, v in _fields(buf):
            if field == 1:
                ev.wall_time = struct.unpack("<d", v)[0]
            elif field == 2:
                ev.step = _int64(v)
            elif field == 3:
                ev.file_version = v.decode()
            elif field == 4:
                ev.graph_def = bytes(v)
            elif field == 5:
                ev.summary = [SummaryValue.FromString(sv)
                              for f, _, sv in _fields(v) if f == 1]
        return ev


class NodeDef:
    """name (1), op (2), input (3, repeated string)."""

    def __init__(self, name: str = "", op: str = "", input=()):
        self.name, self.op, self.input = name, op, list(input)

    def SerializeToString(self) -> bytes:  # noqa: N802
        out = _len_field(1, self.name.encode()) if self.name else b""
        if self.op:
            out += _len_field(2, self.op.encode())
        for i in self.input:
            out += _len_field(3, i.encode())
        return out

    @classmethod
    def FromString(cls, buf: bytes) -> "NodeDef":  # noqa: N802
        nd = cls()
        for field, _, v in _fields(buf):
            if field == 1:
                nd.name = v.decode()
            elif field == 2:
                nd.op = v.decode()
            elif field == 3:
                nd.input.append(v.decode())
        return nd


class GraphDef:
    """node (1, repeated `NodeDef`)."""

    def __init__(self, node=()):
        self.node = list(node)

    def SerializeToString(self) -> bytes:  # noqa: N802
        return b"".join(_len_field(1, n.SerializeToString())
                        for n in self.node)

    @classmethod
    def FromString(cls, buf: bytes) -> "GraphDef":  # noqa: N802
        return cls(NodeDef.FromString(v) for f, _, v in _fields(buf)
                   if f == 1)
