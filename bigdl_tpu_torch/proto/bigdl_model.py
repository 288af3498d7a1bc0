"""The model-file schema (`protos/bigdl_model.proto`), encoded and decoded
by hand: no protobuf package (the port's own copy of the reference's
`bigdl_tpu/proto/bigdl_model_pb2.py`).

The nine messages keep the schema's field numbers, types and names, and
the encoding is proto3's, so the bytes parse with the reference's
generated module and the reference's files parse here:

- fields in field-number order; a plain scalar at its default (0, False,
  "", b"") is left out, a `oneof` member is written whenever it is the set
  member, even at its default (`i=0`, `b=False`, `none=True`);
- `repeated` integers are packed; the decoder takes packed and unpacked
  forms, and skips unknown fields;
- `double` is fixed64; `int64` / `int32` are varints, a negative one ten
  bytes of two's complement;
- a singular message field is written when it is set (not None), even
  empty; a `map<string, AttrValue>` entry is a nested message with the key
  as field 1 and the value as field 2 (the order of entries is not fixed).

The API is the generated one's where the serializer needs it:
`SerializeToString()`, `FromString(data)`, `WhichOneof("value")`,
`HasField(name)`, keyword construction, and `add(**fields)` on a repeated
message field.

Example:
    >>> av = AttrValue(i=0)
    >>> av.SerializeToString()   # the oneof member is written at 0
    b'\\x08\\x00'
    >>> AttrValue.FromString(b'\\x08\\x00').WhichOneof("value")
    'i'
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

from bigdl_tpu_torch.visualization.wire import (_I64, _LEN, _VARINT,
                                                _fields, _int64, _key,
                                                _len_field, _read_varint,
                                                _varint)

__all__ = ["AttrValue", "ListValue", "GraphNode", "GraphDef", "BigDLModule",
           "TensorProto", "NamedTensor", "TensorStorage", "ModelProto"]

# field kinds
_INT64, _INT32, _DOUBLE, _STRING, _BYTES, _BOOL, _MSG, _MAP = range(8)
_SCALAR_DEFAULT = {_INT64: 0, _INT32: 0, _DOUBLE: 0.0, _STRING: "",
                   _BYTES: b"", _BOOL: False}


class _Field:
    __slots__ = ("number", "name", "kind", "repeated", "msg", "oneof")

    def __init__(self, number: int, name: str, kind: int,
                 repeated: bool = False, msg: Optional[str] = None,
                 oneof: Optional[str] = None):
        self.number, self.name, self.kind = number, name, kind
        self.repeated, self.msg, self.oneof = repeated, msg, oneof


class _Repeated(list):
    """A repeated message field: a list with the generated API's
    `add(**fields)`."""

    def __init__(self, cls, items=()):
        super().__init__(items)
        self._cls = cls

    def add(self, **fields):
        item = self._cls(**fields)
        self.append(item)
        return item


class _Message:
    """Base of the nine messages: fields from `_FIELDS`, a `oneof` member
    set by assignment (which clears the group's other members)."""

    _FIELDS: Tuple[_Field, ...] = ()
    _BY_NAME: Dict[str, _Field] = {}
    _BY_NUMBER: Dict[int, _Field] = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._FIELDS = tuple(sorted(cls._FIELDS, key=lambda f: f.number))
        cls._BY_NAME = {f.name: f for f in cls._FIELDS}
        cls._BY_NUMBER = {f.number: f for f in cls._FIELDS}

    def __init__(self, **fields):
        object.__setattr__(self, "_which", {})
        for f in self._FIELDS:
            if f.kind == _MAP:
                value = {}
            elif f.repeated:
                value = _Repeated(_MESSAGES[f.msg]) if f.kind == _MSG else []
            elif f.kind == _MSG:
                value = None
            else:
                value = _SCALAR_DEFAULT[f.kind]
            object.__setattr__(self, f.name, value)
        for name, value in fields.items():
            if name not in self._BY_NAME:
                raise ValueError(f"{type(self).__name__} has no field "
                                 f"{name!r}")
            f = self._BY_NAME[name]
            if f.kind == _MAP:
                getattr(self, name).update(value)
            elif f.repeated:
                getattr(self, name).extend(value)
            else:
                setattr(self, name, value)

    def __setattr__(self, name, value):
        f = self._BY_NAME.get(name)
        if f is None:
            raise AttributeError(f"{type(self).__name__} has no field "
                                 f"{name!r}")
        if f.oneof is not None:
            for other in self._FIELDS:
                if other.oneof == f.oneof and other is not f:
                    object.__setattr__(
                        self, other.name, None if other.kind == _MSG
                        else _SCALAR_DEFAULT[other.kind])
            self._which[f.oneof] = name
        object.__setattr__(self, name, value)

    def WhichOneof(self, group: str) -> Optional[str]:
        return self._which.get(group)

    def HasField(self, name: str) -> bool:
        f = self._BY_NAME[name]
        if f.oneof is not None:
            return self._which.get(f.oneof) == name
        if f.kind != _MSG or f.repeated:
            raise ValueError(f"{name} is not a singular message field")
        return getattr(self, name) is not None

    def __eq__(self, other):
        return type(other) is type(self) and self._key() == other._key()

    def _key(self):
        return tuple((f.name, getattr(self, f.name)) for f in self._FIELDS) \
            + (tuple(sorted(self._which.items())),)

    def __repr__(self):
        parts = []
        for f in self._FIELDS:
            v = getattr(self, f.name)
            if v is None or (not f.repeated and f.kind != _MAP
                             and f.oneof is None
                             and v == _SCALAR_DEFAULT.get(f.kind)):
                continue
            if (f.repeated or f.kind == _MAP) and not v:
                continue
            if f.oneof is not None and self._which.get(f.oneof) != f.name:
                continue
            parts.append(f"{f.name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"

    # ---------------------------------------------------------- encode
    def SerializeToString(self) -> bytes:
        out = []
        for f in self._FIELDS:
            v = getattr(self, f.name)
            if f.oneof is not None and self._which.get(f.oneof) != f.name:
                continue
            if f.kind == _MAP:
                for key, value in v.items():
                    entry = _len_field(1, key.encode()) \
                        + _len_field(2, value.SerializeToString())
                    out.append(_len_field(f.number, entry))
            elif f.repeated and f.kind == _MSG:
                out.extend(_len_field(f.number, m.SerializeToString())
                           for m in v)
            elif f.repeated:
                if v:
                    out.append(_len_field(f.number, b"".join(
                        _scalar_payload(f.kind, x) for x in v)))
            elif f.kind == _MSG:
                if v is not None:
                    out.append(_len_field(f.number, v.SerializeToString()))
            elif f.oneof is not None or v != _SCALAR_DEFAULT[f.kind]:
                out.append(_scalar_field(f, v))
        return b"".join(out)

    # ---------------------------------------------------------- decode
    @classmethod
    def FromString(cls, data: bytes) -> "_Message":
        msg = cls()
        msg._merge(bytes(data))
        return msg

    def _merge(self, data: bytes):
        for number, wire, v in _fields(data):
            f = self._BY_NUMBER.get(number)
            if f is None:
                continue  # unknown field: skipped, as protobuf does
            if f.kind == _MAP:
                self._merge_map_entry(f, v)
            elif f.kind == _MSG:
                msg_cls = _MESSAGES[f.msg]
                if f.repeated:
                    getattr(self, f.name).append(msg_cls.FromString(v))
                    continue
                cur = getattr(self, f.name)
                if cur is None:
                    cur = msg_cls()
                cur._merge(v)  # a repeated singular message merges
                setattr(self, f.name, cur)
            elif f.repeated:
                values = getattr(self, f.name)
                if wire == _LEN and f.kind not in (_STRING, _BYTES):
                    values.extend(_unpack(f.kind, v))  # packed
                else:
                    values.append(_scalar_value(f.kind, wire, v))
            else:
                setattr(self, f.name, _scalar_value(f.kind, wire, v))

    def _merge_map_entry(self, f: _Field, data: bytes):
        key, value = "", None
        for number, wire, v in _fields(data):
            if number == 1:
                key = bytes(v).decode()
            elif number == 2:
                value = _MESSAGES[f.msg].FromString(v)
        getattr(self, f.name)[key] = value if value is not None \
            else _MESSAGES[f.msg]()


def _scalar_payload(kind: int, v) -> bytes:
    if kind == _DOUBLE:
        return struct.pack("<d", float(v))
    if kind == _INT32:
        v = int(v)
        return _varint(v if v >= 0 else v + (1 << 64))
    return _varint(int(v))


def _scalar_field(f: _Field, v) -> bytes:
    if f.kind == _DOUBLE:
        return _key(f.number, _I64) + struct.pack("<d", float(v))
    if f.kind == _STRING:
        return _len_field(f.number, v.encode())
    if f.kind == _BYTES:
        return _len_field(f.number, bytes(v))
    return _key(f.number, _VARINT) + _scalar_payload(f.kind, v)


def _scalar_value(kind: int, wire: int, v):
    if kind == _STRING:
        return bytes(v).decode()
    if kind == _BYTES:
        return bytes(v)
    if kind == _DOUBLE:
        if wire != _I64:
            raise ValueError(f"a double field with wire type {wire}")
        return struct.unpack("<d", v)[0]
    if wire != _VARINT:
        raise ValueError(f"an integer field with wire type {wire}")
    if kind == _BOOL:
        return bool(v)
    if kind == _INT32:
        v &= 0xFFFFFFFF
        return v - (1 << 32) if v >= 1 << 31 else v
    return _int64(v)


def _unpack(kind: int, data: bytes) -> List:
    if kind == _DOUBLE:
        return list(struct.unpack(f"<{len(data) // 8}d", data))
    out, i = [], 0
    while i < len(data):
        v, i = _read_varint(data, i)
        out.append(_scalar_value(kind, _VARINT, v))
    return out


# ------------------------------------------------------------- messages
_ONEOF = "value"


class AttrValue(_Message):
    _FIELDS = (_Field(1, "i", _INT64, oneof=_ONEOF),
               _Field(2, "d", _DOUBLE, oneof=_ONEOF),
               _Field(3, "s", _STRING, oneof=_ONEOF),
               _Field(4, "b", _BOOL, oneof=_ONEOF),
               _Field(5, "list", _MSG, msg="ListValue", oneof=_ONEOF),
               _Field(6, "module", _MSG, msg="BigDLModule", oneof=_ONEOF),
               _Field(7, "none", _BOOL, oneof=_ONEOF),
               _Field(8, "tensor", _MSG, msg="TensorProto", oneof=_ONEOF),
               _Field(9, "dtype", _STRING, oneof=_ONEOF),
               _Field(15, "is_tuple", _BOOL))


class ListValue(_Message):
    _FIELDS = (_Field(1, "items", _MSG, repeated=True, msg="AttrValue"),)


class GraphNode(_Message):
    _FIELDS = (_Field(1, "key", _STRING),
               _Field(2, "module", _MSG, msg="BigDLModule"),
               _Field(3, "prev", _INT32, repeated=True))


class GraphDef(_Message):
    _FIELDS = (_Field(1, "nodes", _MSG, repeated=True, msg="GraphNode"),
               _Field(2, "input_nodes", _INT32, repeated=True),
               _Field(3, "output_nodes", _INT32, repeated=True))


class BigDLModule(_Message):
    _FIELDS = (_Field(1, "module_type", _STRING),
               _Field(2, "name", _STRING),
               _Field(3, "ctor_args", _MSG, repeated=True, msg="AttrValue"),
               _Field(4, "ctor_kwargs", _MAP, msg="AttrValue"),
               _Field(5, "children", _MSG, repeated=True, msg="BigDLModule"),
               _Field(6, "graph", _MSG, msg="GraphDef"),
               _Field(7, "evaluating", _BOOL))


class TensorProto(_Message):
    _FIELDS = (_Field(1, "shape", _INT64, repeated=True),
               _Field(2, "dtype", _STRING),
               _Field(3, "storage_id", _INT64))


class NamedTensor(_Message):
    _FIELDS = (_Field(1, "path", _STRING),
               _Field(2, "tensor", _MSG, msg="TensorProto"))


class TensorStorage(_Message):
    _FIELDS = (_Field(1, "id", _INT64),
               _Field(2, "data", _BYTES))


class ModelProto(_Message):
    _FIELDS = (_Field(1, "framework_version", _STRING),
               _Field(2, "module", _MSG, msg="BigDLModule"),
               _Field(3, "parameters", _MSG, repeated=True, msg="NamedTensor"),
               _Field(4, "state", _MSG, repeated=True, msg="NamedTensor"),
               _Field(5, "storages", _MSG, repeated=True,
                      msg="TensorStorage"))


_MESSAGES = {cls.__name__: cls for cls in (
    AttrValue, ListValue, GraphNode, GraphDef, BigDLModule, TensorProto,
    NamedTensor, TensorStorage, ModelProto)}
