"""The sidecar's nine messages (``proto/nemo_service.proto``) on protobuf's
wire format, with no protobuf library: the port's counterpart of the JAX
package's generated ``service/proto/nemo_service_pb2.py``.

Each message is a plain class with the proto's fields as attributes,
``SerializeToString()`` and ``FromString(data)``.  The encoding is
protobuf's: a field is a varint key ``(number << 3) | wire_type``, then a
varint (int32, int64; negatives as ten-byte two's complement), eight
little-endian bytes (double) or a varint length and the bytes (string,
bytes, a message, a packed ``repeated int64``, one map entry).  As proto3
writes it: fields in number order, a scalar at its default and an empty
repeated field left out, a message field written whenever it is set (not
None), each map entry with both its key and its value, and maps in sorted
key order (``_map_order``), so that the bytes equal the generated classes'
``SerializeToString(deterministic=True)``.  A parse skips fields it does not know, accepts a
repeated int64 packed or not, and merges a message field that occurs twice,
as protobuf does.
"""

from __future__ import annotations

import struct

_VARINT, _FIXED64, _LEN, _FIXED32 = 0, 1, 2, 5
_MASK64 = (1 << 64) - 1


class DecodeError(ValueError):
    """Bytes that are not a well-formed message of the expected type."""


def _varint(n: int) -> bytes:
    n &= _MASK64
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _key(number: int, wire_type: int) -> bytes:
    return _varint((number << 3) | wire_type)


def _len_field(number: int, payload: bytes) -> bytes:
    return _key(number, _LEN) + _varint(len(payload)) + payload


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        if pos >= len(buf):
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n & _MASK64, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than ten bytes")


def _signed(n: int, bits: int = 64) -> int:
    n &= (1 << bits) - 1
    return n - (1 << bits) if n >> (bits - 1) else n


def _fields(data) -> list[tuple[int, int, object]]:
    """(number, wire_type, value) of every field: an int for a varint or a
    fixed field, a memoryview for a length-delimited one."""
    buf = memoryview(bytes(data)) if not isinstance(data, memoryview) else data
    pos, out = 0, []
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        number, wt = key >> 3, key & 7
        if number == 0:
            raise DecodeError("field number 0")
        if wt == _VARINT:
            value, pos = _read_varint(buf, pos)
        elif wt == _FIXED64:
            if pos + 8 > len(buf):
                raise DecodeError("truncated fixed64")
            value, pos = int.from_bytes(buf[pos:pos + 8], "little"), pos + 8
        elif wt == _FIXED32:
            if pos + 4 > len(buf):
                raise DecodeError("truncated fixed32")
            value, pos = int.from_bytes(buf[pos:pos + 4], "little"), pos + 4
        elif wt == _LEN:
            n, pos = _read_varint(buf, pos)
            if pos + n > len(buf):
                raise DecodeError("truncated length-delimited field")
            value, pos = buf[pos:pos + n], pos + n
        else:
            raise DecodeError(f"unsupported wire type {wt}")
        out.append((number, wt, value))
    return out


# Field kinds: how one field is written and read.
_STRING, _BYTES, _INT64, _INT32, _DOUBLE, _REP_INT64 = "string", "bytes", "int64", "int32", "double", "rep_int64"


class Message:
    """A proto3 message: ``FIELDS`` is ((number, name, kind), ...) in
    number order, where kind is a scalar kind, a Message subclass, or
    ("map", key kind, value kind)."""

    FIELDS: tuple = ()

    def __init__(self, **kw) -> None:
        for _, name, kind in self.FIELDS:
            setattr(self, name, _default(kind))
        for name, value in kw.items():
            if name not in self._names():
                raise TypeError(f"{type(self).__name__} has no field {name!r}")
            setattr(self, name, dict(value) if isinstance(value, dict) else
                    list(value) if isinstance(value, (list, tuple)) else value)

    @classmethod
    def _names(cls) -> set:
        return {name for _, name, _ in cls.FIELDS}

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and all(
            getattr(self, n) == getattr(other, n) for _, n, _ in self.FIELDS)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({', '.join(f'{n}={getattr(self, n)!r}' for _, n, _ in self.FIELDS)})"

    def SerializeToString(self) -> bytes:  # noqa: N802 - the generated classes' name
        out = bytearray()
        for number, name, kind in self.FIELDS:
            out += _encode_field(number, kind, getattr(self, name))
        return bytes(out)

    def ByteSize(self) -> int:  # noqa: N802 - the generated classes' name
        return len(self.SerializeToString())

    @classmethod
    def FromString(cls, data) -> "Message":  # noqa: N802 - the generated classes' name
        msg = cls()
        msg._merge(data)
        return msg

    def _merge(self, data) -> None:
        by_number = {number: (name, kind) for number, name, kind in self.FIELDS}
        for number, wt, value in _fields(data):
            spec = by_number.get(number)
            if spec is None:
                continue  # an unknown field: skipped, as protobuf does
            name, kind = spec
            if isinstance(kind, tuple):
                _expect(wt, _LEN, name)
                k, v = _decode_map_entry(kind, value)
                getattr(self, name)[k] = v
            elif isinstance(kind, type):
                _expect(wt, _LEN, name)
                sub = getattr(self, name)
                if sub is None:
                    sub = kind()
                    setattr(self, name, sub)
                sub._merge(value)
            elif kind == _REP_INT64:
                if wt == _LEN:
                    buf, pos = value, 0
                    while pos < len(buf):
                        n, pos = _read_varint(buf, pos)
                        getattr(self, name).append(_signed(n))
                else:
                    _expect(wt, _VARINT, name)
                    getattr(self, name).append(_signed(value))
            else:
                setattr(self, name, _decode_scalar(kind, wt, value, name))


def _default(kind):
    if isinstance(kind, tuple):
        return {}
    if isinstance(kind, type):
        return None
    return {_STRING: "", _BYTES: b"", _INT64: 0, _INT32: 0, _DOUBLE: 0.0, _REP_INT64: []}[kind]


def _expect(wt: int, want: int, name: str) -> None:
    if wt != want:
        raise DecodeError(f"field {name!r}: wire type {wt}, expected {want}")


def _encode_scalar(number: int, kind: str, value, always: bool = False) -> bytes:
    """One scalar field; left out at its default unless ``always`` (a map
    entry writes both its key and its value)."""
    if kind == _STRING:
        b = value.encode("utf-8")
        return _len_field(number, b) if b or always else b""
    if kind == _BYTES:
        b = bytes(value)
        return _len_field(number, b) if b or always else b""
    if kind in (_INT64, _INT32):
        v = int(value)
        return _key(number, _VARINT) + _varint(v) if v or always else b""
    if kind == _DOUBLE:
        raw = struct.pack("<d", float(value))
        return _key(number, _FIXED64) + raw if raw != bytes(8) or always else b""
    raise TypeError(f"unknown field kind {kind!r}")


def _map_order(key: str) -> tuple:
    """A map key's place: UTF-8 bytes ascending, a key after every longer
    key that begins with it (the order of protobuf's upb runtime under
    ``deterministic=True``)."""
    return (*key.encode("utf-8"), 256)


def _encode_field(number: int, kind, value) -> bytes:
    if isinstance(kind, tuple):
        _, kk, vk = kind
        out = bytearray()
        for k in sorted(value, key=_map_order):
            entry = _encode_scalar(1, kk, k, always=True)
            v = value[k]
            entry += (_len_field(2, v.SerializeToString()) if isinstance(vk, type)
                      else _encode_scalar(2, vk, v, always=True))
            out += _len_field(number, entry)
        return bytes(out)
    if isinstance(kind, type):
        return b"" if value is None else _len_field(number, value.SerializeToString())
    if kind == _REP_INT64:
        return _len_field(number, b"".join(_varint(int(x)) for x in value)) if value else b""
    return _encode_scalar(number, kind, value)


def _decode_scalar(kind: str, wt: int, value, name: str):
    if kind == _STRING:
        _expect(wt, _LEN, name)
        try:
            return bytes(value).decode("utf-8")
        except UnicodeDecodeError as ex:
            raise DecodeError(f"field {name!r}: not UTF-8") from ex
    if kind == _BYTES:
        _expect(wt, _LEN, name)
        return bytes(value)
    if kind == _INT64:
        _expect(wt, _VARINT, name)
        return _signed(value)
    if kind == _INT32:
        _expect(wt, _VARINT, name)
        return _signed(value, 32)
    if kind == _DOUBLE:
        _expect(wt, _FIXED64, name)
        return struct.unpack("<d", value.to_bytes(8, "little"))[0]
    raise TypeError(f"unknown field kind {kind!r}")


def _decode_map_entry(kind: tuple, data) -> tuple:
    _, kk, vk = kind
    key = _default(kk)
    val = vk() if isinstance(vk, type) else _default(vk)
    for number, wt, value in _fields(data):
        if number == 1:
            key = _decode_scalar(kk, wt, value, "key")
        elif number == 2:
            if isinstance(vk, type):
                _expect(wt, _LEN, "value")
                val._merge(value)
            else:
                val = _decode_scalar(vk, wt, value, "value")
    return key, val


class NdArray(Message):
    FIELDS = ((1, "dtype", _STRING), (2, "shape", _REP_INT64), (3, "data", _BYTES))


class CondBatch(Message):
    FIELDS = tuple((i + 1, f, NdArray) for i, f in enumerate(
        ("table_id", "label_id", "type_id", "is_goal", "node_mask", "edge_src", "edge_dst", "edge_mask")))


class StaticParams(Message):
    FIELDS = tuple((i + 1, f, _INT64) for i, f in enumerate(
        ("v", "pre_tid", "post_tid", "num_tables", "num_labels", "max_depth", "comp_linear")))


class AnalyzeRequest(Message):
    FIELDS = ((1, "pre", CondBatch), (2, "post", CondBatch), (3, "static", StaticParams), (4, "chunk", _INT64))


class AnalyzeResponse(Message):
    FIELDS = ((1, "outputs", ("map", _STRING, NdArray)), (2, "chunk", _INT64), (3, "step_seconds", _DOUBLE))


class KernelRequest(Message):
    FIELDS = ((1, "verb", _STRING), (2, "arrays", ("map", _STRING, NdArray)), (3, "params", ("map", _STRING, _INT64)))


class KernelResponse(Message):
    FIELDS = ((1, "outputs", ("map", _STRING, NdArray)), (2, "step_seconds", _DOUBLE))


class HealthRequest(Message):
    FIELDS = ()


class HealthResponse(Message):
    FIELDS = ((1, "platform", _STRING), (2, "device_count", _INT32), (3, "version", _STRING))


MESSAGES = (NdArray, CondBatch, StaticParams, AnalyzeRequest, AnalyzeResponse, KernelRequest, KernelResponse,
            HealthRequest, HealthResponse)
