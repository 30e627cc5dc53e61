"""PackStream v1 codec — the wire serialization of the Bolt protocol.

Implements the public PackStream specification (the reference vendors a Go
implementation at vendor/.../golang-neo4j-bolt-driver/encoding/): nulls,
booleans, 64-bit ints (tiny/8/16/32/64), float64, UTF-8 strings, lists, maps,
and structures, plus the graph structure types the analysis code consumes —
Node (signature 0x4E), Relationship (0x52), Path (0x50) — mirroring the
vendored driver's structures/graph types (node.go:9, relationship.go:9,
path.go:9) that the reference type-asserts against (e.g.
graphing/differential-provenance.go:119).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any

SIG_NODE = 0x4E
SIG_RELATIONSHIP = 0x52
SIG_UNBOUND_RELATIONSHIP = 0x72
SIG_PATH = 0x50


@dataclass
class Structure:
    """Generic PackStream structure: signature byte + field list."""

    signature: int
    fields: list[Any] = field(default_factory=list)


@dataclass
class Node:
    identity: int
    labels: list[str]
    properties: dict[str, Any]


@dataclass
class Relationship:
    identity: int
    start: int
    end: int
    type: str
    properties: dict[str, Any]


@dataclass
class UnboundRelationship:
    identity: int
    type: str
    properties: dict[str, Any]


@dataclass
class Path:
    nodes: list[Node]
    relationships: list[UnboundRelationship]
    sequence: list[int]


def pack(value: Any) -> bytes:
    out = bytearray()
    _pack_into(out, value)
    return bytes(out)


def _pack_into(out: bytearray, v: Any) -> None:
    if v is None:
        out.append(0xC0)
    elif v is True:
        out.append(0xC3)
    elif v is False:
        out.append(0xC2)
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out.append(0xC1)
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        data = v.encode("utf-8")
        _pack_header(out, len(data), 0x80, (0xD0, 0xD1, 0xD2))
        out += data
    elif isinstance(v, bytes):
        n = len(v)
        if n < 0x100:
            out += bytes((0xCC, n))
        elif n < 0x10000:
            out.append(0xCD)
            out += struct.pack(">H", n)
        else:
            out.append(0xCE)
            out += struct.pack(">I", n)
        out += v
    elif isinstance(v, (list, tuple)):
        _pack_header(out, len(v), 0x90, (0xD4, 0xD5, 0xD6))
        for item in v:
            _pack_into(out, item)
    elif isinstance(v, dict):
        _pack_header(out, len(v), 0xA0, (0xD8, 0xD9, 0xDA))
        for k, item in v.items():
            _pack_into(out, k)
            _pack_into(out, item)
    elif isinstance(v, Structure):
        _pack_struct_header(out, len(v.fields), v.signature)
        for f in v.fields:
            _pack_into(out, f)
    else:
        raise TypeError(f"cannot pack value of type {type(v).__name__}")


def _pack_int(out: bytearray, v: int) -> None:
    if -16 <= v < 128:
        out += struct.pack(">b", v)
    elif -0x80 <= v < 0x80:
        out.append(0xC8)
        out += struct.pack(">b", v)
    elif -0x8000 <= v < 0x8000:
        out.append(0xC9)
        out += struct.pack(">h", v)
    elif -0x80000000 <= v < 0x80000000:
        out.append(0xCA)
        out += struct.pack(">i", v)
    else:
        out.append(0xCB)
        out += struct.pack(">q", v)


def _pack_header(out: bytearray, n: int, tiny_base: int, markers: tuple[int, int, int]) -> None:
    if n < 0x10:
        out.append(tiny_base + n)
    elif n < 0x100:
        out.append(markers[0])
        out.append(n)
    elif n < 0x10000:
        out.append(markers[1])
        out += struct.pack(">H", n)
    else:
        out.append(markers[2])
        out += struct.pack(">I", n)


def _pack_struct_header(out: bytearray, n: int, signature: int) -> None:
    if n < 0x10:
        out.append(0xB0 + n)
    elif n < 0x100:
        out += bytes((0xDC, n))
    else:
        out.append(0xDD)
        out += struct.pack(">H", n)
    out.append(signature)


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("packstream: truncated data")
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]


def unpack(data: bytes) -> Any:
    r = _Reader(data)
    v = _unpack(r)
    return v


def unpack_all(data: bytes) -> Any:
    """Unpack one value and require full consumption."""
    r = _Reader(data)
    v = _unpack(r)
    if r.pos != len(data):
        raise ValueError(f"packstream: {len(data) - r.pos} trailing bytes")
    return v


def _unpack(r: _Reader) -> Any:
    m = r.u8()
    if m <= 0x7F:  # tiny positive int
        return m
    if m >= 0xF0:  # tiny negative int
        return m - 0x100
    if 0x80 <= m <= 0x8F:
        return r.take(m - 0x80).decode("utf-8")
    if 0x90 <= m <= 0x9F:
        return [_unpack(r) for _ in range(m - 0x90)]
    if 0xA0 <= m <= 0xAF:
        return {_unpack(r): _unpack(r) for _ in range(m - 0xA0)}
    if 0xB0 <= m <= 0xBF:
        return _unpack_struct(r, m - 0xB0)
    if m == 0xC0:
        return None
    if m == 0xC1:
        return struct.unpack(">d", r.take(8))[0]
    if m == 0xC2:
        return False
    if m == 0xC3:
        return True
    if m == 0xC8:
        return struct.unpack(">b", r.take(1))[0]
    if m == 0xC9:
        return struct.unpack(">h", r.take(2))[0]
    if m == 0xCA:
        return struct.unpack(">i", r.take(4))[0]
    if m == 0xCB:
        return struct.unpack(">q", r.take(8))[0]
    if m == 0xCC:
        return bytes(r.take(r.u8()))
    if m == 0xCD:
        return bytes(r.take(struct.unpack(">H", r.take(2))[0]))
    if m == 0xCE:
        return bytes(r.take(struct.unpack(">I", r.take(4))[0]))
    if m == 0xD0:
        return r.take(r.u8()).decode("utf-8")
    if m == 0xD1:
        return r.take(struct.unpack(">H", r.take(2))[0]).decode("utf-8")
    if m == 0xD2:
        return r.take(struct.unpack(">I", r.take(4))[0]).decode("utf-8")
    if m == 0xD4:
        return [_unpack(r) for _ in range(r.u8())]
    if m == 0xD5:
        return [_unpack(r) for _ in range(struct.unpack(">H", r.take(2))[0])]
    if m == 0xD6:
        return [_unpack(r) for _ in range(struct.unpack(">I", r.take(4))[0])]
    if m == 0xD8:
        return {_unpack(r): _unpack(r) for _ in range(r.u8())}
    if m == 0xD9:
        return {_unpack(r): _unpack(r) for _ in range(struct.unpack(">H", r.take(2))[0])}
    if m == 0xDA:
        return {_unpack(r): _unpack(r) for _ in range(struct.unpack(">I", r.take(4))[0])}
    if m == 0xDC:
        return _unpack_struct(r, r.u8())
    if m == 0xDD:
        return _unpack_struct(r, struct.unpack(">H", r.take(2))[0])
    raise ValueError(f"packstream: unknown marker 0x{m:02X}")


def _unpack_struct(r: _Reader, size: int) -> Any:
    sig = r.u8()
    fields = [_unpack(r) for _ in range(size)]
    if sig == SIG_NODE:
        return Node(identity=fields[0], labels=fields[1], properties=fields[2])
    if sig == SIG_RELATIONSHIP:
        return Relationship(
            identity=fields[0], start=fields[1], end=fields[2], type=fields[3], properties=fields[4]
        )
    if sig == SIG_UNBOUND_RELATIONSHIP:
        return UnboundRelationship(identity=fields[0], type=fields[1], properties=fields[2])
    if sig == SIG_PATH:
        return Path(nodes=fields[0], relationships=fields[1], sequence=fields[2])
    return Structure(signature=sig, fields=fields)
