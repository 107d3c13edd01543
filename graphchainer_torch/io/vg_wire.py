"""Minimal protobuf wire-format encoder for the vg schema subset we emit.

Hand-rolled (no protoc dependency): only varint, length-delimited and the
few field numbers of vg.Position / Edit / Mapping / Path / Alignment that
GAM consumers read (field numbers from the public vg schema, mirrored in
the reference's vendored src/vg.proto:52-128).

JAX-free copy of graphchainer_tpu/io/vg_wire.py."""
from __future__ import annotations

import struct
from typing import List, Optional


def varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def tag(field: int, wire: int) -> bytes:
    return varint((field << 3) | wire)


def f_varint(field: int, value: int) -> bytes:
    if value == 0:
        return b""
    return tag(field, 0) + varint(value)


def f_bool(field: int, value: bool) -> bytes:
    return f_varint(field, 1 if value else 0)


def f_bytes(field: int, value: bytes) -> bytes:
    if not value:
        return b""
    return tag(field, 2) + varint(len(value)) + value


def f_str(field: int, value: str) -> bytes:
    return f_bytes(field, value.encode("utf-8"))


def f_msg(field: int, value: bytes) -> bytes:
    # empty submessages still get emitted (presence carries meaning)
    return tag(field, 2) + varint(len(value)) + value


def f_double(field: int, value: float) -> bytes:
    if value == 0.0:
        return b""
    return tag(field, 1) + struct.pack("<d", value)


def position(node_id: int, offset: int, is_reverse: bool,
             name: str = "") -> bytes:
    return (f_varint(1, node_id) + f_varint(2, offset)
            + f_bool(4, is_reverse) + f_str(5, name))


def edit(from_length: int, to_length: int, sequence: str = "") -> bytes:
    return (f_varint(1, from_length) + f_varint(2, to_length)
            + f_str(3, sequence))


def mapping(pos: bytes, edits: List[bytes], rank: int) -> bytes:
    out = f_msg(1, pos)
    for e in edits:
        out += f_msg(2, e)
    out += f_varint(5, rank)
    return out


def path(mappings: List[bytes], name: str = "") -> bytes:
    out = f_str(1, name)
    for m in mappings:
        out += f_msg(2, m)
    return out


def alignment(sequence: str, path_msg: Optional[bytes], name: str,
              score: int = 0, identity: float = 0.0,
              mapping_quality: int = 0, is_secondary: bool = False) -> bytes:
    out = f_str(1, sequence)
    if path_msg is not None:
        out += f_msg(2, path_msg)
    out += f_str(3, name)
    out += f_varint(5, mapping_quality)
    out += f_varint(6, score)
    out += f_bool(15, is_secondary)
    out += f_double(16, identity)
    return out


# ---------------------------------------------------------------------------
# Generic wire decoding (for .vg graph input and GAM seed files)

def decode_fields(data: bytes):
    """Yield (field_number, wire_type, value) triples; value is int for
    varint fields, bytes for length-delimited, raw int for fixed."""
    pos = 0
    n = len(data)
    while pos < n:
        key = 0
        shift = 0
        while True:
            b = data[pos]
            pos += 1
            key |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        field, wire = key >> 3, key & 7
        if wire == 0:
            val = 0
            shift = 0
            while True:
                b = data[pos]
                pos += 1
                val |= (b & 0x7F) << shift
                if not (b & 0x80):
                    break
                shift += 7
            yield field, wire, val
        elif wire == 2:
            ln = 0
            shift = 0
            while True:
                b = data[pos]
                pos += 1
                ln |= (b & 0x7F) << shift
                if not (b & 0x80):
                    break
                shift += 7
            yield field, wire, data[pos:pos + ln]
            pos += ln
        elif wire == 1:
            yield field, wire, int.from_bytes(data[pos:pos + 8], "little")
            pos += 8
        elif wire == 5:
            yield field, wire, int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")


def to_dict(data: bytes, schema) -> dict:
    """Decode with a schema {field: (name, kind)} where kind is 'int',
    'str', 'bytes', 'msg:<subschema key>' handled by caller, or a callable
    applied to the raw value.  Repeated fields accumulate into lists."""
    out = {}
    for field, wire, val in decode_fields(data):
        if field not in schema:
            continue
        name, kind = schema[field][0], schema[field][1]
        if kind == "int":
            v = val
        elif kind == "str":
            v = val.decode("utf-8")
        elif kind == "bytes":
            v = val
        elif callable(kind):
            v = kind(val)
        else:
            raise ValueError(kind)
        if len(schema[field]) > 2 and schema[field][2] == "repeated":
            out.setdefault(name, []).append(v)
        else:
            out[name] = v
    return out
