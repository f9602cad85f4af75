"""From-scratch Arrow IPC *streaming-format* writer (no pyarrow).

The port's copy of ``nucliadb_tpu/train/arrow_ipc.py``,
kept verbatim: the port imports nothing of the JAX package.

Why this exists: the train-export path originally encoded batches with
pyarrow from HTTP worker threads, and pyarrow's write machinery produced
rare interpreter segfaults under this process's thread/allocator mix (XLA
CPU client + grpc/upb + its own pools) — observed repeatedly at the same
spot across full-suite runs, surviving both a global encode lock and the
system memory pool, and with `pa.array`'s object loop already bypassed.
A pure-Python writer cannot segfault, costs nothing at these data rates
(exports are disk/HTTP-bound), and keeps the byte format: tests parse
every stream/partition back with the PYARROW READER, making this a
two-implementation differential check of the format.

Format reference: the Arrow columnar IPC specification (streaming format;
Message/Schema/RecordBatch flatbuffers from Message.fbs + Schema.fbs,
MetadataVersion V5). Field-slot numbers below follow those .fbs
definitions. Supported column types — the ones train batches contain:
``utf8``, ``list<utf8>``, ``list<list<utf8>>`` (arbitrary list nesting of
utf8 works). All arrays are non-nullable (null_count 0, empty validity
buffers — the layout the spec prescribes for null-free data).
"""

from __future__ import annotations

import struct
from typing import Iterable

import flatbuffers

# MessageHeader union member ids (Message.fbs)
_HEADER_SCHEMA = 1
_HEADER_RECORD_BATCH = 3
# Type union member ids (Schema.fbs)
_TYPE_UTF8 = 5
_TYPE_LIST = 12
_METADATA_V5 = 4  # MetadataVersion.V5
_LITTLE_ENDIAN = 0

CONTINUATION = b"\xff\xff\xff\xff"
EOS = CONTINUATION + b"\x00\x00\x00\x00"


def _pad8(n: int) -> int:
    return (8 - n % 8) % 8


# --------------------------------------------------------------------------
# column type descriptors
# --------------------------------------------------------------------------


class Utf8:
    children: tuple = ()

    def __repr__(self):
        return "utf8"


class List:
    def __init__(self, value_type):
        self.value_type = value_type
        self.children = (value_type,)

    def __repr__(self):
        return f"list<{self.value_type!r}>"


def infer_type(sample_column: list):
    """Type for one column from its first value (matches the batch
    dataclasses: str | list[str] | list[list[str]])."""
    v = sample_column
    depth = 0
    while v and isinstance(v[0], list):
        depth += 1
        v = v[0]
    t: object = Utf8()
    for _ in range(depth):
        t = List(t)
    return t


# --------------------------------------------------------------------------
# flatbuffer messages
# --------------------------------------------------------------------------


def _finish_message(b: flatbuffers.Builder, header_type: int, header_off: int,
                    body_length: int) -> bytes:
    # Message: version(0), header_type(1), header(2), bodyLength(3)
    b.StartObject(5)
    b.PrependInt16Slot(0, _METADATA_V5, 0)
    b.PrependUint8Slot(1, header_type, 0)
    b.PrependUOffsetTRelativeSlot(2, header_off, 0)
    b.PrependInt64Slot(3, body_length, 0)
    msg = b.EndObject()
    b.Finish(msg)
    return bytes(b.Output())


def _field_offset(b: flatbuffers.Builder, name: str, ftype) -> int:
    """Field table: name(0), nullable(1), type_type(2), type(3),
    dictionary(4), children(5), custom_metadata(6)."""
    name_off = b.CreateString(name)
    child_offs = [_field_offset(b, "item", c) for c in ftype.children]
    children_vec = 0
    if child_offs:
        b.StartVector(4, len(child_offs), 4)
        for off in reversed(child_offs):
            b.PrependUOffsetTRelative(off)
        children_vec = b.EndVector()
    # empty type tables (Utf8 {} / List {})
    b.StartObject(0)
    type_off = b.EndObject()
    type_id = _TYPE_UTF8 if isinstance(ftype, Utf8) else _TYPE_LIST
    b.StartObject(7)
    b.PrependUOffsetTRelativeSlot(0, name_off, 0)
    b.PrependBoolSlot(1, True, False)  # nullable (arrow defaults fields nullable)
    b.PrependUint8Slot(2, type_id, 0)
    b.PrependUOffsetTRelativeSlot(3, type_off, 0)
    if children_vec:
        b.PrependUOffsetTRelativeSlot(5, children_vec, 0)
    return b.EndObject()


def schema_message(fields: "list[tuple[str, object]]") -> bytes:
    """One encapsulated Schema message for [(name, type_descriptor)]."""
    b = flatbuffers.Builder(256)
    field_offs = [_field_offset(b, name, t) for name, t in fields]
    b.StartVector(4, len(field_offs), 4)
    for off in reversed(field_offs):
        b.PrependUOffsetTRelative(off)
    fields_vec = b.EndVector()
    # Schema: endianness(0), fields(1), custom_metadata(2), features(3)
    b.StartObject(4)
    b.PrependInt16Slot(0, _LITTLE_ENDIAN, 0)
    b.PrependUOffsetTRelativeSlot(1, fields_vec, 0)
    schema = b.EndObject()
    flat = _finish_message(b, _HEADER_SCHEMA, schema, 0)
    return _encapsulate(flat, b"")


def _encapsulate(flatbuf: bytes, body: bytes) -> bytes:
    meta_len = len(flatbuf)
    pad = _pad8(4 + 4 + meta_len)  # prefix counts toward 8-byte alignment
    out = bytearray()
    out += CONTINUATION
    out += struct.pack("<i", meta_len + pad)
    out += flatbuf
    out += b"\x00" * pad
    out += body
    return bytes(out)


# --------------------------------------------------------------------------
# record batches
# --------------------------------------------------------------------------


def _encode_array(values: list, ftype, nodes: list, buffers: list,
                  body: bytearray) -> None:
    """Append this array's node, buffers and body bytes (preorder, as the
    spec lays out nested columns)."""

    def add_buffer(data: bytes) -> None:
        offset = len(body)
        buffers.append((offset, len(data)))
        body.extend(data)
        body.extend(b"\x00" * _pad8(len(data)))

    n = len(values)
    nodes.append((n, 0))  # length, null_count
    add_buffer(b"")  # validity: empty for null-free arrays
    if isinstance(ftype, Utf8):
        encoded = [str(v).encode("utf-8") for v in values]
        offsets = bytearray(struct.pack("<i", 0))
        pos = 0
        for e in encoded:
            pos += len(e)
            offsets += struct.pack("<i", pos)
        add_buffer(bytes(offsets))
        add_buffer(b"".join(encoded))
        return
    # List: int32 offsets + child array
    offsets = bytearray(struct.pack("<i", 0))
    pos = 0
    for v in values:
        pos += len(v)
        offsets += struct.pack("<i", pos)
    add_buffer(bytes(offsets))
    flat = [item for v in values for item in v]
    _encode_array(flat, ftype.value_type, nodes, buffers, body)


def record_batch_message(columns: "list[tuple[list, object]]") -> bytes:
    """One encapsulated RecordBatch message for [(values, type)] columns."""
    nodes: list[tuple[int, int]] = []
    buffers: list[tuple[int, int]] = []
    body = bytearray()
    length = len(columns[0][0]) if columns else 0
    for values, ftype in columns:
        _encode_array(values, ftype, nodes, buffers, body)

    b = flatbuffers.Builder(256)
    # nodes: vector of FieldNode structs {length: long, null_count: long}
    b.StartVector(16, len(nodes), 8)
    for ln, nulls in reversed(nodes):
        b.PrependInt64(nulls)
        b.PrependInt64(ln)
    nodes_vec = b.EndVector()
    # buffers: vector of Buffer structs {offset: long, length: long}
    b.StartVector(16, len(buffers), 8)
    for off, ln in reversed(buffers):
        b.PrependInt64(ln)
        b.PrependInt64(off)
    buffers_vec = b.EndVector()
    # RecordBatch: length(0), nodes(1), buffers(2), compression(3)
    b.StartObject(5)
    b.PrependInt64Slot(0, length, 0)
    b.PrependUOffsetTRelativeSlot(1, nodes_vec, 0)
    b.PrependUOffsetTRelativeSlot(2, buffers_vec, 0)
    batch = b.EndObject()
    flat = _finish_message(b, _HEADER_RECORD_BATCH, batch, len(body))
    return _encapsulate(flat, bytes(body))


# --------------------------------------------------------------------------
# stream writer
# --------------------------------------------------------------------------


class ArrowStreamWriter:
    """Arrow IPC streaming-format writer over any .write()-able sink."""

    def __init__(self, sink, fields: "list[tuple[str, object]]"):
        self.sink = sink
        self.fields = fields
        self.sink.write(schema_message(fields))

    def write_batch(self, columns: dict) -> None:
        cols = [(columns[name], t) for name, t in self.fields]
        self.sink.write(record_batch_message(cols))

    def close(self) -> None:
        self.sink.write(EOS)


def write_stream(sink, fields, batches: Iterable[dict]) -> None:
    w = ArrowStreamWriter(sink, fields)
    for batch in batches:
        w.write_batch(batch)
    w.close()
