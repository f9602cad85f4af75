"""The scenarios of ``tests/test_extracted_texts.py`` on the port: stored texts through the port's node and gRPC plane on the CPU.

The reference file's own docstring:

ExtractedTexts + vectorset admin + ConfigureShards gRPC surface.

Parity: nidx.proto:13-30 (ConfigureShards, RemoveVectorSet, ListVectorSets,
ExtractedTexts) and the stored-text field behind them (tantivy stored `text`
field, nidx_text/src/lib.rs:130-240 get_fields_text).
"""

import grpc
import msgpack
import numpy as np
import pytest

from nucliadb_tpu_torch.index.text_engine.builder import (
    DocEntry,
    build_segment,
    merge_text_segments,
    open_text_segment,
)
from nucliadb_tpu_torch.index.vector import VectorConfig
from nucliadb_tpu_torch.models.internal import (
    IndexParagraph,
    ResourceDoc,
    TextInformation,
)
from nucliadb_tpu_torch.services import EmbeddedNode
from nucliadb_tpu_torch.storage import MemoryStorage
from nucliadb_tpu_torch.types import Seq


# ---- stored text: segment roundtrip + merge carry-through -------------------


def test_stored_text_roundtrip(tmp_path):
    docs = [
        DocEntry(key="r1/t/a", text="alpha beta gamma"),
        DocEntry(key="r1/t/b", text="delta " * 500),  # compresses well
        DocEntry(key="r2/t/a", text=""),
    ]
    meta = build_segment(str(tmp_path / "s"), docs, kind="text", store_text=True)
    seg = open_text_segment(meta.path)
    assert seg.has_stored_text
    assert seg.stored_text(0) == "alpha beta gamma"
    assert seg.stored_text(1) == "delta " * 500
    assert seg.stored_text(2) == ""


def test_stored_text_absent_without_flag(tmp_path):
    meta = build_segment(
        str(tmp_path / "s"), [DocEntry(key="k", text="x")], kind="paragraph"
    )
    seg = open_text_segment(meta.path)
    assert not seg.has_stored_text


class _Open:
    def __init__(self, segs, deletions=()):
        self._segs = segs
        self._dels = list(deletions)

    def segments(self):
        return list(self._segs)

    def deletions(self):
        return list(self._dels)


def test_merge_carries_stored_text(tmp_path):
    m1 = build_segment(
        str(tmp_path / "a"),
        [DocEntry(key="r1/t/a", text="one two"), DocEntry(key="r3/t/a", text="three")],
        kind="text", store_text=True,
    )
    m2 = build_segment(
        str(tmp_path / "b"),
        [DocEntry(key="r2/t/a", text="four five six")],
        kind="text", store_text=True,
    )
    merged = merge_text_segments(
        str(tmp_path / "m"),
        _Open([(open_text_segment(m1.path), Seq(1)), (open_text_segment(m2.path), Seq(2))],
              deletions=[("r3/", Seq(3))]),
        kind="text",
    )
    seg = open_text_segment(merged.path)
    assert seg.has_stored_text
    texts = {seg.keys[i]: seg.stored_text(i) for i in range(seg.n_docs)}
    assert texts == {"r1/t/a": "one two", "r2/t/a": "four five six"}


def test_merge_mixed_stored_drops_stored(tmp_path):
    m1 = build_segment(
        str(tmp_path / "a"), [DocEntry(key="k1", text="x")], kind="text",
        store_text=True,
    )
    m2 = build_segment(
        str(tmp_path / "b"), [DocEntry(key="k2", text="y")], kind="text",
    )
    merged = merge_text_segments(
        str(tmp_path / "m"),
        _Open([(open_text_segment(m1.path), Seq(1)), (open_text_segment(m2.path), Seq(2))]),
        kind="text",
    )
    assert not open_text_segment(merged.path).has_stored_text


# ---- node-level ExtractedTexts ----------------------------------------------


def _resource_with_conversation(rid):
    rd = ResourceDoc(resource_id=rid, created=1000, modified=1000)
    text = "first paragraph here.\n\nsecond paragraph text."
    rd.texts["t/t1"] = TextInformation(text=text)
    rd.paragraphs["t/t1"] = {
        f"{rid}/t/t1/0-21": IndexParagraph(start=0, end=21),
        f"{rid}/t/t1/23-45": IndexParagraph(start=23, end=45),
    }
    conv = "alice: hi there\nbob: hello alice"
    rd.texts["c/chat"] = TextInformation(text=conv)
    rd.paragraphs["c/chat"] = {
        f"{rid}/c/chat/0-15": IndexParagraph(start=0, end=15, split="m1"),
        f"{rid}/c/chat/16-32": IndexParagraph(start=16, end=32, split="m2"),
    }
    return rd


@pytest.fixture
def node(tmp_path):
    return EmbeddedNode(device="cpu", data_dir=str(tmp_path / "node"), storage=MemoryStorage())


def test_node_extracted_texts(node):
    shard_id = node.create_shard("kb1", {})
    node.index(shard_id, _resource_with_conversation("r1"))
    node.wait_for_sync()

    out = node.extracted_texts(
        shard_id,
        field_ids=[
            {"rid": "r1", "field_type": "t", "field_name": "t1"},
            {"rid": "r1", "field_type": "c", "field_name": "chat", "split": "m2"},
            {"rid": "rX", "field_type": "t", "field_name": "t1"},  # absent
        ],
        paragraph_ids=[
            {"rid": "r1", "field_type": "t", "field_name": "t1",
             "paragraph_start": 23, "paragraph_end": 45},
        ],
    )
    assert out["fields"] == {
        "r1/t/t1": "first paragraph here.\n\nsecond paragraph text."
    }
    assert out["splits"] == {"r1/c/chat/m2": "bob: hello alice"}
    assert out["paragraphs"] == {"r1/t/t1/23-45": "second paragraph text."}


def test_extracted_texts_after_merge_and_update(node):
    shard_id = node.create_shard("kb1", {})
    node.index(shard_id, _resource_with_conversation("r1"))
    node.index(shard_id, _resource_with_conversation("r2"))
    # update r1 (new segment; deletion masks the old copy)
    upd = ResourceDoc(resource_id="r1", created=1000, modified=2000)
    upd.texts["t/t1"] = TextInformation(text="updated body")
    upd.paragraphs["t/t1"] = {"r1/t/t1/0-12": IndexParagraph(start=0, end=12)}
    node.index(shard_id, upd)
    node.tick_background()  # merges (if planned) must keep stored text
    node.wait_for_sync()

    out = node.extracted_texts(
        shard_id,
        field_ids=[
            {"rid": "r1", "field_type": "t", "field_name": "t1"},
            {"rid": "r2", "field_type": "t", "field_name": "t1"},
        ],
    )
    assert out["fields"]["r1/t/t1"] == "updated body"
    assert out["fields"]["r2/t/t1"].startswith("first paragraph")


# ---- gRPC surface -------------------------------------------------------------


def test_grpc_vectorsets_configure_extracted(node, tmp_path):
    from nucliadb_tpu_torch.grpc_plane.server import NodeGrpcServer

    shard_id = node.create_shard("kb1", {"m1": VectorConfig(dimension=8)})
    node.index(shard_id, _resource_with_conversation("r1"))
    node.wait_for_sync()

    server = NodeGrpcServer(node)
    server.start()
    addr = f"127.0.0.1:{server.port}"
    try:
        ch = grpc.insecure_channel(addr)

        def call(method, payload):
            fn = ch.unary_unary(
                f"/nidx.Node/{method}",
                request_serializer=msgpack.packb,
                response_deserializer=msgpack.unpackb,
            )
            return fn(payload)

        # vectorset admin
        call("AddVectorSet", {"shard_id": shard_id, "name": "m2",
                              "config": VectorConfig(dimension=8).to_dict()})
        assert call("ListVectorSets", {"shard_id": shard_id})["vectorsets"] == ["m1", "m2"]
        call("RemoveVectorSet", {"shard_id": shard_id, "name": "m1"})
        assert call("ListVectorSets", {"shard_id": shard_id})["vectorsets"] == ["m2"]

        # ConfigureShards persists prewarm into shard config
        call("ConfigureShards", {"configs": [
            {"shard_id": shard_id, "prewarm_enabled": True}
        ]})
        assert node.metadata.get_shard(shard_id).config["prewarm_enabled"] is True

        # ExtractedTexts over the wire
        out = call("ExtractedTexts", {
            "shard_id": shard_id,
            "field_ids": [{"rid": "r1", "field_type": "t", "field_name": "t1"}],
            "paragraph_ids": [{"rid": "r1", "field_type": "c", "field_name": "chat",
                               "split": "m1", "paragraph_start": 0,
                               "paragraph_end": 15}],
        })
        assert out["fields"]["r1/t/t1"].startswith("first paragraph")
        assert out["paragraphs"]["r1/c/chat/m1/0-15"] == "alice: hi there"
    finally:
        server.stop()


def test_protowire_extracted_texts_roundtrip():
    from nucliadb_tpu_torch.grpc_plane import protowire as pw

    req = {
        "shard_id": "s1",
        "field_ids": [{"rid": "r1", "field_type": "t", "field_name": "a",
                       "split": ""}],
        "paragraph_ids": [{"rid": "r1", "field_type": "t", "field_name": "a",
                           "split": "", "paragraph_start": 3,
                           "paragraph_end": 9}],
    }
    enc = pw.encode(pw.EXTRACTED_TEXTS_REQUEST, req)
    dec = pw.decode(pw.EXTRACTED_TEXTS_REQUEST, enc)
    assert dec["shard_id"] == "s1"
    assert dec["paragraph_ids"][0]["paragraph_end"] == 9

    resp = {"fields": {"r1/t/a": "hello"}, "splits": {}, "paragraphs": {"p": "x"}}
    enc = pw.encode(pw.EXTRACTED_TEXTS_RESPONSE, resp)
    dec = pw.decode(pw.EXTRACTED_TEXTS_RESPONSE, enc)
    assert dec["fields"] == {"r1/t/a": "hello"}
    assert dec["paragraphs"] == {"p": "x"}


def test_proto_compat_vectorset_wire(node):
    """Reference-shaped protobuf bytes drive the NidxApi vectorset methods."""
    from nucliadb_tpu_torch.grpc_plane import protowire as pw
    from nucliadb_tpu_torch.grpc_plane.server import NodeGrpcServer

    shard_id = node.create_shard("kb1", {"m1": VectorConfig(dimension=8)})
    server = NodeGrpcServer(node)
    server.start()
    try:
        ch = grpc.insecure_channel(f"127.0.0.1:{server.port}")

        def call(service, method, schema_in, schema_out, payload):
            fn = ch.unary_unary(
                f"/nidx.{service}/{method}",
                request_serializer=lambda m: pw.encode(schema_in, m),
                response_deserializer=lambda b: pw.decode(schema_out, b),
            )
            return fn(payload)

        out = call("NidxApi", "ListVectorSets", pw.SHARD_ID, pw.VECTOR_SET_LIST,
                   {"id": shard_id})
        assert out["vectorsets"] == ["m1"]

        call("NidxApi", "AddVectorSet", pw.NEW_VECTOR_SET_REQUEST, pw.OP_STATUS, {
            "id": {"shard": {"id": shard_id}, "vectorset": "m9"},
            "config": {"vector_dimension": 8, "similarity": 0},
        })
        out = call("NidxApi", "ListVectorSets", pw.SHARD_ID, pw.VECTOR_SET_LIST,
                   {"id": shard_id})
        assert out["vectorsets"] == ["m1", "m9"]

        call("NidxApi", "RemoveVectorSet", pw.VECTOR_SET_ID, pw.OP_STATUS,
             {"shard": {"id": shard_id}, "vectorset": "m1"})
        out = call("NidxApi", "ListVectorSets", pw.SHARD_ID, pw.VECTOR_SET_LIST,
                   {"id": shard_id})
        assert out["vectorsets"] == ["m9"]

        call("NidxApi", "ConfigureShards", pw.SHARDS_CONFIG, pw.EMPTY_QUERY,
             {"configs": [{"shard_id": shard_id, "prewarm_enabled": True}]})
        assert node.metadata.get_shard(shard_id).config["prewarm_enabled"] is True
    finally:
        server.stop()


def test_prewarm_loads_shard_eagerly(node):
    shard_id = node.create_shard("kb1", {})
    node.index(shard_id, _resource_with_conversation("r1"))
    node.configure_shards([{"shard_id": shard_id, "prewarm_enabled": True}])
    node.wait_for_sync()
    # prewarm: the searcher is open after sync without any query
    assert shard_id in node.searcher._shards

    node2_shard = node.create_shard("kb2", {})
    node.index(node2_shard, _resource_with_conversation("r9"))
    node.wait_for_sync()
    # non-prewarm shards stay lazy
    assert node2_shard not in node.searcher._shards
