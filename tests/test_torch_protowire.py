"""The scenarios of ``tests/test_protowire.py`` on the port: the port's copy of ``grpc_plane/protowire.py``.

The reference file's own docstring:

Protobuf wire compatibility: differential vs google.protobuf + gRPC e2e.

The hand-rolled codec (grpc_plane/protowire.py) must produce/consume bytes
the REAL protobuf runtime accepts, for the nidx message subset
(nidx_protos/nidx.proto:8-34, nodereader.proto:388-476). Descriptors are
built dynamically (no protoc in the image) mirroring the reference's field
numbers, giving a genuine two-implementation check; the e2e test then calls
the node's NidxSearcher/NidxApi services with real proto bytes.
"""

import numpy as np
import pytest
from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

from nucliadb_tpu_torch.grpc_plane import protowire as pw

T = descriptor_pb2.FieldDescriptorProto

_TYPES = {
    "string": T.TYPE_STRING,
    "bytes": T.TYPE_BYTES,
    "bool": T.TYPE_BOOL,
    "int32": T.TYPE_INT32,
    "int64": T.TYPE_INT64,
    "uint32": T.TYPE_UINT32,
    "uint64": T.TYPE_UINT64,
    "float": T.TYPE_FLOAT,
    "double": T.TYPE_DOUBLE,
    "enum": T.TYPE_INT32,  # enums ride as int32 on the wire for this test
}


def _build_messages():
    """Dynamic descriptors for the message subset, mirroring the reference's
    field numbers (nodereader.proto / nodewriter.proto / noderesources.proto)."""
    fdp = descriptor_pb2.FileDescriptorProto()
    fdp.name = "tw.proto"
    fdp.package = "tw"
    fdp.syntax = "proto3"

    def msg(name):
        m = fdp.message_type.add()
        m.name = name
        return m

    def field(m, name, num, kind, *, repeated=False, type_name=None):
        f = m.field.add()
        f.name = name
        f.number = num
        f.label = T.LABEL_REPEATED if repeated else T.LABEL_OPTIONAL
        if type_name:
            f.type = T.TYPE_MESSAGE
            f.type_name = f".tw.{type_name}"
        else:
            f.type = _TYPES[kind]

    def map_field(m, name, num, value_type_name):
        entry = m.nested_type.add()
        entry.name = name.title().replace("_", "") + "Entry"
        entry.options.map_entry = True
        k = entry.field.add()
        k.name, k.number, k.label, k.type = "key", 1, T.LABEL_OPTIONAL, T.TYPE_STRING
        v = entry.field.add()
        v.name, v.number, v.label = "value", 2, T.LABEL_OPTIONAL
        v.type = T.TYPE_MESSAGE
        v.type_name = f".tw.{value_type_name}"
        f = m.field.add()
        f.name, f.number, f.label = name, num, T.LABEL_REPEATED
        f.type = T.TYPE_MESSAGE
        f.type_name = f".tw.{m.name}.{entry.name}"

    m = msg("Security")
    field(m, "access_groups", 1, "string", repeated=True)
    m = msg("Faceted")
    field(m, "labels", 1, "string", repeated=True)
    m = msg("SearchRequest")
    field(m, "shard_ids", 1, "string", repeated=True)
    field(m, "body", 3, "string")
    field(m, "faceted", 6, None, type_name="Faceted")
    field(m, "result_per_page", 8, "int32")
    field(m, "vector", 10, "float", repeated=True)
    field(m, "paragraph", 12, "bool")
    field(m, "document", 13, "bool")
    field(m, "vectorset", 15, "string")
    field(m, "only_faceted", 16, "bool")
    field(m, "min_score_semantic", 23, "float")
    field(m, "security", 24, None, type_name="Security")
    field(m, "min_score_bm25", 25, "float")

    m = msg("ResultScore")
    field(m, "bm25", 1, "float")
    field(m, "docaddr", 3, "uint64")
    m = msg("FacetResult")
    field(m, "tag", 1, "string")
    field(m, "total", 2, "int32")
    m = msg("FacetResults")
    field(m, "facetresults", 1, None, type_name="FacetResult")
    m.field[-1].label = T.LABEL_REPEATED
    m = msg("ParagraphResult")
    field(m, "uuid", 1, "string")
    field(m, "field", 3, "string")
    field(m, "start", 4, "uint64")
    field(m, "end", 5, "uint64")
    field(m, "paragraph", 6, "string")
    field(m, "split", 7, "string")
    field(m, "index", 8, "uint64")
    field(m, "score", 9, None, type_name="ResultScore")
    field(m, "matches", 10, "string", repeated=True)
    field(m, "labels", 12, "string", repeated=True)
    m = msg("ParagraphSearchResponse")
    field(m, "total", 1, "int32")
    field(m, "results", 2, None, type_name="ParagraphResult")
    m.field[-1].label = T.LABEL_REPEATED
    map_field(m, "facets", 3, "FacetResults")
    field(m, "query", 6, "string")
    field(m, "next_page", 7, "bool")
    field(m, "ematches", 9, "string", repeated=True)
    m = msg("DocumentResult")
    field(m, "uuid", 1, "string")
    field(m, "score", 3, None, type_name="ResultScore")
    field(m, "field", 4, "string")
    field(m, "labels", 5, "string", repeated=True)
    m = msg("DocumentSearchResponse")
    field(m, "total", 1, "int32")
    field(m, "results", 2, None, type_name="DocumentResult")
    m.field[-1].label = T.LABEL_REPEATED
    map_field(m, "facets", 3, "FacetResults")
    field(m, "query", 6, "string")
    field(m, "next_page", 7, "bool")
    m = msg("DocumentVectorIdentifier")
    field(m, "id", 1, "string")
    m = msg("DocumentScored")
    field(m, "doc_id", 1, None, type_name="DocumentVectorIdentifier")
    field(m, "score", 2, "float")
    field(m, "labels", 4, "string", repeated=True)
    m = msg("VectorSearchResponse")
    field(m, "documents", 1, None, type_name="DocumentScored")
    m.field[-1].label = T.LABEL_REPEATED
    m = msg("SearchResponse")
    field(m, "document", 1, None, type_name="DocumentSearchResponse")
    field(m, "paragraph", 2, None, type_name="ParagraphSearchResponse")
    field(m, "vector", 3, None, type_name="VectorSearchResponse")
    field(m, "shard_ids", 6, "string", repeated=True)

    m = msg("VectorIndexConfig")
    field(m, "similarity", 1, "enum")
    field(m, "normalize_vectors", 2, "bool")
    field(m, "vector_type", 3, "enum")
    field(m, "vector_dimension", 4, "uint32")
    m = msg("NewShardRequest")
    field(m, "kbid", 2, "string")
    map_field(m, "vectorsets_configs", 6, "VectorIndexConfig")
    field(m, "prewarm_enabled", 7, "bool")
    field(m, "features", 10, "string", repeated=True)
    m = msg("ShardCreated")
    field(m, "id", 1, "string")
    m = msg("ShardId")
    field(m, "id", 1, "string")
    m = msg("GetShardRequest")
    field(m, "shard_id", 1, None, type_name="ShardId")
    field(m, "vectorset", 2, "string")
    m = msg("Shard")
    field(m, "shard_id", 1, "string")
    field(m, "fields", 2, "uint64")
    field(m, "paragraphs", 3, "uint64")
    field(m, "sentences", 4, "uint64")
    field(m, "size_bytes", 6, "uint64")
    m = msg("SuggestRequest")
    field(m, "shard_ids", 1, "string", repeated=True)
    field(m, "body", 2, "string")
    field(m, "features", 6, "enum", repeated=True)
    field(m, "top_k", 11, "uint32")
    m = msg("SuggestResponse")
    field(m, "total", 1, "int32")
    field(m, "results", 2, None, type_name="ParagraphResult")
    m.field[-1].label = T.LABEL_REPEATED
    field(m, "query", 3, "string")
    field(m, "ematches", 4, "string", repeated=True)
    field(m, "shard_ids", 7, "string", repeated=True)

    pool = descriptor_pool.DescriptorPool()
    fd = pool.Add(fdp)
    return {
        name: message_factory.GetMessageClass(pool.FindMessageTypeByName(f"tw.{name}"))
        for name in [mt.name for mt in fdp.message_type]
    }


MSGS = _build_messages()


def _fill(pb_msg, data: dict):
    for k, v in data.items():
        field = pb_msg.DESCRIPTOR.fields_by_name[k]
        if field.label == field.LABEL_REPEATED:
            if field.message_type is not None and field.message_type.GetOptions().map_entry:
                for mk, mv in v.items():
                    _fill(getattr(pb_msg, k)[mk], mv)
            elif field.message_type is not None:
                for item in v:
                    _fill(getattr(pb_msg, k).add(), item)
            else:
                getattr(pb_msg, k).extend(v)
        elif field.message_type is not None:
            _fill(getattr(pb_msg, k), v)
        else:
            setattr(pb_msg, k, v)


SEARCH_REQ = {
    "shard_ids": ["s1", "s2"],
    "body": "quantum flux",
    "faceted": {"labels": ["/t", "/n/s"]},
    "result_per_page": 17,
    "vector": [0.25, -1.5, 3.0],
    "paragraph": True,
    "document": True,
    "vectorset": "semantic",
    "min_score_semantic": 0.5,
    "security": {"access_groups": ["g1"]},
    "min_score_bm25": 0.125,
}

SEARCH_RESP = {
    "shard_ids": ["s1"],
    "document": {
        "total": 3,
        "results": [
            {"uuid": "r1", "field": "f/a", "score": {"bm25": 1.5}, "labels": ["/t"]},
        ],
        "facets": {"/t": {"facetresults": [{"tag": "/t/x", "total": 2}]}},
        "query": "q",
    },
    "paragraph": {
        "total": 2,
        "results": [
            {"uuid": "r1", "field": "f/a", "start": 5, "end": 25,
             "paragraph": "r1/f/a/5-25", "index": 1,
             "score": {"bm25": 2.25}},
        ],
        "query": "q",
        "ematches": ["r1/f/a/5-25"],
    },
    "vector": {
        "documents": [
            {"doc_id": {"id": "r1/f/a/0"}, "score": 0.875, "labels": ["/t"]},
        ]
    },
}

NEW_SHARD = {
    "kbid": "kb1",
    "vectorsets_configs": {
        "semantic": {"similarity": 1, "normalize_vectors": True,
                     "vector_dimension": 128},
    },
    "features": ["ff1"],
}


@pytest.mark.parametrize(
    "name,schema,payload",
    [
        ("SearchRequest", pw.SEARCH_REQUEST, SEARCH_REQ),
        ("SearchResponse", pw.SEARCH_RESPONSE, SEARCH_RESP),
        ("NewShardRequest", pw.NEW_SHARD_REQUEST, NEW_SHARD),
        ("GetShardRequest", pw.GET_SHARD_REQUEST,
         {"shard_id": {"id": "abc"}, "vectorset": "v"}),
        ("Shard", pw.SHARD,
         {"shard_id": "s", "fields": 10, "paragraphs": 20, "sentences": 30,
          "size_bytes": 1 << 40}),
        ("SuggestRequest", pw.SUGGEST_REQUEST,
         {"shard_ids": ["s1"], "body": "qu", "features": [1], "top_k": 7}),
    ],
)
def test_codec_matches_google_protobuf(name, schema, payload):
    """Ours -> real parses identically; real -> ours decodes identically."""
    cls = MSGS[name]

    # our bytes parse with the real runtime into the same content
    ours = pw.encode(schema, payload)
    real = cls()
    real.ParseFromString(ours)
    reencoded = real.SerializeToString()
    # the real runtime's bytes decode with our codec into the same dict
    decoded = pw.decode(schema, reencoded)

    def norm(d):
        if isinstance(d, dict):
            return {k: norm(v) for k, v in sorted(d.items())}
        if isinstance(d, list):
            return [norm(x) for x in d]
        if isinstance(d, float):
            return round(d, 5)
        return d

    assert norm(decoded) == norm(payload)


def test_negative_int32_and_defaults():
    schema = {"a": (1, "int32"), "b": (2, "string")}
    # negative int32 -> 10-byte varint per spec
    data = pw.encode(schema, {"a": -5})
    assert pw.decode(schema, data) == {"a": -5}
    # presence is dict-key presence: explicit defaults are EMITTED (the
    # reference protos' `optional` scalars carry meaning at their default,
    # e.g. GraphQuery.Node.node_type=ENTITY(0)); absent/None keys are not
    assert pw.encode(schema, {}) == b""
    assert pw.encode(schema, {"a": None, "b": None}) == b""
    explicit = pw.encode(schema, {"a": 0, "b": ""})
    assert explicit != b""
    assert pw.decode(schema, explicit) == {"a": 0, "b": ""}


def test_unknown_fields_skipped():
    schema_full = {"a": (1, "int32"), "b": (2, "string"), "c": (3, ("rep", "float"))}
    schema_partial = {"b": (2, "string")}
    data = pw.encode(schema_full, {"a": 7, "b": "hi", "c": [1.0, 2.0]})
    assert pw.decode(schema_partial, data) == {"b": "hi"}


# --------------------------------------------------------------------------
# gRPC e2e with real proto bytes
# --------------------------------------------------------------------------


def test_proto_grpc_end_to_end(tmp_path):
    """A client speaking REAL protobuf bytes (google.protobuf serialization)
    runs NewShard -> index -> Search/Suggest/GetShard against the node's
    protobuf-wire services."""
    import grpc

    from nucliadb_tpu_torch.grpc_plane import NodeGrpcServer
    from nucliadb_tpu_torch.models.internal import (
        IndexParagraph,
        ResourceDoc,
        TextInformation,
        VectorSentence,
    )
    from nucliadb_tpu_torch.services import EmbeddedNode

    node = EmbeddedNode(device="cpu", data_dir=str(tmp_path / "node"))
    server = NodeGrpcServer(node, address="127.0.0.1:0")
    server.start()
    try:
        channel = grpc.insecure_channel(f"127.0.0.1:{server.port}")

        def call(service, method, req_msg, resp_name):
            fn = channel.unary_unary(
                f"/nidx.{service}/{method}",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=MSGS[resp_name].FromString,
            )
            return fn(req_msg, timeout=30)

        # NewShard with a vectorset over real proto bytes
        req = MSGS["NewShardRequest"]()
        _fill(req, NEW_SHARD)
        created = call("NidxApi", "NewShard", req, "ShardCreated")
        assert created.id

        # index a resource through the native path
        text = "the quantum flux capacitor hums"
        doc = ResourceDoc(resource_id="r1")
        doc.texts["t/body"] = TextInformation(text=text)
        para = IndexParagraph(start=0, end=len(text))
        vec = np.ones(128, np.float32)
        para.vectorsets_sentences["semantic"] = {
            f"r1/t/body/0/0-{len(text)}": VectorSentence(
                vector=(vec / np.linalg.norm(vec))
            )
        }
        doc.paragraphs["t/body"] = {f"r1/t/body/0-{len(text)}": para}
        node.index(created.id, doc)
        node.wait_for_sync()

        # Search over real proto bytes
        sreq = MSGS["SearchRequest"]()
        _fill(sreq, {
            "shard_ids": [created.id],
            "body": "quantum flux",
            "paragraph": True,
            "document": True,
            "result_per_page": 10,
            "vector": np.ones(128, np.float32).tolist(),
            "vectorset": "semantic",
        })
        resp = call("NidxSearcher", "Search", sreq, "SearchResponse")
        assert resp.paragraph.results[0].uuid == "r1"
        assert resp.paragraph.results[0].paragraph == "r1/t/body/0-31"
        assert resp.paragraph.results[0].score.bm25 > 0
        assert resp.document.results[0].uuid == "r1"
        assert resp.vector.documents[0].doc_id.id.startswith("r1/t/body/")
        assert resp.vector.documents[0].score > 0

        # Suggest
        sugg = MSGS["SuggestRequest"]()
        _fill(sugg, {"shard_ids": [created.id], "body": "quant", "top_k": 5})
        sresp = call("NidxSearcher", "Suggest", sugg, "SuggestResponse")
        assert sresp.results and sresp.results[0].uuid == "r1"

        # GetShard stats
        greq = MSGS["GetShardRequest"]()
        _fill(greq, {"shard_id": {"id": created.id}})
        shard = call("NidxApi", "GetShard", greq, "Shard")
        assert shard.shard_id == created.id
        assert shard.fields >= 1 and shard.paragraphs >= 1 and shard.sentences >= 1
    finally:
        server.stop()


def test_decode_rejects_truncated_messages():
    """Regression: a short length-delimited field silently yielded a
    truncated string; a truncated varint raised a bare IndexError."""
    import pytest

    from nucliadb_tpu_torch.grpc_plane import protowire as pw

    schema = {"id": (1, "string"), "n": (2, "int32")}
    good = pw.encode(schema, {"id": "shard-abc", "n": 7})
    assert pw.decode(schema, good) == {"id": "shard-abc", "n": 7}
    for cut in range(1, len(good)):
        if cut in (len(good),):
            continue
        try:
            out = pw.decode(schema, good[:cut])
        except ValueError:
            continue  # rejected: correct
        # any successful decode of a prefix must NOT contain a truncated id
        assert out.get("id") in (None, "shard-abc"), (cut, out)
