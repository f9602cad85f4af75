"""The scenarios of ``tests/test_proto_plane_e2e.py`` on the port: the protobuf wire served by the port's ``NodeGrpcServer`` over a CPU node.

The reference file's own docstring:

End-to-end proto plane: a client speaking REAL protobuf bytes exercises
the full NidxApi/NidxIndexer/NidxSearcher surface (nidx_protos/nidx.proto:8-34)
— indexing Resource protos through NidxIndexer.Index, filtered Search
(field_filter/paragraph_filter/json_filter/filter_operator/advanced_query/
search_after/graph_search), GraphSearch projections, the Paragraphs/Documents
streams, Suggest with entities + security, and loud INVALID_ARGUMENT failures
for unknown fields and unsupported constructs.

VERDICT r2 "done" criterion: a filtered proto query returns FILTERED results
(round 2 silently dropped the filters and returned everything).
"""

import grpc
import numpy as np
import pytest

from nucliadb_tpu_torch.grpc_plane import NodeGrpcServer
from nucliadb_tpu_torch.grpc_plane import protowire as pw
from nucliadb_tpu_torch.services import EmbeddedNode
from tests.protowire_helpers import build_messages, fill

MSGS = build_messages({
    "NewShardRequest": pw.NEW_SHARD_REQUEST,
    "ShardCreated": pw.SHARD_CREATED,
    "ShardId": pw.SHARD_ID,
    "OpStatus": pw.OP_STATUS,
    "SearchRequest": pw.SEARCH_REQUEST,
    "SearchResponse": pw.SEARCH_RESPONSE,
    "SuggestRequest": pw.SUGGEST_REQUEST,
    "SuggestResponse": pw.SUGGEST_RESPONSE,
    "GraphSearchRequest": pw.GRAPH_SEARCH_REQUEST,
    "GraphSearchResponse": pw.GRAPH_SEARCH_RESPONSE,
    "StreamRequest": pw.STREAM_REQUEST,
    "ParagraphItem": pw.PARAGRAPH_ITEM,
    "DocumentItem": pw.DOCUMENT_ITEM,
    "IndexMessage": pw.INDEX_MESSAGE,
    "Resource": pw.RESOURCE,
})

DIM = 8


def unit_vec(seed: int) -> list[float]:
    r = np.random.default_rng(seed)
    v = r.standard_normal(DIM).astype(np.float32)
    return (v / np.linalg.norm(v)).tolist()


def resource_payload(rid, fields, labels=None, groups=None, price=None,
                     entity=None, created=1000):
    """fields: {field_id: text}. Builds a noderesources.Resource wire dict."""
    texts, paragraphs = {}, {}
    for fid, text in fields.items():
        texts[fid] = {"text": text}
        pid = f"{rid}/{fid}/0-{len(text)}"
        paragraphs[fid] = {
            "paragraphs": {
                pid: {
                    "start": 0,
                    "end": len(text),
                    "field": fid,
                    "vectorsets_sentences": {
                        "m": {
                            "sentences": {
                                f"{rid}/{fid}/0/0-{len(text)}": {
                                    "vector": unit_vec(abs(hash(text)) % (2**31)),
                                }
                            }
                        }
                    },
                }
            }
        }
    res = {
        "resource": {"uuid": rid},
        "metadata": {"created": {"seconds": created},
                     "modified": {"seconds": created}},
        "texts": texts,
        "labels": labels or [],
        "status": 0,
        "paragraphs": paragraphs,
    }
    if groups:
        res["security"] = {"access_groups": groups}
    if price is not None:
        first = next(iter(fields))
        res["json_fields"] = {first: {"value": f'{{"price": {price}}}'}}
    if entity is not None:
        res["field_relations"] = {
            "a/metadata": {
                "relations": [
                    {
                        "relation": {
                            "relation": 2,  # ENTITY
                            "source": {"value": rid, "ntype": 2},  # RESOURCE
                            "to": {"value": entity, "ntype": 0,  # ENTITY
                                   "subtype": "animal"},
                            "relation_label": "mentions",
                        },
                        "facets": ["/g/u"],
                    }
                ]
            }
        }
    return res


@pytest.fixture(scope="module")
def plane(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("proto_plane")
    node = EmbeddedNode(device="cpu", data_dir=str(tmp / "node"))
    server = NodeGrpcServer(node, address="127.0.0.1:0")
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{server.port}")

    def call(service, method, req_msg, resp_name, raw_request=None):
        fn = channel.unary_unary(
            f"/nidx.{service}/{method}",
            request_serializer=(lambda m: m) if raw_request else (
                lambda m: m.SerializeToString()
            ),
            response_deserializer=MSGS[resp_name].FromString,
        )
        return fn(raw_request if raw_request else req_msg, timeout=30)

    def stream(method, req_msg, resp_name):
        fn = channel.unary_stream(
            f"/nidx.NidxSearcher/{method}",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=MSGS[resp_name].FromString,
        )
        return list(fn(req_msg, timeout=30))

    req = MSGS["NewShardRequest"]()
    fill(req, {
        "kbid": "kb1",
        "vectorsets_configs": {
            "m": {"similarity": 1, "vector_dimension": DIM},
        },
    })
    shard_id = call("NidxApi", "NewShard", req, "ShardCreated").id

    def index_resource(payload):
        key = f"idx/{payload['resource']['uuid']}"
        node.storage.put(key, pw.encode(pw.RESOURCE, payload))
        im = MSGS["IndexMessage"]()
        fill(im, {"shard": shard_id, "resource": payload["resource"]["uuid"],
                  "typemessage": 0, "storage_key": key, "kbid": "kb1"})
        status = call("NidxIndexer", "Index", im, "OpStatus")
        assert status.status == 0

    index_resource(resource_payload(
        "r1", {"t/intro": "the quick brown fox runs"},
        labels=["/l/topic/animals"], price=10, entity="fox", created=1000,
    ))
    index_resource(resource_payload(
        "r2", {"t/intro": "markets rallied on quick gains"},
        labels=["/l/topic/finance"], groups=["finance"], price=99, created=2000,
    ))
    index_resource(resource_payload(
        "r3", {"t/body": "a quick bear in the fox woods"},
        labels=["/l/topic/animals"], entity="bear", created=3000,
    ))
    node.wait_for_sync()
    yield {"node": node, "call": call, "stream": stream, "shard": shard_id}
    server.stop(0.5)
    channel.close()


def search(plane, **payload):
    req = MSGS["SearchRequest"]()
    payload.setdefault("shard_ids", [plane["shard"]])
    payload.setdefault("result_per_page", 20)
    fill(req, payload)
    return plane["call"]("NidxSearcher", "Search", req, "SearchResponse")


def para_rids(resp):
    return sorted({r.uuid for r in resp.paragraph.results})


def test_unfiltered_vs_field_filter(plane):
    resp = search(plane, body="quick", paragraph=True)
    assert para_rids(resp) == ["r1", "r2", "r3"]
    # facet filter via FilterExpression — the round-2 plane DROPPED this
    resp = search(plane, body="quick", paragraph=True,
                  field_filter={"facet": {"facet": "/l/topic/animals"}})
    assert para_rids(resp) == ["r1", "r3"]
    # keyword field filter
    resp = search(plane, body="quick", paragraph=True,
                  field_filter={"keyword": {"keyword": "markets"}})
    assert para_rids(resp) == ["r2"]
    # boolean tree: animals AND NOT resource r1
    resp = search(plane, body="quick", paragraph=True, field_filter={
        "bool_and": {"operands": [
            {"facet": {"facet": "/l/topic/animals"}},
            {"bool_not": {"resource": {"resource_id": "r1"}}},
        ]}
    })
    assert para_rids(resp) == ["r3"]
    # date range (created >= 1500)
    resp = search(plane, body="quick", paragraph=True, field_filter={
        "date": {"field": 0, "since": {"seconds": 1500}}
    })
    assert para_rids(resp) == ["r2", "r3"]


def test_security_enforced_on_proto_plane(plane):
    resp = search(plane, body="quick", paragraph=True,
                  security={"access_groups": ["other"]})
    assert para_rids(resp) == ["r1", "r3"]  # r2 is finance-restricted
    resp = search(plane, body="quick", paragraph=True,
                  security={"access_groups": ["finance"]})
    assert para_rids(resp) == ["r1", "r2", "r3"]


def test_paragraph_filter_and_advanced_query(plane):
    resp = search(plane, body="quick", paragraph=True,
                  paragraph_filter={"keyword": {"keyword": "fox"}})
    assert para_rids(resp) == ["r1", "r3"]
    resp = search(plane, body="quick", paragraph=True, advanced_query="bear")
    assert para_rids(resp) == ["r3"]


def test_json_filter_and_filter_operator(plane):
    resp = search(plane, body="quick", paragraph=True,
                  json_filter={"path": {"json_path": "price",
                                        "int_range": {"lower": 50}}})
    assert para_rids(resp) == ["r2"]
    # OR combine: animals-field-filter OR price>=50 -> all three
    resp = search(plane, body="quick", paragraph=True,
                  field_filter={"facet": {"facet": "/l/topic/animals"}},
                  json_filter={"path": {"json_path": "price",
                                        "int_range": {"lower": 50}}},
                  filter_operator=1)
    assert para_rids(resp) == ["r1", "r2", "r3"]
    # AND combine (default): animals AND price>=50 -> none
    resp = search(plane, body="quick", paragraph=True,
                  field_filter={"facet": {"facet": "/l/topic/animals"}},
                  json_filter={"path": {"json_path": "price",
                                        "int_range": {"lower": 50}}})
    assert resp.paragraph.total == 0


def test_search_after_pagination(plane):
    seen: list[tuple] = []
    cursor = None
    for _ in range(4):
        payload = dict(body="quick", paragraph=True, result_per_page=1)
        if cursor is not None:
            payload["search_after"] = cursor
        resp = search(plane, **payload)
        if not resp.paragraph.results:
            break
        hit = resp.paragraph.results[0]
        seen.append((hit.uuid, hit.paragraph))
        cursor = {"score": hit.score.bm25, "shard_id": hit.shard_id,
                  "docaddr": hit.score.docaddr}
    assert len(seen) == 3
    assert len(set(seen)) == 3  # no overlap across pages
    # matches the single-shot top-3 ordering
    full = search(plane, body="quick", paragraph=True, result_per_page=3)
    assert [(r.uuid, r.paragraph) for r in full.paragraph.results] == seen


def test_vector_leg_and_with_duplicates(plane):
    resp = search(plane, body="", vector=unit_vec(1234), vectorset="m",
                  result_per_page=3)
    assert len(resp.vector.documents) == 3
    assert resp.vector.documents[0].doc_id.id.split("/")[0] in {"r1", "r2", "r3"}


def test_graph_search_leg_in_search(plane):
    resp = search(plane, body="quick", paragraph=True, graph_search={
        "query": {"path": {"path": {
            "destination": {"value": "fox", "exact": {"kind": 0}},
        }}}
    })
    assert len(resp.graph.graph) == 1
    path = resp.graph.graph[0]
    assert resp.graph.nodes[path.source].value == "r1"
    assert resp.graph.nodes[path.destination].value == "fox"
    assert resp.graph.relations[path.relation].label == "mentions"
    # inherited filters: restrict to r3 -> the r1 edge disappears
    resp = search(plane, body="quick", paragraph=True,
                  field_filter={"resource": {"resource_id": "r3"}},
                  graph_search={"query": {"path": {"path": {
                      "destination": {"value": "fox", "exact": {"kind": 0}},
                  }}}})
    assert len(resp.graph.graph) == 0


def graph_search(plane, **payload):
    req = MSGS["GraphSearchRequest"]()
    payload.setdefault("shard_ids", [plane["shard"]])
    payload.setdefault("top_k", 10)
    fill(req, payload)
    return plane["call"]("NidxSearcher", "GraphSearch", req, "GraphSearchResponse")


def test_graph_search_rpc_paths_nodes_relations(plane):
    # PATH with fuzzy source ("foxx" ~1 "fox" as destination value)
    resp = graph_search(plane, kind=0, query={"path": {"path": {
        "destination": {"value": "foxx", "fuzzy": {"kind": 0, "distance": 1}},
    }}})
    assert len(resp.graph) == 1
    assert resp.nodes[resp.graph[0].destination].value == "fox"

    # NODES projection takes node expressions: undirected source-only paths
    # (graph_query_parser.rs:644-689)
    resp = graph_search(plane, kind=1, query={"path": {"path": {
        "source": {"node_type": 0, "exact": {"kind": 0}}, "undirected": True,
    }}})
    values = sorted(n.value for n in resp.nodes)
    assert values == ["bear", "fox"]
    assert all(n.ntype == 0 for n in resp.nodes)
    assert len(resp.scores) == 2

    # RELATIONS projection
    resp = graph_search(plane, kind=2, query={"path": {"path": {}}})
    assert [(r.relation_type, r.label) for r in resp.relations] == [(2, "mentions")]

    # field_filter constrains edges by resource
    resp = graph_search(plane, kind=1,
                        field_filter={"resource": {"resource_id": "r3"}},
                        query={"path": {"path": {
                            "source": {"node_type": 0, "exact": {"kind": 0}},
                            "undirected": True,
                        }}})
    assert sorted(n.value for n in resp.nodes) == ["bear"]


def test_streams_with_filters(plane):
    req = MSGS["StreamRequest"]()
    fill(req, {"shard_id": {"id": plane["shard"]}})
    docs = plane["stream"]("Documents", req, "DocumentItem")
    assert sorted(d.uuid for d in docs) == ["r1", "r2", "r3"]
    assert all("/n/s/PROCESSED" in d.labels for d in docs)

    req = MSGS["StreamRequest"]()
    fill(req, {
        "shard_id": {"id": plane["shard"]},
        "filter_expression": {"facet": {"facet": "/l/topic/animals"}},
    })
    docs = plane["stream"]("Documents", req, "DocumentItem")
    assert sorted(d.uuid for d in docs) == ["r1", "r3"]

    # legacy StreamFilter labels, OR conjunction
    req = MSGS["StreamRequest"]()
    fill(req, {
        "shard_id": {"id": plane["shard"]},
        "filter": {"conjunction": 1,
                   "labels": ["/l/topic/finance", "/l/topic/animals"]},
    })
    paras = plane["stream"]("Paragraphs", req, "ParagraphItem")
    assert sorted({p.id.split("/")[0] for p in paras}) == ["r1", "r2", "r3"]
    assert all(p.labels for p in paras)

    # NOT conjunction
    req = MSGS["StreamRequest"]()
    fill(req, {
        "shard_id": {"id": plane["shard"]},
        "filter": {"conjunction": 2, "labels": ["/l/topic/animals"]},
    })
    paras = plane["stream"]("Paragraphs", req, "ParagraphItem")
    assert sorted({p.id.split("/")[0] for p in paras}) == ["r2"]


def test_suggest_with_entities_and_security(plane):
    req = MSGS["SuggestRequest"]()
    fill(req, {"shard_ids": [plane["shard"]], "body": "qui",
               "features": [0, 1], "top_k": 10})
    resp = plane["call"]("NidxSearcher", "Suggest", req, "SuggestResponse")
    assert {r.uuid for r in resp.results} == {"r1", "r2", "r3"}

    req = MSGS["SuggestRequest"]()
    fill(req, {"shard_ids": [plane["shard"]], "body": "be",
               "features": [0], "top_k": 10})
    resp = plane["call"]("NidxSearcher", "Suggest", req, "SuggestResponse")
    assert [n.value for n in resp.entity_results.nodes] == ["bear"]
    assert not resp.results  # ENTITIES-only: no paragraph leg

    # security restricts the paragraph suggestions
    req = MSGS["SuggestRequest"]()
    fill(req, {"shard_ids": [plane["shard"]], "body": "qui",
               "security": {"access_groups": ["other"]}, "top_k": 10})
    resp = plane["call"]("NidxSearcher", "Suggest", req, "SuggestResponse")
    assert {r.uuid for r in resp.results} == {"r1", "r3"}

    # field_filter reaches suggest as a key-prefix mask
    req = MSGS["SuggestRequest"]()
    fill(req, {"shard_ids": [plane["shard"]], "body": "qui",
               "field_filter": {"facet": {"facet": "/l/topic/finance"}},
               "top_k": 10})
    resp = plane["call"]("NidxSearcher", "Suggest", req, "SuggestResponse")
    assert {r.uuid for r in resp.results} == {"r2"}


def test_unknown_field_fails_loud(plane):
    """The round-2 failure mode: a filter this node does not know must be
    INVALID_ARGUMENT, never silently-unfiltered results."""
    schema_plus = dict(pw.SEARCH_REQUEST)
    schema_plus["future_filter"] = (90, "string")
    raw = pw.encode(schema_plus, {
        "shard_ids": [plane["shard"]], "body": "quick", "paragraph": True,
        "result_per_page": 10, "future_filter": "secret-constraint",
    })
    with pytest.raises(grpc.RpcError) as err:
        plane["call"]("NidxSearcher", "Search", None, "SearchResponse",
                      raw_request=raw)
    assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert "90" in err.value.details()


def test_vector_graph_match_without_vectorset_is_not_found(plane):
    # VectorMatch now resolves at the node plane (test_graph_vector_match.py);
    # a query that names no graph_node_vectorset answers NOT_FOUND, the
    # reference's NidxError::NotFound (shard_search.rs:363-380)
    req = MSGS["GraphSearchRequest"]()
    fill(req, {"shard_ids": [plane["shard"]], "top_k": 5, "query": {
        "path": {"path": {"destination": {"vector": {"vector": [0.1, 0.2]}}}}
    }})
    with pytest.raises(grpc.RpcError) as err:
        plane["call"]("NidxSearcher", "GraphSearch", req, "GraphSearchResponse")
    assert err.value.code() == grpc.StatusCode.NOT_FOUND


def test_deletion_index_message(plane):
    im = MSGS["IndexMessage"]()
    fill(im, {"shard": plane["shard"], "resource": "r3", "typemessage": 1})
    status = plane["call"]("NidxIndexer", "Index", im, "OpStatus")
    assert status.status == 0
    plane["node"].wait_for_sync()
    resp = search(plane, body="quick", paragraph=True)
    assert para_rids(resp) == ["r1", "r2"]
    # graph edges of r3 are gone too
    resp = graph_search(plane, kind=1, query={"path": {"path": {
        "source": {"node_type": 0, "exact": {"kind": 0}}, "undirected": True,
    }}})
    assert sorted(n.value for n in resp.nodes) == ["fox"]
