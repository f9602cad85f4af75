"""The scenarios of ``tests/test_protowire_full.py`` on the port: the port's copy of ``grpc_plane/protowire.py``.

The reference file's own docstring:

Differential wire tests for the round-3 protowire schema surface.

Every new message (FilterExpression, JsonFilterExpression, GraphQuery,
GraphSearchRequest/Response, SearchAfter, StreamRequest + items,
IndexMessage, the full noderesources.Resource) round-trips against the REAL
google.protobuf runtime via dynamic descriptors generated FROM the schemas
(tests/protowire_helpers.py) — two independent implementations of the same
field numbers (reference: nidx_protos/nodereader.proto:148-510,
nodewriter.proto:32-43, noderesources.proto:123-180).
"""

import pytest

from nucliadb_tpu_torch.grpc_plane import protowire as pw
from tests.protowire_helpers import build_messages, fill, to_dict

ROOTS = {
    "FilterExpression": pw.FILTER_EXPRESSION,
    "JsonFilterExpression": pw.JSON_FILTER_EXPRESSION,
    "GraphSearchRequest": pw.GRAPH_SEARCH_REQUEST,
    "GraphSearchResponse": pw.GRAPH_SEARCH_RESPONSE,
    "SearchRequest": pw.SEARCH_REQUEST,
    "SearchResponse": pw.SEARCH_RESPONSE,
    "SuggestRequest": pw.SUGGEST_REQUEST,
    "SuggestResponse": pw.SUGGEST_RESPONSE,
    "StreamRequest": pw.STREAM_REQUEST,
    "ParagraphItem": pw.PARAGRAPH_ITEM,
    "DocumentItem": pw.DOCUMENT_ITEM,
    "IndexMessage": pw.INDEX_MESSAGE,
    "Resource": pw.RESOURCE,
}

MSGS = build_messages(ROOTS)


FILTER_PAYLOAD = {
    "bool_and": {
        "operands": [
            {"facet": {"facet": "/l/topic/animals"}},
            {
                "bool_or": {
                    "operands": [
                        {"field": {"field_type": "t", "field_id": "intro"}},
                        {"keyword": {"keyword": "fox fund"}},
                        {"bool_not": {"resource": {"resource_id": "r-123"}}},
                    ]
                }
            },
            {
                "date": {
                    "field": 1,
                    "since": {"seconds": 1000, "nanos": 500000},
                    "until": {"seconds": 2000},
                }
            },
            {
                "resource_field_prefix": {
                    "resource_id": "r-9",
                    "field_type": "f",
                    "field_id_prefix": "doc",
                }
            },
        ]
    }
}

GRAPH_QUERY_PAYLOAD = {
    "path": {
        "bool_and": {
            "operands": [
                {
                    "path": {
                        "source": {
                            "value": "Rosa Parks",
                            "node_type": 0,
                            "node_subtype": "person",
                            "fuzzy": {"kind": 2, "distance": 1},
                        },
                        "relation": {"value": "born in", "relation_type": 2,
                                     "exact": {}},
                        "destination": {"value": "Alab", "exact": {"kind": 1}},
                        "undirected": True,
                    }
                },
                {"bool_not": {"facet": {"facet": "/g/da"}}},
            ]
        }
    }
}

PAYLOADS = {
    "FilterExpression": FILTER_PAYLOAD,
    "JsonFilterExpression": {
        "bool_or": {
            "operands": [
                {
                    "path": {
                        "field_id": "t/meta",
                        "json_path": "product.price",
                        "float_range": {"lower": 1.5, "upper": 99.25},
                    }
                },
                {
                    "bool_not": {
                        "path": {
                            "json_path": "tags",
                            "text": "obsolete",
                        }
                    }
                },
                {"path": {"json_path": "flags.active", "boolean": True}},
                {"path": {"json_path": "count", "int": 42}},
                {
                    "path": {
                        "json_path": "ts",
                        "date_range": {
                            "lower": {"seconds": 100},
                            "upper": {"seconds": 1700000000, "nanos": 250},
                        },
                    }
                },
            ]
        }
    },
    "GraphSearchRequest": {
        "shard_ids": ["s1", "s2"],
        "query": GRAPH_QUERY_PAYLOAD,
        "kind": 1,
        "top_k": 17,
        "security": {"access_groups": ["g1"]},
        "field_filter": {"facet": {"facet": "/l/x/y"}},
        "min_score_node_semantic": 0.25,
    },
    "GraphSearchResponse": {
        "nodes": [
            {"value": "A", "ntype": 0, "subtype": "person"},
            {"value": "B", "ntype": 2},
        ],
        "relations": [{"relation_type": 2, "label": "works at"}],
        "graph": [
            {
                "source": 0,
                "relation": 0,
                "destination": 1,
                "metadata": {"paragraph_id": "p1", "source_start": 3,
                             "to_end": 9, "data_augmentation_task_id": "da1"},
                "resource_field_id": "r1/t/body",
                "facets": ["/g/u"],
            }
        ],
        "scores": [2.5],
        "shard_ids": ["s1"],
    },
    "SearchRequest": {
        "shard_ids": ["shard-a"],
        "body": "quantum flux",
        "order": {"type": 1, "sort_by": 1},
        "result_per_page": 10,
        "vector": [0.5, -0.25, 1.0],
        "paragraph": True,
        "vectorset": "semantic",
        "advanced_query": "title:foo AND bar",
        "min_score_semantic": 0.3,
        "security": {"access_groups": ["sales"]},
        "field_filter": FILTER_PAYLOAD,
        "paragraph_filter": {"facet": {"facet": "/l/a/b"}},
        "filter_operator": 1,
        "graph_search": {"query": GRAPH_QUERY_PAYLOAD},
        "json_filter": {"path": {"json_path": "price", "int": 7}},
        "min_score_node_semantic": 0.1,
        "search_after": {"score": 1.5, "shard_id": b"shard-a", "docaddr": 77},
    },
    "SearchResponse": {
        "document": {"total": 3, "query": "q"},
        "paragraph": {
            "total": 2,
            "results": [
                {
                    "uuid": "r1",
                    "field": "/t/body",
                    "start": 5,
                    "end": 25,
                    "paragraph": "r1/t/body/5-25",
                    "score": {"bm25": 1.25, "docaddr": 3},
                    "labels": ["/l/a/b"],
                    "shard_id": b"s1",
                }
            ],
            "ematches": ["flux"],
        },
        "graph": {
            "nodes": [{"value": "A"}],
            "scores": [1.0],
        },
        "shard_ids": ["s1"],
    },
    "SuggestRequest": {
        "shard_ids": ["s1"],
        "body": "quan",
        "features": [0, 1],
        "field_filter": {"field": {"field_type": "t"}},
        "paragraph_filter": {"facet": {"facet": "/l/x"}},
        "filter_operator": 1,
        "security": {"access_groups": ["g"]},
        "top_k": 5,
    },
    "SuggestResponse": {
        "total": 1,
        "results": [{"uuid": "r1", "field": "/t/b", "paragraph": "p"}],
        "query": "quan",
        "ematches": ["quantum"],
        "entity_results": {
            "nodes": [{"value": "Quantum Inc", "ntype": 0, "subtype": "org"}]
        },
        "shard_ids": ["s1"],
    },
    "StreamRequest": {
        "shard_id": {"id": "s1"},
        "filter": {"conjunction": 1, "labels": ["/l/a", "/l/b"]},
        "filter_expression": {"keyword": {"keyword": "fox"}},
    },
    "ParagraphItem": {"id": "r1/t/b/0-10", "labels": ["/l/a/b"]},
    "DocumentItem": {"uuid": "r1", "field": "t/b", "labels": ["/e/PERSON/x"]},
    "IndexMessage": {
        "node": "n1",
        "shard": "s1",
        "txid": 42,
        "resource": "r1",
        "typemessage": 1,
        "storage_key": "idx/r1",
        "kbid": "kb1",
        "source": 1,
    },
    "Resource": {
        "resource": {"shard_id": "s1", "uuid": "r1"},
        "metadata": {
            "created": {"seconds": 1000},
            "modified": {"seconds": 2000, "nanos": 5},
        },
        "texts": {
            "t/body": {"text": "the quick brown fox", "labels": ["/l/t/a"]},
            "f/doc": {"text": "annual report"},
        },
        "labels": ["/n/s/PROCESSED", "/l/topic/animals"],
        "status": 2,
        "paragraphs": {
            "t/body": {
                "paragraphs": {
                    "r1/t/body/0-19": {
                        "start": 0,
                        "end": 19,
                        "labels": ["/k/p"],
                        "field": "t/body",
                        "index": 1,
                        "repeated_in_field": True,
                        "metadata": {
                            "position": {
                                "index": 1,
                                "start": 0,
                                "end": 19,
                                "page_number": 2,
                                "in_page": True,
                                "start_seconds": [1, 2],
                                "end_seconds": [3],
                            },
                            "page_with_visual": True,
                            "representation": {"is_a_table": True, "file": "f.png"},
                        },
                        "sentences": {
                            "r1/t/body/0/0-19": {
                                "vector": [0.1, 0.2, 0.3],
                                "metadata": {
                                    "position": {"start": 0, "end": 19},
                                },
                            }
                        },
                        "vectorsets_sentences": {
                            "semantic": {
                                "sentences": {
                                    "r1/t/body/0/0-19": {"vector": [1.0, -1.0]}
                                }
                            }
                        },
                    }
                }
            }
        },
        "paragraphs_to_delete": ["r1/t/old"],
        "vectors_to_delete_in_all_vectorsets": ["r1/t/old/"],
        "field_relations": {
            "a/metadata": {
                "relations": [
                    {
                        "relation": {
                            "relation": 2,
                            "source": {"value": "r1", "ntype": 2},
                            "to": {"value": "Paris", "ntype": 0, "subtype": "CITY"},
                            "relation_label": "located in",
                            "metadata": {"paragraph_id": "p", "source_start": 1},
                        },
                        "resource_field_id": "r1/a/metadata",
                        "facets": ["/g/u"],
                    }
                ]
            }
        },
        "shard_id": "s1",
        "security": {"access_groups": ["g1", "g2"]},
        "vector_prefixes_to_delete": {"semantic": {"items": ["r1/t/x"]}},
        "relation_fields_to_delete": ["a/metadata"],
        "texts_to_delete": ["r1/t/gone"],
        "skip_texts": True,
        "json_fields": {"t/meta": {"value": '{"price": 10}'}},
        "json_fields_to_delete": ["t/oldmeta"],
        "skip_json": True,
    },
}


def _norm(value):
    """Float tolerance + int coercion for cross-runtime comparison."""
    if isinstance(value, dict):
        return {k: _norm(v) for k, v in value.items() if v not in ([], {})}
    if isinstance(value, (list, tuple)):
        return [_norm(v) for v in value]
    if isinstance(value, bool):
        return value
    if isinstance(value, float):
        return round(value, 3)
    if isinstance(value, int):
        return int(value)
    return value


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_differential_roundtrip(name):
    schema = ROOTS[name]
    payload = PAYLOADS[name]

    # ours -> google
    data = pw.encode(schema, payload)
    g = MSGS[name].FromString(data)
    assert _norm(to_dict(g)) == _norm(payload)

    # google -> ours (strict: all fields must be known)
    g2 = MSGS[name]()
    fill(g2, payload)
    decoded = pw.decode(schema, g2.SerializeToString(), strict=True)
    assert _norm(decoded) == _norm(payload)


def test_strict_decode_rejects_unknown_fields():
    """A request carrying a field this node does not know must fail loud
    (INVALID_ARGUMENT at the RPC layer), not silently drop a constraint."""
    schema_plus = dict(pw.SEARCH_REQUEST)
    schema_plus["mystery_filter"] = (99, "string")
    data = pw.encode(schema_plus, {"body": "q", "mystery_filter": "drop-me"})
    with pytest.raises(pw.UnknownFieldError):
        pw.decode(pw.SEARCH_REQUEST, data, strict=True)
    # non-strict keeps the old skip behavior for responses
    assert pw.decode(pw.SEARCH_REQUEST, data)["body"] == "q"


def test_strict_decode_rejects_unknown_nested_fields():
    inner_plus = {"facet": (1, "string"), "extra": (7, "int32")}
    schema_plus = {"facet": (8, ("msg", inner_plus))}
    data = pw.encode(schema_plus, {"facet": {"facet": "/l/a", "extra": 3}})
    with pytest.raises(pw.UnknownFieldError):
        pw.decode(pw.FILTER_EXPRESSION, data, strict=True)


def test_recursive_filter_expression_depth():
    expr = {"facet": {"facet": "/leaf"}}
    for _ in range(12):
        expr = {"bool_not": expr}
    data = pw.encode(pw.FILTER_EXPRESSION, expr)
    assert pw.decode(pw.FILTER_EXPRESSION, data, strict=True) == expr
    g = MSGS["FilterExpression"].FromString(data)
    assert _norm(to_dict(g)) == _norm(expr)
