"""msgpack codecs for the gRPC plane.

Message shapes mirror the reference's protos:
- ResourceDoc        <-> noderesources.Resource (the index message)
- ShardSearchRequest <-> nodereader.SearchRequest
- ShardSearchResponse<-> nodereader.SearchResponse

Vectors travel as raw little-endian f32 bytes + shape (msgpack bin), not
per-float arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import msgpack
import numpy as np

from ..index.json import JsonAnd, JsonExpression, JsonNot, JsonOr, JsonPredicate
from ..index.paragraph import SearchAfter as _SearchAfter
from ..index.relation import GraphSearchRequest, NodePattern, RelationPattern
from ..models.internal import (
    IndexParagraph,
    IndexRelation,
    Position,
    RelationNode,
    ResourceDoc,
    ResourceStatus,
    Security,
    TextInformation,
    VectorSentence,
)
from ..query_language import (
    And,
    BooleanExpression,
    FacetPrefixAtom,
    KeyPrefixAtom,
    LabelAtom,
    Not,
    Or,
)
from ..shard import ShardSearchRequest, ShardSearchResponse
from ..types import FieldId, PrefilterKind, PrefilterResult


def pack_array(a: Optional[np.ndarray]):
    if a is None:
        return None
    a = np.ascontiguousarray(a, dtype=np.float32)
    return {"shape": list(a.shape), "data": a.tobytes()}


def unpack_array(d) -> Optional[np.ndarray]:
    if d is None:
        return None
    return np.frombuffer(d["data"], np.float32).reshape(d["shape"]).copy()


# ---- boolean filter expressions -------------------------------------------


def pack_expr(e: Optional[BooleanExpression]):
    if e is None:
        return None
    if isinstance(e, LabelAtom):
        return {"label": e.label}
    if isinstance(e, FacetPrefixAtom):
        return {"facet": e.facet}
    if isinstance(e, KeyPrefixAtom):
        return {"prefixes": list(e.prefixes)}
    if isinstance(e, And):
        return {"and": [pack_expr(o) for o in e.operands]}
    if isinstance(e, Or):
        return {"or": [pack_expr(o) for o in e.operands]}
    if isinstance(e, Not):
        return {"not": pack_expr(e.operand)}
    raise TypeError(f"cannot pack {e!r}")


def unpack_expr(d) -> Optional[BooleanExpression]:
    if d is None:
        return None
    if "label" in d:
        return LabelAtom(d["label"])
    if "facet" in d:
        return FacetPrefixAtom(d["facet"])
    if "prefixes" in d:
        return KeyPrefixAtom(tuple(d["prefixes"]))
    if "and" in d:
        return And(tuple(unpack_expr(o) for o in d["and"]))
    if "or" in d:
        return Or(tuple(unpack_expr(o) for o in d["or"]))
    if "not" in d:
        return Not(unpack_expr(d["not"]))
    raise ValueError(f"cannot unpack expression {d!r}")


def pack_json_expr(e: Optional[JsonExpression]):
    if e is None:
        return None
    if isinstance(e, JsonPredicate):
        out = {"path": e.path, "op": e.op, "value": e.value}
        if e.field_id is not None:
            out["field_id"] = e.field_id
        return out
    if isinstance(e, JsonAnd):
        return {"and": [pack_json_expr(o) for o in e.operands]}
    if isinstance(e, JsonOr):
        return {"or": [pack_json_expr(o) for o in e.operands]}
    if isinstance(e, JsonNot):
        return {"not": pack_json_expr(e.operand)}
    raise TypeError(f"cannot pack {e!r}")


def unpack_json_expr(d) -> Optional[JsonExpression]:
    if d is None:
        return None
    if "path" in d:
        return JsonPredicate(
            path=d["path"], op=d["op"], value=d.get("value"),
            field_id=d.get("field_id"),
        )
    if "and" in d:
        return JsonAnd([unpack_json_expr(o) for o in d["and"]])
    if "or" in d:
        return JsonOr([unpack_json_expr(o) for o in d["or"]])
    if "not" in d:
        return JsonNot(unpack_json_expr(d["not"]))
    raise ValueError(f"cannot unpack json expression {d!r}")


# ---- ResourceDoc ------------------------------------------------------------


def pack_resource(doc: ResourceDoc) -> bytes:
    def pack_position(p: Optional[Position]):
        return dataclasses.asdict(p) if p else None

    out = {
        "resource_id": doc.resource_id,
        "labels": doc.labels,
        "status": doc.status.value,
        "created": doc.created,
        "modified": doc.modified,
        "texts": {k: {"text": t.text, "labels": t.labels} for k, t in doc.texts.items()},
        "paragraphs": {
            fid: {
                pid: {
                    "start": p.start,
                    "end": p.end,
                    "labels": p.labels,
                    "fieldname": p.fieldname,
                    "split": p.split,
                    "index": p.index,
                    "repeated_in_field": p.repeated_in_field,
                    "position": pack_position(p.position),
                    "vectorsets": {
                        vs: {
                            key: {
                                "vector": pack_array(s.vector),
                                "position": pack_position(s.position),
                            }
                            for key, s in sentences.items()
                        }
                        for vs, sentences in p.vectorsets_sentences.items()
                    },
                }
                for pid, p in paragraphs.items()
            }
            for fid, paragraphs in doc.paragraphs.items()
        },
        "relations": {
            fid: [
                {
                    "source": dataclasses.asdict(r.source),
                    "target": dataclasses.asdict(r.target),
                    "relation": r.relation,
                    "label": r.label,
                    "metadata": r.metadata,
                    "facets": r.facets,
                }
                for r in rels
            ]
            for fid, rels in doc.relations.items()
        },
        "node_vectors": {
            fid: {vs: {v: pack_array(np.asarray(vec, np.float32)) for v, vec in vecs.items()}
                  for vs, vecs in per_vs.items()}
            for fid, per_vs in doc.field_node_vectors.items()
        },
        "edge_vectors": {
            fid: {vs: {v: pack_array(np.asarray(vec, np.float32)) for v, vec in vecs.items()}
                  for vs, vecs in per_vs.items()}
            for fid, per_vs in doc.field_edge_vectors.items()
        },
        "json_fields": doc.json_fields,
        "security": dataclasses.asdict(doc.security) if doc.security else None,
        "deletions": {
            "paragraphs": doc.paragraphs_to_delete,
            "vectors_all": doc.vectors_to_delete_in_all_vectorsets,
            "vector_prefixes": doc.vector_prefixes_to_delete,
            "texts": doc.texts_to_delete,
            "relations": doc.relation_fields_to_delete,
            "json": doc.json_fields_to_delete,
        },
        "skips": [doc.skip_texts, doc.skip_paragraphs, doc.skip_json],
    }
    return msgpack.packb(out)


def unpack_resource(data: bytes) -> ResourceDoc:
    d = msgpack.unpackb(data)

    def unpack_position(p):
        return Position(**p) if p else None

    doc = ResourceDoc(
        resource_id=d["resource_id"],
        labels=d["labels"],
        status=ResourceStatus(d["status"]),
        created=d["created"],
        modified=d["modified"],
    )
    for fid, t in d["texts"].items():
        doc.texts[fid] = TextInformation(text=t["text"], labels=t["labels"])
    for fid, paragraphs in d["paragraphs"].items():
        out = {}
        for pid, p in paragraphs.items():
            para = IndexParagraph(
                start=p["start"],
                end=p["end"],
                labels=p["labels"],
                fieldname=p["fieldname"],
                split=p["split"],
                index=p["index"],
                repeated_in_field=p["repeated_in_field"],
                position=unpack_position(p["position"]),
            )
            for vs, sentences in p["vectorsets"].items():
                para.vectorsets_sentences[vs] = {
                    key: VectorSentence(
                        vector=unpack_array(s["vector"]),
                        position=unpack_position(s["position"]),
                    )
                    for key, s in sentences.items()
                }
            out[pid] = para
        doc.paragraphs[fid] = out
    for fid, rels in d["relations"].items():
        doc.relations[fid] = [
            IndexRelation(
                source=RelationNode(**r["source"]),
                target=RelationNode(**r["target"]),
                relation=r["relation"],
                label=r["label"],
                metadata=r["metadata"],
                facets=r["facets"],
            )
            for r in rels
        ]
    for attr, key in (
        ("field_node_vectors", "node_vectors"),
        ("field_edge_vectors", "edge_vectors"),
    ):
        for fid, per_vs in (d.get(key) or {}).items():
            getattr(doc, attr)[fid] = {
                vs: {v: unpack_array(vec) for v, vec in vecs.items()}
                for vs, vecs in per_vs.items()
            }
    doc.json_fields = d["json_fields"]
    if d["security"] is not None:
        doc.security = Security(**d["security"])
    dele = d["deletions"]
    doc.paragraphs_to_delete = dele["paragraphs"]
    doc.vectors_to_delete_in_all_vectorsets = dele["vectors_all"]
    doc.vector_prefixes_to_delete = dele["vector_prefixes"]
    doc.texts_to_delete = dele["texts"]
    doc.relation_fields_to_delete = dele["relations"]
    doc.json_fields_to_delete = dele["json"]
    doc.skip_texts, doc.skip_paragraphs, doc.skip_json = d["skips"]
    return doc


# ---- search request/response ------------------------------------------------


def pack_search_request(r: ShardSearchRequest) -> bytes:
    g = r.graph
    return msgpack.packb(
        {
            "body": r.body,
            "top_k": r.top_k,
            "paragraph": r.paragraph,
            "document": r.document,
            "vector": pack_array(r.vector),
            "vectorset": r.vectorset,
            "min_score_semantic": r.min_score_semantic,
            "min_score_bm25": r.min_score_bm25,
            "all_terms": r.all_terms,
            "filter": pack_expr(r.filter),
            "field_filter": pack_expr(r.field_filter),
            "json_filter": pack_json_expr(r.json_filter),
            "filter_operator": r.filter_operator,
            "advanced_query": r.advanced_query,
            "search_after": (
                None if r.search_after is None
                else {"score": r.search_after.score, "tie": r.search_after.tie}
            ),
            "graph_expr": r.graph_expr,
            "graph_node_vectorset": r.graph_node_vectorset,
            "graph_edge_vectorset": r.graph_edge_vectorset,
            "min_score_node_semantic": r.min_score_node_semantic,
            "min_score_edge_semantic": r.min_score_edge_semantic,
            "security_groups": r.security_groups,
            "key_filters": r.key_filters,
            "include_hidden": r.include_hidden,
            "with_duplicates": r.with_duplicates,
            "range_creation": list(r.range_creation) if r.range_creation else None,
            "range_modification": (
                list(r.range_modification) if r.range_modification else None
            ),
            "graph": None
            if g is None
            else {
                "source": dataclasses.asdict(g.source),
                "relation": dataclasses.asdict(g.relation),
                "target": dataclasses.asdict(g.target),
                "undirected": g.undirected,
                "top_k": g.top_k,
            },
            "faceted": r.faceted,
            "only_faceted": r.only_faceted,
            "order_by": r.order_by,
            "order_desc": r.order_desc,
        }
    )


def unpack_search_request(data: bytes) -> ShardSearchRequest:
    d = msgpack.unpackb(data)
    g = d.get("graph")
    return ShardSearchRequest(
        body=d["body"],
        top_k=d["top_k"],
        paragraph=d["paragraph"],
        document=d["document"],
        vector=unpack_array(d["vector"]),
        vectorset=d["vectorset"],
        min_score_semantic=d["min_score_semantic"],
        min_score_bm25=d["min_score_bm25"],
        all_terms=d["all_terms"],
        filter=unpack_expr(d["filter"]),
        field_filter=unpack_expr(d["field_filter"]),
        json_filter=unpack_json_expr(d["json_filter"]),
        filter_operator=d.get("filter_operator", "and"),
        advanced_query=d.get("advanced_query"),
        search_after=(
            None if d.get("search_after") is None
            else _SearchAfter(
                score=d["search_after"]["score"], tie=d["search_after"]["tie"]
            )
        ),
        graph_expr=d.get("graph_expr"),
        graph_node_vectorset=d.get("graph_node_vectorset"),
        graph_edge_vectorset=d.get("graph_edge_vectorset"),
        min_score_node_semantic=d.get("min_score_node_semantic", 0.0) or 0.0,
        min_score_edge_semantic=d.get("min_score_edge_semantic", 0.0) or 0.0,
        security_groups=d["security_groups"],
        key_filters=d["key_filters"],
        include_hidden=d.get("include_hidden", False),
        with_duplicates=d.get("with_duplicates", False),
        range_creation=(
            tuple(d["range_creation"]) if d.get("range_creation") else None
        ),
        range_modification=(
            tuple(d["range_modification"]) if d.get("range_modification") else None
        ),
        graph=None
        if g is None
        else GraphSearchRequest(
            source=NodePattern(**g["source"]),
            relation=RelationPattern(**g["relation"]),
            target=NodePattern(**g["target"]),
            undirected=g["undirected"],
            top_k=g["top_k"],
        ),
        faceted=d["faceted"],
        only_faceted=d["only_faceted"],
        order_by=d["order_by"],
        order_desc=d["order_desc"],
    )


def pack_search_response(r: ShardSearchResponse) -> bytes:
    doc = None
    if r.document is not None:
        doc = {
            "hits": [dataclasses.asdict(h) for h in r.document.hits],
            "total": r.document.total,
            "facet_counts": r.document.facet_counts,
        }
    para = None
    if r.paragraph is not None:
        para = {
            "hits": [dataclasses.asdict(h) for h in r.paragraph.hits],
            "total": r.paragraph.total,
            "ematches": r.paragraph.ematches,
            "query_terms": r.paragraph.query_terms,
        }
    pf = {"kind": r.prefilter.kind.value, "fields": [dataclasses.asdict(f) for f in r.prefilter.fields]}
    return msgpack.packb(
        {
            "document": doc,
            "paragraph": para,
            "vector": [dataclasses.asdict(h) for h in r.vector],
            "graph": [dataclasses.asdict(p) for p in r.graph],
            "prefilter": pf,
        }
    )


def unpack_search_response(data: bytes) -> ShardSearchResponse:
    from ..index.paragraph import ParagraphHit, ParagraphSearchResponse
    from ..index.relation import GraphNode, GraphPath
    from ..index.text import DocumentHit, DocumentSearchResponse
    from ..index.vector import VectorHit

    d = msgpack.unpackb(data)
    out = ShardSearchResponse()
    if d["document"] is not None:
        out.document = DocumentSearchResponse(
            hits=[DocumentHit(**h) for h in d["document"]["hits"]],
            total=d["document"]["total"],
            facet_counts=d["document"]["facet_counts"],
        )
    if d["paragraph"] is not None:
        out.paragraph = ParagraphSearchResponse(
            hits=[ParagraphHit(**h) for h in d["paragraph"]["hits"]],
            total=d["paragraph"]["total"],
            ematches=d["paragraph"]["ematches"],
            query_terms=d["paragraph"]["query_terms"],
        )
    out.vector = [VectorHit(**h) for h in d["vector"]]
    out.graph = [
        GraphPath(
            source=GraphNode(**p["source"]),
            relation=p["relation"],
            label=p["label"],
            target=GraphNode(**p["target"]),
            metadata=p["metadata"],
            resource_field=p["resource_field"],
        )
        for p in d["graph"]
    ]
    pf = d["prefilter"]
    out.prefilter = PrefilterResult(
        kind=PrefilterKind(pf["kind"]),
        fields=tuple(FieldId(**f) for f in pf["fields"]),
    )
    return out
