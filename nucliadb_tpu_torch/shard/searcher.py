"""Shard search: query planning + prefilter pipeline + per-index execution.

Counterpart of ``nucliadb_tpu/shard/searcher.py`` with an explicit torch
``device``, passed down to the text, paragraph and vector searchers. The
planner and executor are the JAX package's, line for line, apart from
``_legs_host_resident`` (see there).

Parity with the reference's query planner and shard executor
(nidx/src/searcher/query_planner.rs:37-495, shard_search.rs:37-290):

1. one unified request is planned into per-index requests (IndexQueries),
2. prefilters run first — the text index turns security + field filters into
   a FieldId set, the json index turns a typed JSON filter into another —
   and their intersection is applied to the vector/paragraph requests
   (an empty result clears every downstream query),
3. the index searches execute and assemble one ShardSearchResponse.

A hybrid request runs its paragraph leg on ``_INDEX_POOL`` while the vector
leg runs on the calling thread, as in the JAX package. On the card each
thread launches on a stream of its own (``utils/platform.thread_stream``)
and each leg's ``device_fetch`` waits only for its own thread's stream, so
the two legs, and the legs of concurrent requests, overlap on the device.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field as dc_field
from typing import Optional

import numpy as np
import torch

from ..index.json import JsonExpression, JsonSearcher
from ..index.paragraph import (
    ParagraphSearcher,
    ParagraphSearchRequest,
    ParagraphSearchResponse,
    SearchAfter as ParagraphSearchAfter,
)
from ..index.relation import GraphPath, GraphSearchRequest, RelationSearcher
from ..index.text import (
    DocumentSearchRequest,
    DocumentSearchResponse,
    TextSearcher,
)
from ..index.vector import (
    VectorHit,
    VectorSearcher,
    VectorSearchRequest,
)
from ..query_language import BooleanExpression
from ..types import OpenIndexMetadata, PrefilterResult
from .config import ShardConfig

# per-index fan-out threads. Sized to the HTTP worker pool, not to CPU
# count: a request's paragraph leg runs here while its vector leg runs on
# the request thread, and a small pool serializes the BM25 legs BEFORE the
# text coalescer can merge them into shared dispatches.
_INDEX_POOL = ThreadPoolExecutor(max_workers=32, thread_name_prefix="idxsearch")


@dataclass
class ShardSearchRequest:
    """One search against a shard (parity: nodereader SearchRequest)."""

    body: str = ""
    top_k: int = 20

    # which indexes to query
    paragraph: bool = True
    document: bool = False

    # semantic
    vector: Optional[np.ndarray] = None
    vectorset: str = ""
    min_score_semantic: Optional[float] = None

    # keyword
    min_score_bm25: Optional[float] = None
    all_terms: bool = False

    # filters
    filter: Optional[BooleanExpression] = None  # paragraph/label level
    field_filter: Optional[BooleanExpression] = None  # field level -> prefilter
    json_filter: Optional[JsonExpression] = None
    # how the text and json prefilters combine (nodereader
    # SearchRequest.filter_operator: AND=0, OR=1)
    filter_operator: str = "and"
    # how the legs combine the prefilter with the paragraph-level filter:
    # "or" = match EITHER side (only set when the caller supplied BOTH a
    # field and a paragraph filter with operator=or; system constraints
    # like hidden-exclusion are pre-distributed into both sides)
    leg_filter_operator: str = "and"
    # extra Must() query in tantivy grammar applied to the paragraph and
    # document legs (nodereader SearchRequest.advanced_query)
    advanced_query: Optional[str] = None
    # deep-pagination cursor for the paragraph leg (nodereader
    # SearchRequest.search_after)
    search_after: "Optional[ParagraphSearchAfter]" = None
    # date windows over resource created/modified (parity: find/catalog
    # range_creation_* / range_modification_* params) -> text prefilter
    range_creation: Optional[tuple[Optional[float], Optional[float]]] = None
    range_modification: Optional[tuple[Optional[float], Optional[float]]] = None
    security_groups: Optional[list[str]] = None
    key_filters: list[str] = dc_field(default_factory=list)  # resource/field keys
    # surface hidden-tagged vector segments (parity: show_hidden; hidden
    # exclusion on text legs rides the /q/h label filter)
    include_hidden: bool = False

    # False skips the paragraph leg's corpus-wide matched total — /find
    # derives its response total from the fused list and never reads it
    need_paragraph_total: bool = True

    # vector dedup (nodereader SearchRequest.with_duplicates; proto default
    # false = identical-vector results collapse)
    with_duplicates: bool = False

    # graph
    graph: Optional[GraphSearchRequest] = None
    # boolean path-query tree (the relation engine's query dict) — the
    # reduced graph leg of a search (nodereader SearchRequest.graph_search,
    # proto plane); filters are inherited from the main request's prefilter
    graph_expr: Optional[dict] = None
    # vectorsets resolving VectorMatch leaves in graph_expr against the
    # relation index's node/edge vector tables (nodereader
    # SearchRequest.graph_node_vectorset=30/graph_edge_vectorset=31,
    # min scores 33/34)
    graph_node_vectorset: Optional[str] = None
    graph_edge_vectorset: Optional[str] = None
    min_score_node_semantic: float = 0.0
    min_score_edge_semantic: float = 0.0

    # facets
    faceted: list[str] = dc_field(default_factory=list)
    only_faceted: bool = False
    order_by: Optional[str] = None
    order_desc: bool = True


@dataclass
class ShardSearchResponse:
    document: Optional[DocumentSearchResponse] = None
    paragraph: Optional[ParagraphSearchResponse] = None
    vector: list[VectorHit] = dc_field(default_factory=list)
    graph: list[GraphPath] = dc_field(default_factory=list)
    prefilter: PrefilterResult = dc_field(default_factory=PrefilterResult.all)


class ShardSearcher:
    """Open searchers over all indexes of one shard, on ``device``."""

    def __init__(
        self,
        config: ShardConfig,
        open_indexes: dict[str, OpenIndexMetadata],
        prev: "ShardSearcher | None" = None,
        *,
        device: "str | torch.device" = "cuda",
    ):
        """``open_indexes`` maps index name ('text', 'paragraph', 'relation',
        'json', 'vector/{vs}') to its OpenIndexMetadata. ``prev`` is the
        searcher being replaced on a refresh — its vector arenas extend in
        place and its text groups are reused when the new segment list
        extends the old one."""
        self.config = config
        self.text = (
            TextSearcher(
                open_indexes["text"],
                prev=prev.text if prev is not None else None,
                device=device,
            )
            if "text" in open_indexes
            else None
        )
        self.paragraph = (
            ParagraphSearcher(
                open_indexes["paragraph"],
                prev=prev.paragraph if prev is not None else None,
                device=device,
            )
            if "paragraph" in open_indexes
            else None
        )
        self.relation = (
            RelationSearcher(open_indexes["relation"])
            if "relation" in open_indexes
            else None
        )
        self.json = JsonSearcher(open_indexes["json"]) if "json" in open_indexes else None
        self.vectors: dict[str, VectorSearcher] = {}
        for name, oi in open_indexes.items():
            if name.startswith("vector/"):
                vs = name.split("/", 1)[1]
                vs_config = config.vectorsets[vs]
                self.vectors[vs] = VectorSearcher(
                    vs_config, oi,
                    prev=prev.vectors.get(vs) if prev is not None else None,
                    device=device,
                )

    # ------------------------------------------------------------------

    def _needs_prefilter(self, request: ShardSearchRequest) -> bool:
        """Parity: query_planner.rs prefilter-necessity decision — field-level
        filters or security must reach the vector/paragraph indexes."""
        return (
            request.field_filter is not None
            or request.security_groups is not None
            or request.json_filter is not None
            or request.range_creation is not None
            or request.range_modification is not None
        )

    def compute_prefilter(self, request: ShardSearchRequest) -> PrefilterResult:
        """Text ∧ JSON prefilters (parity: shard_search.rs:175-208)."""
        result = PrefilterResult.all()
        if (
            request.field_filter is not None
            or request.security_groups is not None
            or request.range_creation is not None
            or request.range_modification is not None
        ) and self.text is not None:
            result = result.intersect(
                self.text.prefilter(
                    filter=request.field_filter,
                    security_groups=request.security_groups,
                    range_creation=request.range_creation,
                    range_modification=request.range_modification,
                )
            )
        if request.json_filter is not None and self.json is not None:
            json_result = self.json.prefilter(request.json_filter)
            if request.filter_operator == "or":
                # parity: nidx_types prefilter.rs PrefilterResult::combine
                # with FilterOperator::Or (shard_search.rs:202)
                result = result.union(json_result)
            else:
                result = result.intersect(json_result)
        return result

    def extracted_texts(
        self,
        field_ids: "list[dict] | None" = None,
        paragraph_ids: "list[dict] | None" = None,
    ) -> dict[str, dict[str, str]]:
        """Extracted text straight from the index's stored field text
        (parity: NidxSearcher.ExtractedTexts, nidx.proto:25 +
        searcher/grpc.rs:171-185).

        ``field_ids``/``paragraph_ids`` entries: {rid, field_type,
        field_name, split?} (+ paragraph_start/paragraph_end). Returns
        {"fields": {...}, "splits": {...}, "paragraphs": {...}} keyed the
        reference way (`rid/ftype/fname[/split][/start-end]`).
        """
        out: dict[str, dict[str, str]] = {"fields": {}, "splits": {}, "paragraphs": {}}
        if self.text is None:
            return out
        entries = list(field_ids or []) + list(paragraph_ids or [])
        keys = {
            f"{e['rid']}/{e['field_type']}/{e['field_name']}" for e in entries
        }
        texts = self.text.get_fields_text(sorted(keys))
        for e in field_ids or []:
            fkey = f"{e['rid']}/{e['field_type']}/{e['field_name']}"
            text = texts.get(fkey)
            if text is None:
                continue
            split = e.get("split")
            if not split:
                out["fields"][fkey] = text
                continue
            span = self._split_span(e["rid"], f"{e['field_type']}/{e['field_name']}", split)
            if span is not None:
                out["splits"][f"{fkey}/{split}"] = text[span[0] : span[1]]
        for e in paragraph_ids or []:
            fkey = f"{e['rid']}/{e['field_type']}/{e['field_name']}"
            text = texts.get(fkey)
            if text is None:
                continue
            start, end = int(e["paragraph_start"]), int(e["paragraph_end"])
            pkey = fkey + (f"/{e['split']}" if e.get("split") else "") + f"/{start}-{end}"
            out["paragraphs"][pkey] = text[start:end]
        return out

    def _split_span(self, rid: str, fid: str, split: str) -> "tuple[int, int] | None":
        """[start, end) covering every paragraph of one split (a conversation
        message) — offsets into the field's joined transcript."""
        if self.paragraph is None:
            return None
        eng = self.paragraph.engine
        lo = hi = None
        for did in eng.key_prefix_postings([f"{rid}/{fid}/"]):
            if not eng.alive[did]:
                continue
            attrs = eng.attrs[did]
            if attrs.get("split") != split:
                continue
            s, e = int(attrs.get("start", 0)), int(attrs.get("end", 0))
            lo = s if lo is None else min(lo, s)
            hi = e if hi is None else max(hi, e)
        return None if lo is None else (lo, hi)

    def _legs_host_resident(self, request: ShardSearchRequest) -> bool:
        """True when neither hybrid leg will dispatch a device program —
        the text engine serves from its host WAND tier and the vector index
        from its host numpy exact tier — so the per-request thread handoff
        that exists to overlap device round trips is pure overhead. The
        index's ``host_resident`` asks the JAX package's questions: a host
        arena, and no codes, IVF layout, graph or paged tier (a MULTI
        index has no host arena)."""
        if self.paragraph is None or self.paragraph.engine.host_tier() is None:
            return False
        vs_name = request.vectorset or next(iter(self.vectors), "")
        searcher = self.vectors.get(vs_name)
        if searcher is None:
            return True  # no vector leg to dispatch at all
        return searcher.index.host_resident()

    def search(
        self,
        request: ShardSearchRequest,
        *,
        prefilter: "PrefilterResult | None" = None,
        vector_hits: "list[VectorHit] | None" = None,
        paragraph_response: "ParagraphSearchResponse | None" = None,
    ) -> ShardSearchResponse:
        """Run every leg the request asks for against this shard.

        ``prefilter``/``vector_hits``/``paragraph_response`` are the mesh
        serving path's precomputed pieces (``services/searcher.py``
        ``search_multi``): the group programs already ran the vector and
        keyword legs of every co-resident shard, so this call runs only the
        remaining legs, against the SAME prefilter their masks used."""
        response = ShardSearchResponse()

        if prefilter is None:
            prefilter = (
                self.compute_prefilter(request)
                if self._needs_prefilter(request)
                else PrefilterResult.all()
            )
        response.prefilter = prefilter
        if prefilter.is_none:
            # empty prefilter clears every downstream query
            # (parity: IndexQueries::apply_prefilter, query_planner.rs:157-170)
            return response

        key_prefixes = list(request.key_filters) or None

        def run_document():
            return self.text.search(
                DocumentSearchRequest(
                    query=request.body,
                    top_k=request.top_k,
                    filter=request.filter,
                    security_groups=request.security_groups,
                    faceted=request.faceted,
                    only_faceted=request.only_faceted,
                    order_by=request.order_by,
                    order_desc=request.order_desc,
                    min_score=request.min_score_bm25,
                    all_terms=request.all_terms,
                    range_creation=request.range_creation,
                    range_modification=request.range_modification,
                    key_prefixes=key_prefixes,
                    advanced_query=request.advanced_query,
                    # field/json prefilter applies to the document leg too
                    field_filter=prefilter,
                )
            )

        # the document leg overlaps the paragraph/vector legs below
        doc_fut = (
            _INDEX_POOL.submit(run_document)
            if request.document and self.text is not None
            else None
        )

        def run_paragraph():
            # key filters restrict BEFORE scoring via the engine's
            # boundary-aware prefix masks
            return self.paragraph.search(
                ParagraphSearchRequest(
                    query=request.body,
                    top_k=request.top_k,
                    filter=request.filter,
                    field_filter=prefilter,
                    key_prefixes=key_prefixes,
                    min_score=request.min_score_bm25,
                    all_terms=request.all_terms,
                    advanced_query=request.advanced_query,
                    search_after=request.search_after,
                    filter_operator=request.leg_filter_operator,
                    need_total=request.need_paragraph_total,
                )
            )

        def run_vector():
            vs_name = request.vectorset or next(iter(self.vectors), "")
            searcher = self.vectors.get(vs_name)
            if searcher is None:
                return response.vector  # keep the default (empty) result
            vreq = VectorSearchRequest(
                vectors=np.asarray(request.vector, np.float32),
                top_k=request.top_k,
                filter=request.filter,
                field_filter=prefilter,
                key_prefixes=key_prefixes,
                min_score=request.min_score_semantic,
                include_hidden=request.include_hidden,
                with_duplicates=request.with_duplicates,
                filter_operator=request.leg_filter_operator,
            )
            from ..index.vector.batcher import coalescer

            if coalescer.eligible(vreq):
                # concurrent unfiltered queries share one device dispatch
                return coalescer.search_one(searcher, vreq)
            hits = searcher.search(vreq)
            return hits[0] if hits else []

        want_paragraph = (
            request.paragraph and request.body.strip() and self.paragraph is not None
        )
        want_vector = request.vector is not None
        if vector_hits is not None and want_vector:
            # the vector leg already ran (the group program): no device
            # program left to overlap, so the paragraph leg runs inline
            # (or, when the mesh text group ran it too, not at all)
            response.vector = vector_hits
            if want_paragraph:
                response.paragraph = (
                    paragraph_response
                    if paragraph_response is not None
                    else run_paragraph()
                )
        elif want_paragraph and want_vector:
            if self._legs_host_resident(request):
                # both legs serve from host tiers: no device program to
                # overlap, and the thread handoff is pure overhead — inline
                response.paragraph = run_paragraph()
                response.vector = run_vector()
            else:
                # hybrid: the paragraph leg on the pool, the vector leg here
                # (parity: the reference's scoped-thread per-index fan-out,
                # shard_search.rs:185-273)
                para_fut = _INDEX_POOL.submit(run_paragraph)
                response.vector = run_vector()
                response.paragraph = para_fut.result()
        elif want_paragraph:
            response.paragraph = run_paragraph()
        elif want_vector:
            response.vector = run_vector()

        if request.graph is not None and self.relation is not None:
            response.graph = self.relation.graph_search(request.graph)

        if request.graph_expr is not None and self.relation is not None:
            # SearchRequest.graph_search inherits the main request's filters
            # (nodereader.proto:427-433): the prefilter's FieldId set
            # restricts edges by their originating resource field key
            from ..index.relation import prefilter_edge_ok

            graph_expr = self.relation.resolve_vector_leaves(
                request.graph_expr,
                top_k=request.top_k,
                node_vectorset=request.graph_node_vectorset,
                edge_vectorset=request.graph_edge_vectorset,
                node_min_score=request.min_score_node_semantic,
                edge_min_score=request.min_score_edge_semantic,
            )
            response.graph = self.relation.graph_search_expr(
                graph_expr, request.top_k,
                edge_ok=prefilter_edge_ok(prefilter),
            )

        if doc_fut is not None:
            response.document = doc_fut.result()

        return response
