"""The /find pipeline and sibling search endpoints.

The port's copy of ``nucliadb_tpu/search/find.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity with the reference's hybrid retrieval flow
(nucliadb/src/nucliadb/search/search/find.py:65 + retrieval.py:46 +
find_merge.py:58-343): parse -> shard fan-out -> rank fusion (RRF k=60) ->
cut -> hydrate text -> response tree (resources -> fields -> paragraphs),
plus /suggest, /catalog, /graph and a retrieval-grounded /ask.

The reference embeds queries through the external Predict API
(search/predict.py); here a ``PredictEngine`` protocol fills that seam —
standalone deployments pass query vectors explicitly or plug an encoder.
"""

from __future__ import annotations

import json
from typing import Optional, Protocol

import numpy as np

from ..common.kb import KnowledgeBoxManager
from ..index.relation import GraphSearchRequest, NodePattern, RelationPattern
from ..ingest.processor import Processor
from ..models.api import (
    AskRequest,
    AskResponse,
    CatalogRequest,
    CatalogResource,
    CatalogResponse,
    FilterExpression,
    FindParagraph,
    FindRequest,
    FindResource,
    FindField,
    GraphPathResult,
    GraphSearchPayload,
    GraphSearchResponse,
    KnowledgeboxFindResults,
    Relation,
    SearchFeature,
    user_relations,
    SuggestedParagraph,
    SuggestRequest,
    SuggestResponse,
    translate_alias_label,
)
from ..query_language import BooleanExpression, LabelAtom, and_, not_, or_
from ..services import EmbeddedNode
from ..shard import ShardSearchRequest
from .rank_fusion import TextBlock, reciprocal_rank_fusion, weighted_comb_sum


class PredictEngine(Protocol):
    """Seam for the external Predict API (query embedding / generation)."""

    def embed(self, kbid: str, vectorset: str, text: str) -> Optional[np.ndarray]: ...

    def generate(self, kbid: str, prompt: str, context: list[str]) -> str: ...


def filter_to_expression(f: Optional[FilterExpression]) -> Optional[BooleanExpression]:
    """LEGACY label-tree form only — rich expressions go through
    parse_request_filters (the reference's structured filter_expression)."""
    if f is None:
        return None
    if f.is_rich:
        raise ValueError(
            "rich filter_expression is not supported on this endpoint yet"
        )
    if f.literal is not None:
        return LabelAtom(translate_alias_label(f.literal))
    if f.all_ is not None:
        return and_(*[filter_to_expression(x) for x in f.all_])
    if f.any_ is not None:
        return or_(*[filter_to_expression(x) for x in f.any_])
    if f.none is not None:
        return not_(or_(*[filter_to_expression(x) for x in f.none]))
    if f.not_ is not None:
        return not_(filter_to_expression(f.not_))
    raise ValueError("empty filter expression node")


def parse_request_filters(
    f: Optional[FilterExpression], resolve_slug
) -> "tuple[Optional[BooleanExpression], Optional[BooleanExpression], object, str]":
    """Either filter_expression shape ->
    (field_expr, paragraph_expr, json_expr, operator).

    Rich expressions (reference nucliadb_models/filters.py) lower through
    search/filter_expr.py; the legacy label tree stays a paragraph-level
    expression (its pre-rich behavior)."""
    if f is None:
        return None, None, None, "and"
    if f.is_rich:
        from .filter_expr import parse_filter_expression

        return parse_filter_expression(f, resolve_slug)
    return None, filter_to_expression(f), None, "and"



def _parse_ts(v) -> "Optional[float]":
    """Unix seconds or ISO-8601 -> unix seconds."""
    if v is None:
        return None
    if isinstance(v, (int, float)):
        return float(v)
    from datetime import datetime, timezone

    dt = datetime.fromisoformat(str(v).replace("Z", "+00:00"))
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt.timestamp()


def _range(start, end):
    lo, hi = _parse_ts(start), _parse_ts(end)
    return None if lo is None and hi is None else (lo, hi)


def parse_vector_key(key: str) -> Optional[tuple[str, str, int, int]]:
    """'{rid}/{ftype}/{fname}/{idx}/{start}-{end}' -> (rid, field, start, end)."""
    parts = key.split("/")
    if len(parts) < 4:
        return None
    try:
        start, end = parts[-1].split("-")
        return parts[0], "/".join(parts[1:-2]), int(start), int(end)
    except ValueError:
        return None


def _highlight(snippet: str, terms: list[str]) -> str:
    """Wrap matched words in <mark> tags (parity: find highlight option)."""
    import re

    if not terms:
        return snippet
    pattern = re.compile(
        r"\b(" + "|".join(re.escape(t) for t in terms) + r")\b", re.IGNORECASE
    )
    return pattern.sub(lambda m: f"<mark>{m.group(0)}</mark>", snippet)


def parse_paragraph_id(pid: str) -> Optional[tuple[str, str, int, int]]:
    parts = pid.split("/")
    if len(parts) < 3:
        return None
    try:
        start, end = parts[-1].split("-")
        return parts[0], "/".join(parts[1:-1]), int(start), int(end)
    except ValueError:
        return None


class SearchService:
    def __init__(
        self,
        node: EmbeddedNode,
        kbs: KnowledgeBoxManager,
        processor: Processor,
        predict: Optional[PredictEngine] = None,
    ):
        self.node = node
        self.kbs = kbs
        self.processor = processor
        self.predict = predict
        from ..common.kb_services import EntitiesService, SynonymsService

        self.synonyms = SynonymsService(kbs.driver)
        self.entities = EntitiesService(kbs.driver)

    # ------------------------------------------------------------------

    def _autofilter_labels(self, kbid: str, query: str) -> list[str]:
        """Entity labels detected in the query: KB entity-vocabulary token
        match, plus predict-engine detections that name a known KB entity."""
        from ..index.text_engine.tokenizer import tokenize

        q_tokens = tokenize(query)
        detected: list[str] = []
        known: dict[str, tuple[str, str]] = {}  # value.lower() -> (group, value)
        for group in self.entities.list_groups(kbid):
            definition = self.entities.get_group(kbid, group) or {}
            for name, ent in (definition.get("entities") or {}).items():
                value = (ent or {}).get("value") or name
                known[value.lower()] = (group, value)
        for value_lower, (group, value) in known.items():
            etoks = tokenize(value_lower)
            if not etoks:
                continue
            for i in range(len(q_tokens) - len(etoks) + 1):
                if q_tokens[i : i + len(etoks)] == etoks:
                    detected.append(f"/e/{group}/{value}")
                    break
        if self.predict is not None and hasattr(self.predict, "detect_entities"):
            for ent in self.predict.detect_entities(kbid, query):
                hit = known.get(str(ent.get("text", "")).lower())
                if hit and f"/e/{hit[0]}/{hit[1]}" not in detected:
                    detected.append(f"/e/{hit[0]}/{hit[1]}")
        return sorted(set(detected))

    def _external_hit_allowed(
        self, kbid: str, rid: str, hit, expr, request: FindRequest, shard_req
    ) -> bool:
        """Host-side constraint check for one external-index hit: label
        expression (provider-returned labels + resource labels), security
        groups, field restriction and date windows — the node leg applies
        the same constraints through its prefilter + mask machinery."""
        from ..query_language import evaluate_one

        labels = set(hit.metadata.get("labels", []))
        payload = None
        if expr is not None or request.security_groups is not None:
            payload = self.processor.get_payload(kbid, rid)
            if payload is None:
                return False
            labels |= {
                f"/l/{c.labelset}/{c.label}"
                for c in payload.usermetadata.classifications
            }
        if expr is not None and not evaluate_one(expr, labels, key=hit.key):
            return False
        if request.security_groups is not None and payload is not None:
            groups = (
                set(payload.security.access_groups) if payload.security else set()
            )
            if groups and not groups & set(request.security_groups):
                return False
        if shard_req.key_filters and not any(
            hit.key.startswith(p) or hit.key.split("/", 1)[-1].startswith(p)
            for p in shard_req.key_filters
        ):
            return False
        for window, column in (
            (shard_req.range_creation, "created"),
            (shard_req.range_modification, "modified"),
        ):
            if window is None:
                continue
            meta = self.processor.get_meta(kbid, rid)
            if meta is None:
                return False
            value = getattr(meta, column)
            lo, hi = window
            if (lo is not None and value < lo) or (hi is not None and value > hi):
                return False
        return True

    def _shard_ids(self, kbid: str) -> list[str]:
        shards = self.kbs.get_shards(kbid)
        if shards is None:
            raise KeyError(f"unknown kb {kbid}")
        return shards.shards

    def _query_vector(self, kbid: str, request: FindRequest) -> Optional[np.ndarray]:
        if request.vector is not None:
            return np.asarray(request.vector, np.float32)
        if self.predict is not None and request.query:
            config = self.kbs.get_config(kbid)
            vectorset = request.vectorset or (
                next(iter(config.vectorsets)) if config and config.vectorsets else ""
            )
            return self.predict.embed(kbid, vectorset, request.query)
        return None

    # ------------------------------------------------------------------

    def find(self, kbid: str, request: FindRequest) -> KnowledgeboxFindResults:
        from ..telemetry.tracing import span
        from .metrics import Metrics

        from ..telemetry.metrics import search_observer

        metrics = Metrics()
        try:
            with span("search.find", kbid=kbid), search_observer(
                {"endpoint": "find"}
            ), self.processor.payload_cache():
                return self._find(kbid, request, metrics)
        finally:
            metrics.log_if_slow("find", f"kbid={kbid} q={request.query[:80]!r}")

    def retrieve(self, kbid: str, request) -> "RetrievalResponse":
        """Raw text-block retrieval: the same pipeline as /find up to the
        fused (and optionally reranked) cut, reported as flat matches with
        a score history instead of a hydrated resource tree (parity:
        search/api/v1/retrieve.py + nucliadb_models/retrieval.py)."""
        from ..models.api import (
            RetrievalMatch,
            RetrievalMatchMetadata,
            RetrievalQuery,
            RetrievalResponse,
            RetrievalScore,
            RetrievalScores,
        )
        from .metrics import Metrics

        q = request.query
        if isinstance(q, str):
            q = RetrievalQuery(keyword=q, semantic=q)
        features = []
        if q.keyword:
            features.append(SearchFeature.KEYWORD)
        if q.semantic or q.vector is not None:
            features.append(SearchFeature.SEMANTIC)
        find_req = FindRequest(
            query=q.keyword or q.semantic or "",
            vector=q.vector,
            vectorset=request.vectorset,
            features=features,
            top_k=request.top_k,
            filter_expression=request.filter_expression,
            security_groups=request.security_groups,
            fields=request.fields,
            rank_fusion=request.rank_fusion,
            reranker=request.reranker or "noop",
        )
        blocks: list[TextBlock] = []
        find_metrics = Metrics()
        with self.processor.payload_cache():
            self._find(kbid, find_req, find_metrics, collect_blocks=blocks)
            return self._retrieval_matches(
                kbid, request, blocks, find_metrics
            )

    def _retrieval_matches(self, kbid, request, blocks, find_metrics):
        from ..models.api import (
            RetrievalMatch,
            RetrievalMatchMetadata,
            RetrievalResponse,
            RetrievalScore,
            RetrievalScores,
        )

        fusion_type = "wCombSUM" if request.rank_fusion == "weighted" else "rrf"
        # trust what _find actually did (the rerank branch also requires a
        # rerank-capable predict engine and a non-empty keyword query) —
        # not just what was requested, or the score history would claim a
        # rerank that never ran
        reranked = "rerank" in find_metrics.phases
        matches = []
        for b in blocks:
            history = [
                RetrievalScore(score=s, source="index", type=src)
                for src, s in sorted(b.source_scores.items())
            ]
            final = RetrievalScore(
                score=b.fused_score,
                source="reranker" if reranked else "rank_fusion",
                type="reranker" if reranked else fusion_type,
            )
            history.append(final)
            text = self.processor.field_text(kbid, b.rid, b.field) or ""
            matches.append(
                RetrievalMatch(
                    id=b.block_id,
                    text=text[b.start : b.end],
                    score=RetrievalScores(
                        value=final.score, source=final.source,
                        type=final.type, history=history,
                    ),
                    metadata=RetrievalMatchMetadata(
                        paragraph_labels=b.labels,
                        position={"start": b.start, "end": b.end},
                        is_a_match=b.is_a_match,
                    ),
                )
            )
        return RetrievalResponse(matches=matches)

    def _find(
        self, kbid: str, request: FindRequest, metrics,
        collect_blocks: "Optional[list[TextBlock]]" = None,
    ) -> KnowledgeboxFindResults:
        field_expr, expr, json_expr, user_op = parse_request_filters(
            request.filter_expression,
            lambda slug: self.processor.resolve_slug(kbid, slug),
        )
        # system/extra constraints collect separately so operator=or keeps
        # its reference semantics: (field OR paragraph) AND constraints —
        # distributing the AND into both sides of the leg-level union
        common: Optional[BooleanExpression] = None
        if request.filters:
            # legacy facet strings: AND of translated label atoms
            common = and_(
                *[LabelAtom(translate_alias_label(f)) for f in request.filters]
            )
        # hidden resources: when the KB has them enabled and the caller did
        # not ask to see them, AND a NOT /q/h filter into every index leg
        # (parity: search/search/utils.py filter_hidden_resources + the
        # NOT LABEL_HIDDEN expression added by the query parsers)
        kb_cfg = self.kbs.get_config(kbid)
        if (
            kb_cfg is not None
            and kb_cfg.hidden_resources_enabled
            and not request.show_hidden
        ):
            hidden_expr = not_(LabelAtom("/q/h"))
            common = and_(common, hidden_expr) if common is not None else hidden_expr
        autofilters: list[str] = []
        if request.autofilter and request.query:
            # KB entities detected in the query become an OR label filter
            # ANDed into the expression (parity: find autofilter — the
            # reference uses /query entity detection then filters on
            # /e/{group}/{value}; here detection = KB entity vocabulary
            # match, with predict.detect_entities as an extra source)
            autofilters = self._autofilter_labels(kbid, request.query)
            if autofilters:
                auto_expr = or_(*[LabelAtom(l) for l in autofilters])
                common = and_(common, auto_expr) if common is not None else auto_expr
        # the leg-level union only engages when the caller supplied BOTH
        # trees with operator=or (reference filter_query Should semantics,
        # nidx_paragraph/src/search_query.rs:87-103)
        leg_op = "or" if (
            user_op == "or" and field_expr is not None and expr is not None
        ) else "and"
        if common is not None:
            expr = and_(expr, common) if expr is not None else common
            if leg_op == "or":
                field_expr = and_(field_expr, common)
        with metrics.time("embed"):
            vector = (
                self._query_vector(kbid, request)
                if SearchFeature.SEMANTIC in request.features
                else None
            )
        keyword = SearchFeature.KEYWORD in request.features and bool(request.query.strip())
        fulltext = SearchFeature.FULLTEXT in request.features and bool(request.query.strip())
        query_text = request.query
        if request.with_synonyms and keyword:
            query_text = self.synonyms.expand_query(kbid, query_text)

        # over-fetch per source so fusion has a window to work with
        # (parity: find.py over-requests before fusion cut)
        fetch_k = max((request.top_k + request.offset) * 2, 20)
        shard_req = ShardSearchRequest(
            body=query_text if (keyword or fulltext) else "",
            top_k=fetch_k,
            paragraph=keyword,
            document=fulltext,
            faceted=[translate_alias_label(f) for f in request.faceted],
            order_by=request.sort_field,
            order_desc=request.sort_order != "asc",
            vector=vector,
            vectorset=request.vectorset,
            min_score_semantic=request.min_score_semantic,
            min_score_bm25=request.min_score_bm25,
            with_duplicates=request.with_duplicates,
            filter=expr,
            field_filter=field_expr,
            json_filter=json_expr,
            filter_operator=user_op,
            leg_filter_operator=leg_op,
            security_groups=request.security_groups,
            include_hidden=request.show_hidden,
            # field ids and resource uuids both scope retrieval by key
            # prefix (paragraph keys lead with "{rid}/{field}/")
            key_filters=(
                [f.strip("/") + "/" for f in request.fields]
                + [r.strip("/") + "/" for r in request.resource_filters]
            ),
            range_creation=_range(
                request.range_creation_start, request.range_creation_end
            ),
            range_modification=_range(
                request.range_modification_start, request.range_modification_end
            ),
            # /find derives its total from the fused list; the paragraph
            # leg's corpus-wide matched count is never read — skipping it
            # drops the union/count pass (the largest non-evaluator cost of
            # the host WAND tier at 1M docs)
            need_paragraph_total=False,
        )

        keyword_blocks: list[TextBlock] = []
        semantic_blocks: list[TextBlock] = []
        fulltext_hits: list = []
        fulltext_total = 0
        fulltext_facets: dict = {}

        # external index route: the KB's vectors live in the provider, not
        # the node (parity: external_index_providers query routing in find).
        # Provider hits are post-filtered host-side so filters, security,
        # date windows and min_score apply exactly as on the node leg.
        external = self.kbs.external_index(kbid) if vector is not None else None
        if external is not None and (field_expr is not None or json_expr is not None):
            # the provider post-filter evaluates label expressions only; a
            # silently-unapplied field/key_value filter would widen results
            raise ValueError(
                "field/key_value filter expressions are not supported with an "
                "external vector index provider"
            )
        if external is not None:
            with metrics.time("external"):
                for h in external.query(vector, fetch_k):
                    if (
                        request.min_score_semantic is not None
                        and h.score < request.min_score_semantic
                    ):
                        continue
                    parsed = parse_vector_key(h.key)
                    if parsed is None:
                        continue
                    rid, fid, start, end = parsed
                    if not self._external_hit_allowed(
                        kbid, rid, h, expr, request, shard_req
                    ):
                        continue
                    semantic_blocks.append(
                        TextBlock(
                            block_id=f"{rid}/{fid}/{start}-{end}",
                            score=h.score,
                            source="semantic",
                            rid=rid,
                            field=fid,
                            start=start,
                            end=end,
                        )
                    )
            shard_req.vector = None

        with metrics.time("retrieval"):
            shard_ids = self._shard_ids(kbid)
            search_multi = getattr(self.node, "search_multi", None)
            if search_multi is not None:
                # co-resident shards execute as one sharded device program
                # when a mesh is available (parallel/group.py); otherwise
                # this is the plain sequential fan-out
                responses = search_multi(shard_ids, shard_req)
            else:
                responses = [self.node.search(s, shard_req) for s in shard_ids]
            for resp in responses:
                if resp.document is not None:
                    fulltext_hits.extend(resp.document.hits)
                    fulltext_total += resp.document.total
                    for facet, counts in resp.document.facet_counts.items():
                        agg = fulltext_facets.setdefault(facet, {})
                        for value, count in counts.items():
                            agg[value] = agg.get(value, 0) + count
                if resp.paragraph is not None:
                    for h in resp.paragraph.hits:
                        keyword_blocks.append(
                            TextBlock(
                                block_id=h.paragraph_id,
                                score=h.score,
                                source="keyword",
                                rid=h.rid,
                                field=h.field,
                                start=h.start,
                                end=h.end,
                                is_a_match=h.ematch,
                                split=h.split,
                            )
                        )
                for h in resp.vector:
                    parsed = parse_vector_key(h.key)
                    if parsed is None:
                        continue
                    rid, fid, start, end = parsed
                    semantic_blocks.append(
                        TextBlock(
                            block_id=f"{rid}/{fid}/{start}-{end}",
                            score=h.score,
                            source="semantic",
                            rid=rid,
                            field=fid,
                            start=start,
                            end=end,
                            labels=h.labels,
                        )
                    )
        with metrics.time("fusion"):
            keyword_blocks.sort(key=lambda b: -b.score)
            semantic_blocks.sort(key=lambda b: -b.score)
            lists = {"keyword": keyword_blocks, "semantic": semantic_blocks}
            if request.rank_fusion == "weighted":
                fused = weighted_comb_sum(
                    lists,
                    weights={
                        "keyword": request.keyword_boost,
                        "semantic": request.semantic_boost,
                    },
                )
            else:
                fused = reciprocal_rank_fusion(
                    lists,
                    boosts={
                        "keyword": request.keyword_boost,
                        "semantic": request.semantic_boost,
                    },
                )
            full_total = len(fused)
            if request.search_after:
                # cursor pagination, stable under concurrent writes for items
                # that keep their fused ordering (parity: search_after.py's
                # tie-broken cursors): skip past the cursor's (score, id) pair
                import base64, json as _json

                try:
                    cur_score, cur_id = _json.loads(
                        base64.urlsafe_b64decode(request.search_after.encode())
                    )
                except Exception:
                    raise ValueError("invalid search_after cursor")
                # fused ordering is (score desc, block_id asc): keep strictly-after
                fused = [
                    b
                    for b in fused
                    if b.fused_score < cur_score
                    or (b.fused_score == cur_score and b.block_id > cur_id)
                ]
            cut = fused[request.offset : request.offset + request.top_k]

        if (
            request.reranker == "predict"
            and self.predict is not None
            and hasattr(self.predict, "rerank")
            and request.query
        ):
            # model rerank over a 5x window (parity: rerankers.py
            # PredictReranker requests top_k*5 then reorders by model score;
            # cursor pagination over reranked scores is best-effort, as in
            # the reference)
            with metrics.time("rerank"):
                window = fused[request.offset : request.offset + min(request.top_k * 5, 200)]
                passages = [
                    (self.processor.field_text(kbid, b.rid, b.field) or "")[b.start : b.end]
                    for b in window
                ]
                scores = self.predict.rerank(kbid, request.query, passages)
                order = sorted(range(len(window)), key=lambda i: -scores[i])
                cut = []
                for i in order[: request.top_k]:
                    window[i].fused_score = float(scores[i])
                    cut.append(window[i])


        if collect_blocks is not None:
            # hand the cut, fused blocks (with their per-source score
            # history) to the caller — the /retrieve path reports raw
            # matches instead of a hydrated resource tree
            collect_blocks.extend(cut)

        with metrics.time("hydration"):
            highlight_terms: list[str] = []
            if request.highlight and request.query:
                from ..index.text_engine.tokenizer import tokenize

                highlight_terms = tokenize(query_text)

            results = KnowledgeboxFindResults(
                # full match count, NOT the post-cursor remainder — clients
                # size pagination off total, which must not shrink per page
                total=full_total,
                page_size=request.top_k,
                next_page=len(fused) > request.offset + request.top_k,
                autofilters=autofilters,
            )
            if cut and results.next_page and request.reranker != "predict":
                # reranked scores live on a different scale than the fused
                # ordering the cursor walks — no cursor under the reranker
                # (the reference's predict reranker has the same limitation)
                import base64, json as _json

                last = cut[-1]
                results.next_cursor = base64.urlsafe_b64encode(
                    _json.dumps([last.fused_score, last.block_id]).encode()
                ).decode()
            for order, block in enumerate(cut):
                text = self.processor.field_text(kbid, block.rid, block.field) or ""
                snippet = text[block.start : block.end]
                if highlight_terms:
                    snippet = _highlight(snippet, highlight_terms)
                score_type = (
                    "BOTH"
                    if len(block.sources) > 1
                    else ("VECTOR" if "semantic" in block.sources else "BM25")
                )
                resource = results.resources.get(block.rid)
                if resource is None:
                    resource = self._serialize_resource(kbid, block.rid, request)
                    results.resources[block.rid] = resource
                field = resource.fields.setdefault(f"/{block.field}", FindField())
                field.paragraphs[block.block_id] = FindParagraph(
                    score=block.fused_score,
                    score_type=score_type,
                    order=order,
                    text=snippet,
                    id=block.block_id,
                    labels=block.labels,
                    position={"start": block.start, "end": block.end},
                    is_a_match=block.is_a_match,
                    fuzzy_result=block.fuzzy,
                )
                results.best_matches.append(block.block_id)

            if SearchFeature.RELATIONS in request.features:
                results.relations = self._query_relations(kbid, request.query)

            if fulltext:
                from ..models.api import FulltextHit, FulltextResults

                if request.sort_field is None:
                    fulltext_hits.sort(key=lambda h: -h.score)
                else:
                    # per-shard responses are each ordered; the concatenation
                    # is not — re-establish the global date order host-side
                    stamp = {}
                    for h in fulltext_hits:
                        if h.rid not in stamp:
                            meta = self.processor.get_meta(kbid, h.rid)
                            stamp[h.rid] = getattr(meta, request.sort_field, 0.0) if meta else 0.0
                    fulltext_hits.sort(
                        key=lambda h: stamp[h.rid],
                        reverse=request.sort_order != "asc",
                    )
                window = fulltext_hits[
                    request.offset : request.offset + request.top_k
                ]
                results.fulltext = FulltextResults(
                    results=[
                        FulltextHit(rid=h.rid, field=h.field, score=h.score)
                        for h in window
                    ],
                    total=fulltext_total,
                    facets=fulltext_facets,
                )
                # fulltext-matched resources serialize into `resources` too
                # (parity: merge.py resources.update(matched_resources) for
                # the document leg, search/search/merge.py:496-505)
                for h in window:
                    if h.rid not in results.resources:
                        results.resources[h.rid] = self._serialize_resource(
                            kbid, h.rid, request
                        )
        if request.debug:
            results.timings = dict(metrics.phases)
        return results

    def _serialize_resource(self, kbid: str, rid: str, request) -> FindResource:
        """One matched resource -> FindResource honoring `show=` options
        (shared by the paragraph and fulltext legs so hydration stays
        uniform within a response — parity: merge.py serializes all matched
        resources through one path)."""
        payload = self.processor.get_payload(kbid, rid)
        resource = FindResource(
            id=rid,
            title=payload.title if payload else "",
            summary=payload.summary if payload else "",
        )
        if request.show and payload is not None:
            from ..models.api import FindResourceData

            meta = self.processor.get_meta(kbid, rid)
            data = FindResourceData()
            if "basic" in request.show:
                data.created = meta.created if meta else None
                data.modified = meta.modified if meta else None
                data.icon = payload.icon
                data.labels = [
                    f"/l/{c.labelset}/{c.label}"
                    for c in payload.usermetadata.classifications
                ]
            if "values" in request.show:
                data.texts = payload.texts
                data.links = payload.links
            if "relations" in request.show or "values" in request.show:
                data.usergenerated_relations = user_relations(payload)
            resource.data = data
        return resource

    def _query_relations(self, kbid: str, query: str) -> list[Relation]:
        """Entity neighbourhood for query terms (the reference detects
        entities via Predict; here we match query tokens against graph nodes)."""
        from ..index.text_engine.tokenizer import tokenize

        tokens = tokenize(query)
        out: list[Relation] = []
        for shard_id in self._shard_ids(kbid):
            searcher = self.node.searcher.shard(shard_id)
            if searcher.relation is None:
                continue
            paths = searcher.relation.neighbours(tokens, top_k=20)
            for p in paths:
                out.append(
                    Relation(
                        relation=p.relation,
                        label=p.label,
                        from_value=p.source.value,
                        to_value=p.target.value,
                        metadata=p.metadata,
                    )
                )
        return out

    # ------------------------------------------------------------------

    def suggest(self, kbid: str, request: SuggestRequest) -> SuggestResponse:
        resp = SuggestResponse()
        field_expr, expr, json_expr, user_op = parse_request_filters(
            request.filter_expression,
            lambda slug: self.processor.resolve_slug(kbid, slug),
        )
        if request.filters:
            legacy = and_(
                *[LabelAtom(translate_alias_label(f)) for f in request.filters]
            )
            expr = and_(expr, legacy) if expr is not None else legacy
        # hidden resources never surface in suggestions (parity: suggest
        # parser applies the NOT LABEL_HIDDEN filter like find)
        kb_cfg = self.kbs.get_config(kbid)
        hide = kb_cfg is not None and kb_cfg.hidden_resources_enabled
        hidden_rids: set[str] = set()
        for shard_id in self._shard_ids(kbid):
            searcher = self.node.searcher.shard(shard_id)
            shard_filter = expr
            if field_expr is not None or json_expr is not None:
                # field/key_value trees reach suggest through the shard's
                # prefilter, handed to the paragraph engine as key prefixes
                # (the KeyPrefixSet handoff); operator=or unions the two
                # sides inside the one expression tree
                pf = searcher.compute_prefilter(
                    ShardSearchRequest(
                        field_filter=field_expr,
                        json_filter=json_expr,
                        filter_operator=user_op,
                    )
                )
                if pf.is_none:
                    continue
                if not pf.is_all:
                    from ..query_language import KeyPrefixAtom

                    atom = KeyPrefixAtom(tuple(
                        f.as_key_prefix().rstrip("/") + "/" for f in pf.fields
                    ))
                    if shard_filter is None:
                        shard_filter = atom
                    elif user_op == "or" and request.filter_expression.paragraph is not None:
                        shard_filter = or_(atom, shard_filter)
                    else:
                        shard_filter = and_(atom, shard_filter)
            if "paragraph" in request.features and searcher.paragraph is not None:
                for hit in searcher.paragraph.suggest(
                    request.query, request.top_k, filter=shard_filter
                ):
                    if hide:
                        if hit.rid not in hidden_rids:
                            payload = self.processor.get_payload(kbid, hit.rid)
                            if payload is not None and payload.hidden:
                                hidden_rids.add(hit.rid)
                        if hit.rid in hidden_rids:
                            continue
                    text = self.processor.field_text(kbid, hit.rid, hit.field) or ""
                    resp.paragraphs.append(
                        SuggestedParagraph(
                            id=hit.paragraph_id,
                            text=text[hit.start : hit.end],
                            score=hit.score,
                            rid=hit.rid,
                            field=hit.field,
                        )
                    )
            if "entities" in request.features and searcher.relation is not None:
                for node in searcher.relation.suggest_nodes(request.query, request.top_k):
                    resp.entities.append(node.value)
        resp.paragraphs = sorted(resp.paragraphs, key=lambda p: -p.score)[: request.top_k]
        resp.entities = sorted(set(resp.entities))[: request.top_k]
        return resp

    def catalog(self, kbid: str, request: CatalogRequest) -> CatalogResponse:
        """Faceted resource listing (parity: /catalog, common/catalog/pg.py —
        the reference lists from PG; here from the text index's document
        search with facets + date ordering)."""
        from ..index.text import DocumentSearchRequest

        f = request.filter_expression
        if f is not None and f.is_rich:
            # the catalog plane filters resources: the field tree lowers
            # directly (the document engine resolves every atom kind);
            # paragraph/key_value trees have no catalog meaning (parity:
            # CatalogFilterExpression is resource-scoped)
            if f.paragraph is not None or f.key_value is not None:
                raise ValueError(
                    "catalog filter_expression supports the field tree only"
                )
            from .filter_expr import parse_expr

            expr = parse_expr(
                f.field, lambda slug: self.processor.resolve_slug(kbid, slug)
            )
        else:
            expr = filter_to_expression(f)
        if request.filters:
            legacy = and_(
                *[LabelAtom(translate_alias_label(f)) for f in request.filters]
            )
            expr = and_(expr, legacy) if expr is not None else legacy
        if request.hidden is not None:
            # parity: catalog.py hidden filter over LABEL_HIDDEN (/q/h)
            hidden_expr = (
                LabelAtom("/q/h") if request.hidden else not_(LabelAtom("/q/h"))
            )
            expr = and_(expr, hidden_expr) if expr is not None else hidden_expr
        if request.query.strip():
            # catalog queries match TITLES, not bodies (parity: catalog/pg.py
            # `title ILIKE`/word matching) — restrict scoring to the
            # title/summary ("a/") fields via their field-type facet
            title_expr = LabelAtom("/f/a")
            expr = and_(expr, title_expr) if expr is not None else title_expr
        resources: dict[str, CatalogResource] = {}
        facet_totals: dict[str, dict[str, int]] = {}
        total = 0
        for shard_id in self._shard_ids(kbid):
            searcher = self.node.searcher.shard(shard_id)
            if searcher.text is None:
                continue
            resp = searcher.text.search(
                DocumentSearchRequest(
                    query=request.query,
                    top_k=(request.page_number + 1) * request.page_size,
                    filter=expr,
                    faceted=[translate_alias_label(f) for f in request.faceted],
                    only_faceted=not request.query.strip(),
                    order_by=request.order_by,
                    order_desc=request.order_desc,
                    count_resources=True,  # catalog lists resources, not fields
                    range_creation=_range(
                        request.range_creation_start, request.range_creation_end
                    ),
                    range_modification=_range(
                        request.range_modification_start,
                        request.range_modification_end,
                    ),
                )
            )
            total += resp.total
            for facet, counts in resp.facet_counts.items():
                dst = facet_totals.setdefault(facet, {})
                for label, c in counts.items():
                    dst[label] = dst.get(label, 0) + c
            for hit in resp.hits:
                if hit.rid in resources:
                    continue
                meta = self.processor.get_meta(kbid, hit.rid)
                payload = self.processor.get_payload(kbid, hit.rid)
                resources[hit.rid] = CatalogResource(
                    id=hit.rid,
                    title=payload.title if payload else "",
                    labels=[
                        f"/l/{c.labelset}/{c.label}"
                        for c in (payload.usermetadata.classifications if payload else [])
                    ],
                    created=meta.created if meta else 0.0,
                    modified=meta.modified if meta else 0.0,
                )
        items = sorted(
            resources.values(),
            key=lambda r: getattr(r, request.order_by, r.created),
            reverse=request.order_desc,
        )
        lo = request.page_number * request.page_size
        return CatalogResponse(
            resources=items[lo : lo + request.page_size],
            total=total,
            facets=facet_totals,
        )

    def _semantic_value_scores(
        self, kbid: str, searcher, values: list[str], query: str, top_n: int,
        cache_attr: str,
    ) -> dict[str, float]:
        """Embedding-similarity scores for a value list vs a query text:
        {normalized value: cosine score} for the top-N positive matches
        (parity: the reference's relation node/edge vectors resolved into
        VectorQueryResults, nidx_relation config.rs:94-100 +
        graph_query_parser.rs FromVectorQuery; embedded through the predict
        seam and cached per searcher)."""
        if self.predict is None or not values:
            return {}
        from ..index.text_engine.tokenizer import strip_diacritics

        fingerprint = hash(tuple(values))
        cached = getattr(searcher.relation, cache_attr, None)
        if cached is None or cached[0] != fingerprint:
            vecs = [self.predict.embed(kbid, "", value) for value in values]
            mat = np.stack([np.asarray(v, np.float32) for v in vecs])
            norms = np.linalg.norm(mat, axis=1, keepdims=True)
            mat = mat / np.maximum(norms, 1e-12)
            cached = (fingerprint, mat)
            setattr(searcher.relation, cache_attr, cached)
        cache = cached[1]
        qv = np.asarray(self.predict.embed(kbid, "", query), np.float32)
        qv = qv / max(float(np.linalg.norm(qv)), 1e-12)
        sims = cache @ qv
        order = np.argsort(-sims)[:top_n]
        return {
            strip_diacritics(values[i].lower()): float(sims[i])
            for i in order
            if sims[i] > 0
        }

    def _semantic_graph_nodes(self, kbid: str, searcher, query: str, top_n: int) -> list[str]:
        """Node values ranked by embedding similarity to the query."""
        scores = self._semantic_value_scores(
            kbid, searcher, searcher.relation.node_values, query, top_n,
            "_semantic_vecs",
        )
        norm_to_value = {}
        from ..index.text_engine.tokenizer import strip_diacritics

        for v in searcher.relation.node_values:
            norm_to_value.setdefault(strip_diacritics(v.lower()), v)
        ranked = sorted(scores.items(), key=lambda kv: -kv[1])
        return [norm_to_value[n] for n, _ in ranked if n in norm_to_value]

    def _resolve_semantic_leaves(self, kbid: str, searcher, query: dict) -> dict:
        """Inject ``semantic_matches`` into match="semantic" node/relation
        leaves (per shard: each searcher has its own node/label sets)."""

        def node_leaf(d: dict) -> dict:
            if d.get("match") != "semantic" or not d.get("value"):
                return d
            out = dict(d)
            out["semantic_matches"] = self._semantic_value_scores(
                kbid, searcher, searcher.relation.node_values, d["value"], 20,
                "_semantic_vecs",
            )
            return out

        def rel_leaf(d: dict) -> dict:
            if d.get("match") != "semantic" or not d.get("label"):
                return d
            labels = sorted({e["label"] for e in searcher.relation.edges if e["label"]})
            out = dict(d)
            out["semantic_matches"] = self._semantic_value_scores(
                kbid, searcher, labels, d["label"], 20, "_semantic_label_vecs"
            )
            return out

        def walk(q):
            if not isinstance(q, dict):
                return q
            if "and" in q:
                return {"and": [walk(x) for x in q["and"]]}
            if "or" in q:
                return {"or": [walk(x) for x in q["or"]]}
            if "not" in q:
                return {"not": walk(q["not"])}
            prop = q.get("prop")
            if prop == "path":
                out = dict(q)
                if q.get("source"):
                    out["source"] = node_leaf(q["source"])
                if q.get("destination"):
                    out["destination"] = node_leaf(q["destination"])
                if q.get("relation"):
                    out["relation"] = rel_leaf(q["relation"])
                return out
            if prop in ("source_node", "destination_node", "node"):
                return node_leaf(q)
            if prop == "relation":
                return rel_leaf(q)
            return q

        return walk(query)

    def graph(self, kbid: str, request: GraphSearchPayload) -> GraphSearchResponse:
        greq = GraphSearchRequest(
            source=NodePattern(
                value=request.source_value,
                ntype=request.source_type.upper() if request.source_type else None,
                fuzzy=request.fuzzy,
            ),
            relation=RelationPattern(label=request.relation_label),
            target=NodePattern(
                value=request.target_value,
                ntype=request.target_type.upper() if request.target_type else None,
                fuzzy=request.fuzzy,
            ),
            undirected=request.undirected,
            top_k=request.top_k,
        )
        # the flat payload honors the same resource constraints as the
        # boolean-expression mode (parity: BaseGraphSearchRequest security /
        # show_hidden, nodereader.proto:248) — without this the flat shape
        # was a security bypass
        edge_ok_factory = self._graph_edge_filter(
            kbid,
            security_groups=(
                list(request.security.get("groups", []) or [])
                if request.security
                else None
            ),
            show_hidden=request.show_hidden,
        )
        out = GraphSearchResponse()
        for shard_id in self._shard_ids(kbid):
            searcher = self.node.searcher.shard(shard_id)
            if searcher.relation is None:
                continue
            skip, edge_ok = edge_ok_factory(searcher)
            if skip:
                continue
            paths = list(searcher.relation.graph_search(greq))
            if edge_ok is not None:
                paths = [
                    p for p in paths if edge_ok({"key": p.resource_field})
                ]
            if request.semantic and request.query:
                # widen the matched-node set with semantically close nodes
                seen = {(p.source.value, p.relation, p.target.value) for p in paths}
                for value in self._semantic_graph_nodes(
                    kbid, searcher, request.query, max(request.top_k // 5, 5)
                ):
                    node_req = GraphSearchRequest(
                        source=NodePattern(value=value),
                        relation=RelationPattern(label=request.relation_label),
                        target=NodePattern(),
                        undirected=True,
                        top_k=request.top_k,
                    )
                    for p in searcher.relation.graph_search(node_req):
                        key = (p.source.value, p.relation, p.target.value)
                        if key not in seen:
                            if edge_ok is not None and not edge_ok(
                                {"key": p.resource_field}
                            ):
                                continue
                            seen.add(key)
                            paths.append(p)
            for p in paths:
                out.paths.append(
                    GraphPathResult(
                        source=p.source.value,
                        source_type=p.source.ntype,
                        relation=p.relation,
                        label=p.label,
                        target=p.target.value,
                        target_type=p.target.ntype,
                    )
                )
        return out

    def graph_expr(
        self,
        kbid: str,
        query: dict,
        top_k: int = 50,
        *,
        filter_expression: "Optional[FilterExpression]" = None,
        security_groups: Optional[list[str]] = None,
        show_hidden: bool = False,
    ) -> GraphSearchResponse:
        """Boolean path-query /graph mode (parity: GraphSearchRequest.query
        expression trees — and/or/not over path/node/relation leaves, plus
        the BaseGraphSearchRequest resource constraints: filter_expression,
        security and show_hidden)."""
        edge_ok_factory = self._graph_edge_filter(
            kbid, filter_expression=filter_expression,
            security_groups=security_groups, show_hidden=show_hidden,
        )

        resp = GraphSearchResponse()
        for shard_id in self._shard_ids(kbid):
            searcher = self.node.searcher.shard(shard_id)
            if searcher.relation is None:
                continue
            skip, edge_ok = edge_ok_factory(searcher)
            if skip:
                continue
            q = self._resolve_semantic_leaves(kbid, searcher, query)
            # edge_ok filters inside the index BEFORE the top_k cut — the
            # old post-filtering under-filled top_k on constrained queries
            for p in searcher.relation.graph_search_expr(
                q, top_k, edge_ok=edge_ok
            ):
                resp.paths.append(
                    GraphPathResult(
                        source=p.source.value,
                        source_type=p.source.ntype,
                        source_group=p.source.subtype,
                        relation=p.relation,
                        label=p.label,
                        target=p.target.value,
                        target_type=p.target.ntype,
                        target_group=p.target.subtype,
                        score=p.score,
                        field_id=p.resource_field,
                    )
                )
        resp.paths.sort(key=lambda p: -(p.score or 0.0))
        resp.paths = resp.paths[:top_k]
        return resp

    def _graph_edge_filter(
        self,
        kbid: str,
        *,
        filter_expression: "Optional[FilterExpression]" = None,
        security_groups: Optional[list[str]] = None,
        show_hidden: bool = False,
    ):
        """Edge predicate applying the BaseGraphSearchRequest resource
        constraints (filter_expression/security/show_hidden), or None when
        unconstrained. Rich field trees (reference filters.py) resolve
        through each shard's text prefilter, so this returns a per-shard
        FACTORY: ``factory(searcher) -> (skip_shard, edge_ok_or_None)``."""
        from ..query_language import evaluate_one

        rich_field = None
        if filter_expression is not None and filter_expression.is_rich:
            if (
                filter_expression.paragraph is not None
                or filter_expression.key_value is not None
            ):
                raise ValueError(
                    "graph filter_expression supports the field tree only"
                )
            from .filter_expr import parse_expr

            rich_field = parse_expr(
                filter_expression.field,
                lambda slug: self.processor.resolve_slug(kbid, slug),
            )
            expr = None
        else:
            expr = filter_to_expression(filter_expression)
        kb_cfg = self.kbs.get_config(kbid)
        hide = (
            kb_cfg is not None and kb_cfg.hidden_resources_enabled and not show_hidden
        )
        if not hide and expr is None and rich_field is None and security_groups is None:
            return lambda searcher: (False, None)
        allowed: dict[str, bool] = {}

        def edge_ok(e: dict) -> bool:
            rid = e["key"].split("/", 1)[0]
            cached = allowed.get(rid)
            if cached is not None:
                return cached
            ok = True
            payload = self.processor.get_payload(kbid, rid)
            if payload is None:
                ok = False
            else:
                if hide and payload.hidden:
                    ok = False
                if ok and expr is not None:
                    labels = {
                        f"/l/{c.labelset}/{c.label}"
                        for c in payload.usermetadata.classifications
                    }
                    ok = evaluate_one(expr, labels, key=rid)
                if ok and security_groups is not None:
                    groups = (
                        set(payload.security.access_groups)
                        if payload.security
                        else set()
                    )
                    if groups and not groups & set(security_groups):
                        ok = False
            allowed[rid] = ok
            return ok

        def factory(searcher):
            if rich_field is None:
                return False, edge_ok
            # rich field tree -> this shard's text prefilter -> edge
            # predicate (the same a/metadata-admitting rule both gRPC
            # planes use, index/relation prefilter_edge_ok)
            from ..index.relation import prefilter_edge_ok

            pf = searcher.compute_prefilter(
                ShardSearchRequest(field_filter=rich_field)
            )
            if pf.is_none:
                return True, None
            pf_ok = prefilter_edge_ok(pf)
            if pf_ok is None:
                return False, edge_ok
            return False, lambda e: pf_ok(e) and edge_ok(e)

        return factory

    def graph_nodes_expr(
        self,
        kbid: str,
        query: dict,
        top_k: int = 50,
        *,
        filter_expression: "Optional[FilterExpression]" = None,
        security_groups: Optional[list[str]] = None,
        show_hidden: bool = False,
    ) -> "GraphNodesResponse":
        """/graph/nodes — distinct nodes with best scores (parity:
        nodes_graph_search + TopUniqueN, nidx_relation/src/reader.rs:181)."""
        from ..models.api import GraphNodeResult, GraphNodesResponse

        edge_ok_factory = self._graph_edge_filter(
            kbid, filter_expression=filter_expression,
            security_groups=security_groups, show_hidden=show_hidden,
        )
        best: dict[tuple[str, str, str], float] = {}
        for shard_id in self._shard_ids(kbid):
            searcher = self.node.searcher.shard(shard_id)
            if searcher.relation is None:
                continue
            skip, edge_ok = edge_ok_factory(searcher)
            if skip:
                continue
            q = self._resolve_semantic_leaves(kbid, searcher, query)
            for node, score in searcher.relation.nodes_search(
                q, top_k, edge_ok=edge_ok
            ):
                key = (node.value, node.ntype, node.subtype)
                if score > best.get(key, -1.0):
                    best[key] = score
        ranked = sorted(best.items(), key=lambda kv: (-kv[1], kv[0]))[:top_k]
        return GraphNodesResponse(
            nodes=[
                GraphNodeResult(value=v, type=t, group=g, score=s)
                for (v, t, g), s in ranked
            ]
        )

    def graph_relations_expr(
        self,
        kbid: str,
        query: dict,
        top_k: int = 50,
        *,
        filter_expression: "Optional[FilterExpression]" = None,
        security_groups: Optional[list[str]] = None,
        show_hidden: bool = False,
    ) -> "GraphRelationsResponse":
        """/graph/relations — distinct relations with best scores (parity:
        relations_graph_search + TopUniqueN)."""
        from ..models.api import GraphRelationResult, GraphRelationsResponse

        edge_ok_factory = self._graph_edge_filter(
            kbid, filter_expression=filter_expression,
            security_groups=security_groups, show_hidden=show_hidden,
        )
        best: dict[tuple[str, str], float] = {}
        for shard_id in self._shard_ids(kbid):
            searcher = self.node.searcher.shard(shard_id)
            if searcher.relation is None:
                continue
            skip, edge_ok = edge_ok_factory(searcher)
            if skip:
                continue
            q = self._resolve_semantic_leaves(kbid, searcher, query)
            for rel, label, score in searcher.relation.relations_search(
                q, top_k, edge_ok=edge_ok
            ):
                key = (rel, label)
                if score > best.get(key, -1.0):
                    best[key] = score
        ranked = sorted(best.items(), key=lambda kv: (-kv[1], kv[0]))[:top_k]
        return GraphRelationsResponse(
            relations=[
                GraphRelationResult(type=rel, label=label, score=s)
                for (rel, label), s in ranked
            ]
        )

    def ask(self, kbid: str, request: AskRequest) -> AskResponse:
        with self.processor.payload_cache():
            head, chunks = self._ask_impl(kbid, request)
        if chunks is not None:
            head.answer = "".join(self._budget_chunks(chunks, request.max_tokens))
        return head

    def ask_stream(self, kbid: str, request: AskRequest):
        """Streaming /ask: -> (head AskResponse with answer='', iterator of
        answer chunks). Chunks yield AS the predict engine produces them —
        the retrieval/citations/status live on ``head``; the caller streams
        the chunks and owns assembling the final answer (parity: the
        reference pipes Predict /chat tokens through the ndjson items,
        chat/ask.py:210-370). Retrieval and prompt building complete before
        this returns; iterating the chunks touches only the predict engine."""
        with self.processor.payload_cache():
            head, chunks = self._ask_impl(kbid, request)
        if chunks is None:
            only, head.answer = head.answer, ""
            return head, iter([only] if only else [])
        return head, self._budget_chunks(chunks, request.max_tokens)

    @staticmethod
    def _budget_chunks(chunks, max_tokens: int):
        """max_tokens budget over a chunk stream (whitespace tokens, the
        sync path's crude parity cut) — truncates mid-stream so a budgeted
        ask stops consuming the model once the budget is spent."""
        if max_tokens <= 0:
            yield from chunks
            return
        used = 0
        for c in chunks:
            toks = c.split()
            if used + len(toks) < max_tokens:
                used += len(toks)
                yield c
                continue
            keep = max_tokens - used
            if keep > 0:
                yield " ".join(toks[:keep])
            return

    def _ask_impl(self, kbid: str, request: AskRequest):
        """Retrieval-grounded answering (parity: /ask, chat/ask.py). The
        generative step goes through the PredictEngine seam; without one the
        endpoint returns the retrieved context with citations (the
        reference's predict-proxy role cannot be assumed in an embedded
        deployment).

        Returns (AskResponse, chunk-iterator-or-None): when the answer can
        stream, the response head has ``answer=""`` and the iterator carries
        the chunks; short-circuit branches return the complete response and
        None."""
        rephrased: Optional[str] = None
        retrieval_query = request.query
        if (
            request.chat_history
            and self.predict is not None
            and hasattr(self.predict, "rephrase")
        ):
            # standalone-question rewrite so retrieval sees the full intent
            # (parity: predict.py rephrase_query before retrieval in ask)
            rephrased = self.predict.rephrase(
                kbid, request.query,
                [m.model_dump() for m in request.chat_history],
            )
            if rephrased:
                retrieval_query = rephrased
        find_req = FindRequest(
            query=retrieval_query,
            vector=request.vector,
            vectorset=request.vectorset,
            features=[f for f in request.features if f != SearchFeature.RELATIONS],
            top_k=request.top_k,
            filter_expression=request.filter_expression,
            security_groups=request.security_groups,
            fields=request.fields,
        )
        retrieval = self.find(kbid, find_req)
        context: list[str] = []
        citations: dict[str, list[str]] = {}
        # rag_strategies accept the reference's parameterized objects
        # ({"name": ..., params}) and bare-name strings (search.py
        # RagStrategy subclasses: full_resource count, neighbouring
        # before/after, field_extension fields, conversation max_messages/
        # full, metadata_extension, hierarchy, graph_beta, prequeries)
        strategies: dict[str, dict] = {}
        for s in request.rag_strategies:
            if isinstance(s, str):
                strategies[s] = {}
            elif isinstance(s, dict) and s.get("name"):
                strategies[str(s["name"])] = {k: v for k, v in s.items() if k != "name"}
        full_resource = "full_resource" in strategies
        neighbours = "neighbouring_paragraphs" in strategies
        hierarchy = "hierarchy" in strategies
        metadata_ext = "metadata_extension" in strategies
        field_ext = strategies.get("field_extension")
        conversation = strategies.get("conversation")
        n_before = int(strategies.get("neighbouring_paragraphs", {}).get("before", 1))
        n_after = int(strategies.get("neighbouring_paragraphs", {}).get("after", 1))
        full_resource_count = strategies.get("full_resource", {}).get("count")
        resources_widened = 0

        # prequeries: their contexts lead, strongest weight first (parity:
        # chat/ask.py prequeries)
        for pq in sorted(request.prequeries, key=lambda p: -p.weight):
            pre = self.find(kbid, pq.request)
            for rid, resource in pre.resources.items():
                for field in resource.fields.values():
                    for para in field.paragraphs.values():
                        if para.text and para.text not in context:
                            context.append(para.text)

        for rid, resource in retrieval.resources.items():
            hit_fields = set()
            prefix = ""
            if hierarchy:
                # resource hierarchy leads each block (parity: hierarchy
                # strategy, chat/prompt.py)
                parts = [p for p in (resource.title, resource.summary) if p]
                prefix = " > ".join(parts) + (" > " if parts else "")
            widen = full_resource and (
                full_resource_count is None
                or resources_widened < int(full_resource_count)
            )
            for fid, field in resource.fields.items():
                for pid, para in field.paragraphs.items():
                    hit_fields.add(fid)
                    if not widen:
                        if conversation is not None and fid.strip("/").startswith("c/"):
                            context.append(
                                prefix
                                + self._conversation_context(
                                    kbid, rid, fid, pid, para.text, conversation
                                )
                            )
                        elif neighbours:
                            context.append(
                                prefix
                                + self._with_neighbours(
                                    kbid, rid, fid, pid, para.text,
                                    before=n_before, after=n_after,
                                )
                            )
                        else:
                            context.append(prefix + para.text)
                    citations.setdefault(rid, []).append(pid)
            if widen:
                # widen each hit to the whole field text (parity:
                # rag_strategies full_resource, search/search/chat/prompt.py;
                # the count param bounds how many resources widen)
                resources_widened += 1
                for fid in hit_fields:
                    text = self.processor.field_text(kbid, rid, fid.strip("/"))
                    if text:
                        context.append(prefix + text)
            if field_ext is not None:
                # attach the named fields of every matched resource (parity:
                # FieldExtensionStrategy, search.py:1193-1235)
                for fxid in field_ext.get("fields", []):
                    fxid = str(fxid).strip("/")
                    if fxid in {f.strip("/") for f in hit_fields}:
                        continue  # already in context via the hit itself
                    text = self.processor.field_text(kbid, rid, fxid)
                    if text:
                        context.append(prefix + text)
            if metadata_ext:
                payload = self.processor.get_payload(kbid, rid)
                if payload is not None:
                    lines = []
                    labels = [
                        f"/l/{c.labelset}/{c.label}"
                        for c in payload.usermetadata.classifications
                    ]
                    if labels:
                        lines.append("labels: " + ", ".join(labels))
                    if payload.origin and (payload.origin.tags or payload.origin.url):
                        lines.append(
                            "origin: "
                            + " ".join(payload.origin.tags)
                            + (f" url={payload.origin.url}" if payload.origin.url else "")
                        )
                    if lines:
                        context.append(f"[{resource.title}] " + "; ".join(lines))

        if "graph" in strategies or "graph_beta" in strategies:
            # entity triples around the query join the context (parity: the
            # graph_strategy beta in ask)
            for rel in self._query_relations(kbid, retrieval_query):
                context.append(
                    f"{rel.from_value} —{rel.label or rel.relation}→ {rel.to_value}"
                )
        # chat history + caller-supplied grounding lead the prompt context
        history = [
            f"{m.author}: {m.text}" for m in request.chat_history
        ]
        context = request.extra_context + context
        if not context and not history:
            return AskResponse(answer="", status="no_context", retrieval=retrieval), None
        if not request.citations:
            citations = {}
        if self.predict is not None:
            prompt = request.prompt or request.query
            if request.answer_json_schema is not None:
                # structured answers: engines exposing generate_json get the
                # schema; otherwise it rides the prompt (parity:
                # answer_json_schema in ask — the reference forwards it to
                # the Predict /chat call)
                if hasattr(self.predict, "generate_json"):
                    answer = self.predict.generate_json(
                        kbid, prompt, history + context, request.answer_json_schema
                    )
                    return AskResponse(
                        answer=answer if isinstance(answer, str) else json.dumps(answer),
                        retrieval=retrieval, citations=citations,
                        rephrased_query=rephrased,
                    ), None
                prompt += (
                    "\nAnswer as a single JSON object matching this schema: "
                    + json.dumps(request.answer_json_schema)
                )
            head = AskResponse(
                answer="", retrieval=retrieval, citations=citations,
                rephrased_query=rephrased,
            )
            if hasattr(self.predict, "generate_stream"):
                # the chunks flow to the caller AS the model produces them;
                # the max_tokens budget is applied by the stream wrapper
                return head, self.predict.generate_stream(
                    kbid, prompt, history + context
                )
            return head, iter([self.predict.generate(kbid, prompt, history + context)])
        answer = "\n\n".join(context[:3])
        return AskResponse(
            answer=answer,
            status="no_generative_model",
            retrieval=retrieval,
            citations=citations,
            rephrased_query=rephrased,
        ), None

    def _with_neighbours(
        self, kbid: str, rid: str, fid: str, pid: str, fallback: str,
        *, before: int = 1, after: int = 1,
    ) -> str:
        """Extend a paragraph hit with its adjacent paragraphs (parity:
        rag_strategies neighbouring_paragraphs with before/after counts)."""
        from ..ingest.brain import split_paragraphs

        text = self.processor.field_text(kbid, rid, fid.strip("/"))
        parsed = parse_paragraph_id(pid)
        if text is None or parsed is None:
            return fallback
        _, _, start, end = parsed
        spans = list(split_paragraphs(text))
        for i, (s, e) in enumerate(spans):
            if s == start and e == end:
                lo = spans[max(i - before, 0)][0]
                hi = spans[min(i + after, len(spans) - 1)][1]
                return text[lo:hi]
        return fallback

    def _conversation_context(
        self, kbid: str, rid: str, fid: str, pid: str, fallback: str,
        params: dict,
    ) -> str:
        """Surround a conversation-message hit with neighbouring messages
        (parity: ConversationalStrategy — ``full`` attaches the whole
        transcript, else up to ``max_messages`` around the hit;
        search.py:1316-1376)."""
        payload = self.processor.get_payload(kbid, rid)
        name = fid.strip("/").split("/", 1)[-1]
        conv = (payload.conversations or {}).get(name) if payload else None
        if conv is None:
            return fallback
        lines = conv.transcript_lines()
        if params.get("full"):
            return "\n".join(lines)
        max_messages = int(params.get("max_messages", 15))
        # locate the hit message by its offset in the joined transcript
        # (the brain computes paragraph spans over the same join)
        parsed = parse_paragraph_id(pid)
        hit_idx = 0
        if parsed is not None:
            _, _, start, _ = parsed
            off = 0
            for i, line in enumerate(lines):
                if off <= start < off + len(line) + 1:
                    hit_idx = i
                    break
                off += len(line) + 1
        half = max(max_messages // 2, 1)
        lo = max(hit_idx - half, 0)
        return "\n".join(lines[lo : lo + max_messages]) or fallback
