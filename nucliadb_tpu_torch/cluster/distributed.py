"""Scatter-gather over shard replicas + response merging."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Protocol, Sequence

from ..shard import ShardSearchRequest, ShardSearchResponse
from .selector import ShardSelector


class SearchBackend(Protocol):
    """One searcher node (a NodeClient, an EmbeddedNode, or a test double)."""

    def search(self, shard_id: str, request: ShardSearchRequest) -> ShardSearchResponse: ...


@dataclass
class ShardError:
    shard_id: str
    attempts: list[str]
    error: str


def merge_shard_responses(
    responses: Sequence[ShardSearchResponse], top_k: int
) -> ShardSearchResponse:
    """Merge per-shard responses (parity: shard_merge.rs:54-332):
    score-ordered cut for paragraphs/documents/vectors, concatenation for
    graph paths, summed totals and facet counts."""
    from ..index.paragraph import ParagraphSearchResponse
    from ..index.text import DocumentSearchResponse

    out = ShardSearchResponse()
    para_hits, doc_hits = [], []
    para_total = doc_total = 0
    ematches: list[str] = []
    query_terms: list[str] = []
    facet_counts: dict[str, dict[str, int]] = {}
    any_para = any_doc = False
    for r in responses:
        if r.paragraph is not None:
            any_para = True
            para_hits.extend(r.paragraph.hits)
            para_total += r.paragraph.total
            ematches.extend(r.paragraph.ematches)
            query_terms = query_terms or r.paragraph.query_terms
        if r.document is not None:
            any_doc = True
            doc_hits.extend(r.document.hits)
            doc_total += r.document.total
            for facet, counts in r.document.facet_counts.items():
                dst = facet_counts.setdefault(facet, {})
                for label, c in counts.items():
                    dst[label] = dst.get(label, 0) + c
        out.vector.extend(r.vector)
        out.graph.extend(r.graph)
    if any_para:
        out.paragraph = ParagraphSearchResponse(
            hits=sorted(para_hits, key=lambda h: -h.score)[:top_k],
            total=para_total,
            ematches=ematches,
            query_terms=query_terms,
        )
    if any_doc:
        out.document = DocumentSearchResponse(
            hits=sorted(doc_hits, key=lambda h: -h.score)[:top_k],
            total=doc_total,
            facet_counts=facet_counts,
        )
    out.vector = sorted(out.vector, key=lambda h: -h.score)[:top_k]
    return out


class DistributedSearcher:
    """Fan a search out to every shard's replica set with failover.

    ``backends`` maps node name -> SearchBackend. Nodes that raise are
    retried on the next rendezvous replica; a shard with no live replica is
    reported (and tolerated — the reference tolerates shards mid-topology-
    change, shards_query.rs:54-57) unless ``strict``.
    """

    def __init__(
        self,
        backends: dict[str, SearchBackend],
        selector: Optional[ShardSelector] = None,
        *,
        strict: bool = False,
    ):
        self.backends = backends
        self.selector = selector or ShardSelector(list(backends))
        self.strict = strict

    def _search_one(
        self, shard_id: str, request: ShardSearchRequest
    ) -> tuple[Optional[ShardSearchResponse], Optional[ShardError]]:
        replicas = self.selector.nodes_for_shard(shard_id)
        attempts = []
        last_error = "no replicas"
        for node in replicas:
            backend = self.backends.get(node)
            if backend is None:
                continue
            attempts.append(node)
            try:
                return backend.search(shard_id, request), None
            except Exception as e:  # failover to next replica
                last_error = f"{type(e).__name__}: {e}"
        return None, ShardError(
            shard_id=shard_id, attempts=attempts, error=last_error
        )

    def search(
        self, shard_ids: Sequence[str], request: ShardSearchRequest
    ) -> tuple[ShardSearchResponse, list[ShardError]]:
        # concurrent scatter: latency is the slowest shard (plus its own
        # failover chain), not the sum of per-shard round trips — the
        # reference fans out with one tokio task per shard
        # (shards_query.rs:29-72)
        responses: list[ShardSearchResponse] = []
        errors: list[ShardError] = []
        if len(shard_ids) <= 1:
            results = [self._search_one(s, request) for s in shard_ids]
        else:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(
                max_workers=min(len(shard_ids), 16)
            ) as pool:
                results = list(
                    pool.map(lambda s: self._search_one(s, request), shard_ids)
                )
        for resp, err in results:
            if resp is not None:
                responses.append(resp)
            else:
                if self.strict:
                    raise RuntimeError(
                        f"shard {err.shard_id} unreachable: {err}"
                    )
                errors.append(err)
        return merge_shard_responses(responses, request.top_k), errors
