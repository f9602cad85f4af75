"""Host-side rank fusion over string-keyed text blocks.

The port's copy of ``nucliadb_tpu/search/rank_fusion.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity: nucliadb/src/nucliadb/search/search/rank_fusion.py —
ReciprocalRankFusion (k=60, per-source boosts, rank_fusion.py:106-186) and
WeightedCombSum (:188). The device-side RRF (ops/fusion.py) covers the
single-shard fused kernel; this one fuses across indexes and shards where
ids are strings.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

RRF_K = 60  # parity: rank_fusion.py:128


@dataclass
class TextBlock:
    """One retrieval unit entering fusion (a paragraph/sentence range)."""

    block_id: str  # "{rid}/{field}/{start}-{end}"
    score: float
    source: str  # "keyword" | "semantic" | "graph"
    rid: str
    field: str
    start: int
    end: int
    labels: list[str] = field(default_factory=list)
    is_a_match: bool = False  # exact match (ematch)
    fuzzy: bool = False
    split: str = ""
    fused_score: float = 0.0
    sources: set = field(default_factory=set)
    # per-source index scores surviving fusion, for score-history reporting
    # (parity: retrieval.py Scores.history — index scores + fused score)
    source_scores: dict = field(default_factory=dict)


def reciprocal_rank_fusion(
    ranked_lists: dict[str, list[TextBlock]],
    *,
    k: int = RRF_K,
    boosts: Optional[dict[str, float]] = None,
    window: Optional[int] = None,
) -> list[TextBlock]:
    """Fuse ranked lists; fused score = sum of boost/(k + rank)."""
    boosts = boosts or {}
    merged: dict[str, TextBlock] = {}
    for source, blocks in ranked_lists.items():
        boost = boosts.get(source, 1.0)
        for rank, block in enumerate(blocks[: window or len(blocks)]):
            entry = merged.get(block.block_id)
            contribution = boost / (k + rank)
            if entry is None:
                entry = block
                entry.fused_score = 0.0
                merged[block.block_id] = entry
            entry.fused_score += contribution
            entry.sources.add(source)
            entry.source_scores[source] = block.score
            entry.is_a_match = entry.is_a_match or block.is_a_match
    return sorted(merged.values(), key=lambda b: (-b.fused_score, b.block_id))


def weighted_comb_sum(
    ranked_lists: dict[str, list[TextBlock]],
    *,
    weights: Optional[dict[str, float]] = None,
) -> list[TextBlock]:
    """Score-based fusion: fused = sum of weight * normalized score
    (parity: WeightedCombSum, rank_fusion.py:188)."""
    weights = weights or {}
    merged: dict[str, TextBlock] = {}
    for source, blocks in ranked_lists.items():
        if not blocks:
            continue
        w = weights.get(source, 1.0)
        # normalize by |max|: dividing by a NEGATIVE max (possible on
        # unfloored dot-product legs) would flip the source's ordering
        denom = abs(max(b.score for b in blocks)) or 1.0
        for block in blocks:
            entry = merged.get(block.block_id)
            contribution = w * (block.score / denom)
            if entry is None:
                entry = block
                entry.fused_score = 0.0
                merged[block.block_id] = entry
            entry.fused_score += contribution
            entry.sources.add(source)
            entry.source_scores[source] = block.score
            entry.is_a_match = entry.is_a_match or block.is_a_match
    return sorted(merged.values(), key=lambda b: (-b.fused_score, b.block_id))
