"""Exact similarity scans and the exact rerank.

Counterpart of ``nucliadb_tpu/ops/distance.py``. ``dot`` is the raw inner
product; ``cosine`` assumes stored vectors were L2-normalised at index time
and normalises the query here.

Precision: the JAX package scans at ``Precision.DEFAULT`` (bf16 passes on
the TPU, full f32 on the CPU) and reranks at ``HIGHEST``. The port runs
both in full float32: TF32 is off (``utils/platform.py``), so every f32
product here is an IEEE f32 product whose sums run in cuBLAS's or the CPU
BLAS's order.
"""

from __future__ import annotations

import torch

from ..utils import platform  # noqa: F401  (applies the precision policy)
from .topk import masked_topk

DOT = "dot"
COSINE = "cosine"


def normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / n.clamp_min(eps)


def prepare_query(queries: torch.Tensor, similarity: str) -> torch.Tensor:
    if similarity == COSINE:
        return normalize(queries)
    return queries


def scores_matmul(queries: torch.Tensor, vectors: torch.Tensor) -> torch.Tensor:
    """[B, D] x [N, D] -> [B, N] f32 similarity scores."""
    return queries.float() @ vectors.float().T


def exact_scan_topk(
    queries: torch.Tensor,
    vectors: torch.Tensor,
    k: int,
    *,
    mask: torch.Tensor | None = None,
    min_score: float | None = None,
    similarity: str = DOT,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k scan: ([B, k] scores, [B, k] ids), -1 for empty slots."""
    q = prepare_query(queries.float(), similarity)
    scores = scores_matmul(q, vectors)
    return masked_topk(scores, k, mask=mask, min_score=min_score)


def rerank_scores(q: torch.Tensor, cand_vecs: torch.Tensor) -> torch.Tensor:
    """[B, D] x [B, C, D] -> [B, C] exact f32 dots (the HIGHEST einsum)."""
    return torch.bmm(cand_vecs.float(), q.float()[:, :, None])[:, :, 0]


def exact_rerank(
    queries: torch.Tensor,
    vectors: torch.Tensor,
    candidate_ids: torch.Tensor,
    k: int,
    *,
    min_score: float | None = None,
    similarity: str = DOT,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact rescoring of per-query candidate sets ([B, C] ids, -1 = none),
    cut to top-k."""
    q = prepare_query(queries.float(), similarity)
    ids = candidate_ids.long()
    scores = rerank_scores(q, vectors[ids.clamp_min(0)])
    top_s, pos = masked_topk(scores, k, mask=ids >= 0, min_score=min_score)
    top_ids = torch.gather(ids, -1, pos.clamp_min(0))
    return top_s, torch.where(pos >= 0, top_ids, -1)
