"""Plain exact reference of the semantic leg: the top-k eligible rows of a
query by exact similarity, with the reference's duplicate cut, and the
exact score of any row.

Plain PyTorch, with nothing of the program: it takes the benchmark's own
corpus rows and masks (``benchmark/corpus.py``) and works out again what
the program derives from them (the normalised rows, the eligible set). It
runs in full float32 with TF32 off, and scores a row in float64; ``tf32``
turns TF32 on for the control, the same search one precision below.
"""

from __future__ import annotations

import contextlib

import torch

NEG_INF = float("-inf")


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Float32 products in TF32 (``tf32``) or in full float32 inside."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def prepare(x: torch.Tensor, similarity: str) -> torch.Tensor:
    """Rows as the similarity compares them: unit rows for cosine."""
    if similarity == "cosine":
        return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    if similarity != "dot":
        raise ValueError(f"unknown similarity {similarity!r}")
    return x


def _drop_repeats(rows: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``ids`` with -1 where a candidate's vector equals an earlier valid
    candidate's (rows [Q, C, D], ids [Q, C] in rank order)."""
    keep = ids >= 0
    for j in range(1, ids.shape[1]):
        same = (rows[:, :j, :] == rows[:, j : j + 1, :]).all(dim=-1) & keep[:, :j]
        keep[:, j] &= ~same.any(dim=-1)
    return torch.where(keep, ids, -1)


def exact_topk(
    corpus: torch.Tensor,
    queries: torch.Tensor,
    eligible: torch.Tensor,
    k: int,
    similarity: str,
    *,
    tf32: bool = False,
    block_rows: int = 131072,
    block_queries: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact top-k eligible rows of each query.

    corpus [N, D] f32, queries [Q, D] f32, eligible [N] bool, all on one
    device. A candidate whose vector repeats a higher-ranked candidate's
    is dropped (the reference's Fssc cut), from the best 2k + 8. Returns
    ([Q, k] int64 row ids, -1 past the eligible rows; [Q, k] f32 scores)."""
    n = corpus.shape[0]
    k2 = min(2 * k + 8, n)
    out_i, out_s = [], []
    with matmul_precision(tf32):
        for q0 in range(0, queries.shape[0], block_queries):
            q = prepare(queries[q0 : q0 + block_queries].float(), similarity)
            best_s = torch.full((q.shape[0], k2), NEG_INF, device=q.device)
            best_i = torch.full((q.shape[0], k2), -1, dtype=torch.long, device=q.device)
            for lo in range(0, n, block_rows):
                hi = min(n, lo + block_rows)
                s = q @ prepare(corpus[lo:hi].float(), similarity).T
                s = s.masked_fill(~eligible[lo:hi], NEG_INF)
                ids = torch.arange(lo, hi, device=q.device).expand_as(s)
                best_s, pos = torch.cat([best_s, s], 1).topk(k2, dim=1)
                best_i = torch.gather(torch.cat([best_i, ids], 1), 1, pos)
            best_i = torch.where(best_s > NEG_INF, best_i, -1)
            best_i = _drop_repeats(corpus[best_i.clamp_min(0)], best_i)
            best_s = torch.where(best_i >= 0, best_s, NEG_INF)
            top_s, pos = best_s.topk(k, dim=1)
            out_s.append(top_s)
            out_i.append(torch.where(top_s > NEG_INF, torch.gather(best_i, 1, pos), -1))
    return torch.cat(out_i), torch.cat(out_s)


def exact_scores(corpus: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor, similarity: str) -> torch.Tensor:
    """[Q, C] float64 similarity of each query with the rows ``ids``
    ([Q, C], NaN where an id is -1)."""
    rows = prepare(corpus[ids.clamp_min(0)].double(), similarity)
    q = prepare(queries.double(), similarity)
    s = (rows * q[:, None, :]).sum(dim=-1)
    return torch.where(ids >= 0, s, torch.nan)
