"""Masked top-k primitives.

Counterpart of ``nucliadb_tpu/ops/topk.py``. Conventions are the same:
scores are "bigger is better"; invalid slots carry ``NEG_INF`` and id
``-1``; ``k`` is a Python int.

Tie order: ``lax.top_k`` puts the lower index first among equal scores.
``torch.topk`` on CUDA promises no order among ties, so the cut is a
stable descending sort followed by a slice.
"""

from __future__ import annotations

import torch

NEG_INF = -3.0e38


def masked_topk(
    scores: torch.Tensor,
    k: int,
    *,
    mask: torch.Tensor | None = None,
    min_score: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis with an optional validity mask and floor.

    Args:
      scores: [..., N] float scores.
      k: number of results.
      mask: optional [..., N] or [N] bool; False entries can never win.
      min_score: optional floor; entries below it are invalidated.

    Returns:
      (top_scores [..., k] f32, top_ids [..., k] int64); invalid slots have
      score ``NEG_INF`` and id ``-1``.
    """
    s = scores.float()
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    if min_score is not None:
        s = torch.where(s >= min_score, s, NEG_INF)
    k_eff = min(k, s.shape[-1])
    top_s, top_i = torch.sort(s, dim=-1, descending=True, stable=True)
    top_s, top_i = top_s[..., :k_eff], top_i[..., :k_eff]
    top_i = torch.where(top_s > NEG_INF / 2, top_i, -1)
    if k_eff < k:
        pad = (*s.shape[:-1], k - k_eff)
        top_s = torch.cat([top_s, top_s.new_full(pad, NEG_INF)], dim=-1)
        top_i = torch.cat([top_i, top_i.new_full(pad, -1)], dim=-1)
    return top_s, top_i


def duplicate_id_mask(ids: torch.Tensor) -> torch.Tensor:
    """[B, C] -> bool [B, C]: True where an id repeats an EARLIER slot in
    the same row (first occurrence stays False; -1 pads never count)."""
    same = ids[:, :, None] == ids[:, None, :]
    c = ids.shape[-1]
    earlier = torch.ones((c, c), dtype=torch.bool, device=ids.device).tril(-1)
    return (same & earlier[None]).any(dim=-1) & (ids >= 0)
