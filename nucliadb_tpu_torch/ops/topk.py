"""Masked top-k primitives.

Counterpart of ``nucliadb_tpu/ops/topk.py``. Conventions are the same:
scores are "bigger is better"; invalid slots carry ``NEG_INF`` and id
``-1``; ``k`` is a Python int.

Tie order: ``lax.top_k`` puts the lower index first among equal scores.
``torch.topk`` on CUDA promises no order among ties. A short axis (or a
``k`` above a sixteenth of it) is cut with a stable descending sort and a
slice. A long axis with a small ``k`` (the BM25 cut, top-20 of a million
documents, where equal tf and length give thousands of equal scores) is
cut without sorting it: ``_select_topk``.
"""

from __future__ import annotations

import torch

NEG_INF = -3.0e38


def _select_topk(s: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k(s, k)`` over the last axis of a 2-D ``s`` in three
    reads of the axis: ``thr``, the k-th largest score of each row, comes
    from ``torch.topk``; every entry above ``thr`` is in any top-k (fewer
    than k are); the entries equal to ``thr`` are taken lowest index first
    by a second ``torch.topk`` over int32 keys ``N - index``. A stable sort
    of those 2k candidates by (score descending, index ascending) gives
    the cut."""
    n = s.shape[-1]
    vals, ids = torch.topk(s, k, dim=-1)
    thr = vals[:, -1:]
    above = vals > thr
    pos = torch.arange(n, 0, -1, dtype=torch.int32, device=s.device)
    key = torch.where(s == thr, pos, torch.zeros((), dtype=torch.int32, device=s.device))
    eq_key, _ = torch.topk(key, k, dim=-1)
    eq_ids = n - eq_key.long()
    cand_s = torch.cat([
        torch.where(above, vals, -torch.inf),
        torch.where(eq_key > 0, thr.expand(-1, k), -torch.inf),
    ], dim=-1)
    cand_i = torch.cat([ids, eq_ids], dim=-1)
    # lower index first among equal scores: order by index, then stably by score
    order = torch.argsort(cand_i, dim=-1, stable=True)
    cand_s, cand_i = cand_s.gather(-1, order), cand_i.gather(-1, order)
    order = torch.argsort(cand_s, dim=-1, descending=True, stable=True)[:, :k]
    return cand_s.gather(-1, order), cand_i.gather(-1, order)


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
      min_score: optional floor (a float, or a tensor broadcasting against
        ``scores``, e.g. [B, 1] per row); entries below it are invalidated.

    Returns:
      (top_scores [..., k] f32, top_ids [..., k] int64); invalid slots have
      score ``NEG_INF`` and id ``-1``.
    """
    s = scores.float()
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    if min_score is not None:
        s = torch.where(s >= min_score, s, NEG_INF)
    n = s.shape[-1]
    k_eff = min(k, n)
    if 0 < k_eff and k_eff * 16 <= n < 2**31:
        top_s, top_i = _select_topk(s.reshape(-1, n), k_eff)
        top_s = top_s.reshape(*s.shape[:-1], k_eff)
        top_i = top_i.reshape(*s.shape[:-1], k_eff)
    else:
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
