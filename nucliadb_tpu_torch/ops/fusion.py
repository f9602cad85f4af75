"""Rank fusion on the device: Reciprocal Rank Fusion over top-k lists.

Counterpart of ``nucliadb_tpu/ops/fusion.py``. The fused score of a
candidate is ``sum over lists of boost / (rrf_k + rank)`` with rrf_k = 60
(the reference's ``rank_fusion.py:106-186``). The mesh hybrid program
fuses its keyword and semantic cuts with it where both share one id space;
the product's /find fuses string-keyed results on the host with the same
formula (``search/rank_fusion.py``).

Equal fused scores are common, not rare: an id at rank r of one list only
and another at rank r of the other list only score exactly the same. The
cut therefore takes ``lax.top_k``'s order through ``topk.top_k``: among
equal scores the earlier candidate position (list a before list b) wins.
"""

from __future__ import annotations

import torch

from .topk import NEG_INF, duplicate_id_mask, top_k

RRF_K = 60.0  # parity: rank_fusion.py:128


def rrf_merge(
    ids_a: torch.Tensor,
    ids_b: torch.Tensor,
    k: int,
    *,
    boost_a: float = 1.0,
    boost_b: float = 1.0,
    rrf_k: float = RRF_K,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fuse two ranked id lists ([B, ka], [B, kb], -1 = empty slot).

    Returns ([B, k] fused scores, [B, k] ids; NEG_INF and -1 past the
    candidates). Ids must share one id space."""
    cand = torch.cat([ids_a, ids_b], dim=-1)  # [B, C]
    dev = cand.device
    rank_a = 1.0 / (rrf_k + torch.arange(ids_a.shape[-1], dtype=torch.float32, device=dev))
    rank_b = 1.0 / (rrf_k + torch.arange(ids_b.shape[-1], dtype=torch.float32, device=dev))

    live = (cand >= 0)[:, :, None]
    in_a = (cand[:, :, None] == ids_a[:, None, :]) & live
    in_b = (cand[:, :, None] == ids_b[:, None, :]) & live
    score = boost_a * torch.where(in_a, rank_a, 0.0).sum(dim=-1)
    score = score + boost_b * torch.where(in_b, rank_b, 0.0).sum(dim=-1)

    # a candidate in both lists shows up twice with the same fused score:
    # only its first occurrence stays
    valid = (cand >= 0) & ~duplicate_id_mask(cand)
    score = torch.where(valid, score, NEG_INF)
    k_eff = min(k, cand.shape[-1])
    top_s, pos = top_k(score, k_eff)
    top_i = torch.gather(cand, -1, pos)
    top_i = torch.where(top_s > NEG_INF / 2, top_i, -1)
    if k_eff < k:  # the documented [B, k] shape
        pad = (cand.shape[0], k - k_eff)
        top_s = torch.cat([top_s, top_s.new_full(pad, NEG_INF)], dim=-1)
        top_i = torch.cat([top_i, top_i.new_full(pad, -1)], dim=-1)
    return top_s, top_i
