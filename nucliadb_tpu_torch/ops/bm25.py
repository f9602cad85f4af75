"""BM25 group program: the device half of the keyword leg, in PyTorch.

Counterparts of the XLA programs of ``nucliadb_tpu/index/text_engine/engine.py``:
``_tier_contrib`` (:1616), ``_bm25_groups_core`` (:1756), ``_bm25_groups``
(:1855), ``_bm25_groups_batch`` (:1866) and ``_splice_1d`` (:118). They are
jitted XLA code in the JAX package, not Pallas kernels, so here they are
torch ops; none has a hand-written kernel.

The program is written batched: query ``b`` owns row ``b`` of a
``[B, L + 1]`` score buffer, and a single query is a batch of one. Per
query, as in the reference:

1. ``gather_weights``: each posting tier of each group gathers the
   ``[cap, W]`` rows the query scheduled (docs, tfs and per-posting doc
   lengths), weighs them ``idf * tf (K1 + 1) / (tf + K1 (1 - B + B dl /
   avgdl))`` and biases the group-local doc ids by the group's offset;
2. ``scatter_postings``: the weights are added into the score row, and
   (``with_counts``) one hit per lane into a count row;
3. ``add_dense_columns``: the dense uint8 tf columns of stopword-grade
   terms add elementwise into each group's window ``[off, off + n_pad_g)``;
4. ``cut``: ``matched = (counts >= required | score > 0) & mask``, the
   masked top-k with the query's ``min_score``, and ``[k ids | k counts]``.

Two things differ from the reference in how, not in what:

- **Out-of-range ids.** The reference sends padding (-1) and empty slots
  to ``L`` and drops them with ``mode="drop"``. Torch's ``index_add_``
  raises on such an id on the CPU and faults on the card, so here they go
  to column ``L``, a sink that is sliced off.
- **Determinism.** One scatter-add of every lane would run as atomics in
  no fixed order on the card, and a request could come back with other
  last bits from one call to the next (``SearchAfter`` compares scores
  across requests). Here the scatter runs one slot at a time: a slot is
  one term's posting row within one group, for each query, so its doc ids
  are distinct and no two lanes meet at an address but the sink. Slots add
  in the reference's concatenation order (group, tier, slot), which is
  also the order XLA's sequential scatter sums them in on the CPU.
"""

from __future__ import annotations

import torch

from ..utils.counts import LaunchCounter
from .topk import NEG_INF, masked_topk

K1 = 1.2
B = 0.75

# device-program dispatches by entry point ("single", "batch"): shows
# which route served a request (the host WAND tier dispatches nothing)
DISPATCHES = LaunchCounter()


def splice_1d(arr: torch.Tensor, delta: torch.Tensor, start: int) -> torch.Tensor:
    """A copy of ``arr`` with ``delta`` written from ``start`` (the
    reference's ``dynamic_update_slice``: the previous engine keeps
    ``arr``)."""
    out = arr.clone()
    out[start : start + delta.shape[0]] = delta
    return out


def tier_contrib(docs_m, tfs_m, dls_m, rows, idfs, avgdl):
    """One tier's postings for a batch of queries.

    ``rows`` [Q, c] (-1: empty slot) and ``idfs`` [Q, c] select and weigh
    rows of the tier's ``[T, W]`` docs/tfs/dls matrices; ``avgdl`` is [Q].
    Returns (local doc ids [Q, c, W], weights [Q, c, W], valid [Q, c, W]);
    invalid lanes (padding or an empty slot) weigh 0."""
    safe_rows = rows.clamp_min(0).long()
    d = docs_m[safe_rows]
    tf = tfs_m[safe_rows]
    dl = dls_m[safe_rows]
    norm = tf * (K1 + 1.0) / (tf + K1 * (1.0 - B + B * dl / avgdl[:, None, None]))
    valid = (d >= 0) & (rows >= 0)[:, :, None]
    w = torch.where(valid, idfs[:, :, None] * norm, 0.0)
    return d, w, valid


def _slot_starts(caps) -> list[int]:
    starts = [0]
    for c in caps:
        starts.append(starts[-1] + c)
    return starts


def gather_weights(groups, offsets, rows, idfs, avgdl, caps, tier_counts, L):
    """Every scheduled tier slot's lanes, in (group, tier) order: a list of
    (score-space ids [Q, c, W] int64 with invalid lanes at the sink ``L``,
    weights [Q, c, W], valid [Q, c, W])."""
    starts = _slot_starts(caps)
    parts = []
    ti = 0
    for gi, (tiers, _dense, _dl) in enumerate(groups):
        for docs_m, tfs_m, dls_m in tiers:
            lo, hi = starts[ti], starts[ti + 1]
            ti += 1
            if hi == lo:
                continue
            d, w, valid = tier_contrib(docs_m, tfs_m, dls_m, rows[:, lo:hi], idfs[:, lo:hi], avgdl)
            ids = torch.where(valid, d.long() + offsets[gi], L)
            parts.append((ids, w, valid))
    return parts


def scatter_postings(parts, n_queries: int, L: int, with_counts: bool, device):
    """Scores (and hit counts) [Q, L + 1] from the gathered lanes; column
    ``L`` is the sink. One ``index_add_`` per slot, in order (see the
    module docstring: distinct ids within a slot make it deterministic)."""
    scores = torch.zeros((n_queries, L + 1), dtype=torch.float32, device=device)
    counts = torch.zeros_like(scores) if with_counts else None
    base = torch.arange(n_queries, device=device)[:, None] * (L + 1)
    for ids, w, valid in parts:
        for j in range(ids.shape[1]):
            idx = (ids[:, j] + base).reshape(-1)
            scores.view(-1).index_add_(0, idx, w[:, j].reshape(-1))
            if with_counts:
                counts.view(-1).index_add_(0, idx, valid[:, j].reshape(-1).float())
    return scores, counts


def add_dense_columns(scores, counts, groups, offsets, rows, idfs, avgdl, caps, tier_counts):
    """Adds each group's dense (stopword-grade) slots into its window of
    ``scores`` [Q, L] (and of ``counts``), in place. Columns past the
    group's live docs carry tf 0, so a window overlapping the next group's
    docs adds nothing there."""
    n_t = sum(tier_counts)
    starts = _slot_starts(caps)
    n_q = scores.shape[0]
    for gi, (_tiers, dense, dl_g) in enumerate(groups):
        lo, hi = starts[n_t + gi], starts[n_t + gi + 1]
        if dense is None or hi == lo:
            continue
        np_g = dense.shape[1]
        off = offsets[gi]
        if off + np_g > scores.shape[1]:
            raise ValueError(f"dense window [{off}, {off + np_g}) runs past the score space {scores.shape[1]}")
        x = K1 * (1.0 - B + B * dl_g / avgdl[:, None])
        gscore = torch.zeros((n_q, np_g), dtype=torch.float32, device=scores.device)
        gcount = torch.zeros_like(gscore) if counts is not None else None
        for j in range(lo, hi):
            row = rows[:, j]
            tf = dense[row.clamp_min(0).long()].float()
            norm = tf * (K1 + 1.0) / (tf + x)
            active = (row >= 0)[:, None] & (tf > 0)
            gscore += torch.where(active, idfs[:, j, None] * norm, 0.0)
            if gcount is not None:
                gcount += active.float()
        scores[:, off : off + np_g] += gscore
        if counts is not None:
            counts[:, off : off + np_g] += gcount


def cut(scores, counts, mask, required, min_score, k: int):
    """(top scores [Q, k], [k ids | k counts] [Q, 2k], matched [Q, L]).
    ``mask`` is [L] (shared) or [Q, L]; ``required`` and ``min_score`` are
    [Q]. Without counts the hit counts are -1 ("unknown")."""
    if counts is not None:
        matched = (counts >= required.clamp_min(1.0)[:, None]) & mask
    else:
        # every scored posting weighs > 0, so score > 0 <=> a term hit
        matched = (scores > 0.0) & mask
    final = torch.where(matched, scores, NEG_INF)
    top_s, top_i = masked_topk(final, k, min_score=min_score[:, None])
    if counts is not None:
        top_counts = counts.gather(1, top_i.clamp_min(0)).long()
    else:
        top_counts = torch.full_like(top_i, -1)
    return top_s, torch.cat([top_i, top_counts], dim=1), matched


def _program(groups, offsets, masks, rows, idfs, params, k, caps, tier_counts, with_counts):
    n_t = sum(tier_counts)
    if len(caps) != n_t + len(groups):
        raise ValueError(f"caps {caps} do not match {n_t} tiers and {len(groups)} groups")
    avgdl, required, min_score = params[:, 0], params[:, 1], params[:, 2]
    L = masks.shape[-1]
    parts = gather_weights(groups, offsets, rows, idfs, avgdl, caps, tier_counts, L)
    scores, counts = scatter_postings(parts, rows.shape[0], L, with_counts, masks.device)
    scores = scores[:, :L]
    counts = counts[:, :L] if counts is not None else None
    add_dense_columns(scores, counts, groups, offsets, rows, idfs, avgdl, caps, tier_counts)
    return cut(scores, counts, masks, required, min_score, k)


def bm25_groups(groups, offsets, mask, all_rows, all_idfs, params, k, caps, tier_counts, with_counts=True):
    """One query: ``mask`` [L] bool, ``all_rows``/``all_idfs`` [sum(caps)],
    ``params`` [3] (avgdl, required, min_score). Returns (top scores [k],
    [k ids | k counts] [2k], matched [L])."""
    DISPATCHES.add("single")
    top_s, top_ic, matched = _program(
        groups, offsets, mask, all_rows[None], all_idfs[None], params[None],
        k, caps, tier_counts, with_counts,
    )
    return top_s[0], top_ic[0], matched[0]


def bm25_groups_batch(
    groups, offsets, masks, all_rows, all_idfs, params, k, caps, tier_counts,
    *, shared_mask: bool = False, count_only: bool = False, with_counts: bool = True,
):
    """B queries in one program. ``masks`` is one shared [L] mask
    (``shared_mask``) or [B, L]; ``count_only`` returns [B] match counts
    instead of the [B, L] bitmaps; ``with_counts`` runs the hit-count
    scatter (AND semantics)."""
    if shared_mask != (masks.dim() == 1):
        raise ValueError(f"shared_mask={shared_mask} with masks of shape {tuple(masks.shape)}")
    DISPATCHES.add("batch")
    top_s, top_ic, matched = _program(
        groups, offsets, masks, all_rows, all_idfs, params, k, caps, tier_counts, with_counts,
    )
    if count_only:
        return top_s, top_ic, matched.sum(dim=-1)
    return top_s, top_ic, matched
