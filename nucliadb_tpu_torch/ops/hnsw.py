"""Batched graph ANN: the pruned proximity graph and its masked beam search.

Counterpart of ``nucliadb_tpu/ops/hnsw.py``, with its parameters, its
wave build and its search, in torch ops (the JAX package's are jitted XLA
programs, not Pallas kernels):

- **Upper levels become one matmul**: a sampled entry set (about N/M
  nodes, farthest-point sampled when it is small) is scanned exactly.
- **Construction runs in waves** of 1,024 nodes: one [W, N] similarity
  product gives each node of a wave its exact top-efC candidates among the
  nodes inserted before it, the keep-pruned heuristic runs for the whole
  wave over the [W, C, C] candidate similarities, and the host links the
  edges between waves (``nucliadb_tpu_native.hnsw_link_wave``, or the same
  loop in Python). ``_waves_chunk`` runs 8 waves per call; the build
  queues chunk t+1 before it fetches chunk t.
- **Search is a masked adaptive beam**: at least ``trips`` iterations,
  then more (up to ``max_trips``) while any query of the batch has fewer
  than k mask-passing results. The continue flag is read with
  ``device_fetch`` on the thread's stream, only after ``trips``.

Tie order is ``lax.top_k``'s (``topk.top_k``), ``torch.argmax`` returns
the first maximum as ``jnp.argmax`` does, and the visited table is kept
under the JAX package's threshold with a spare column for -1 pads (a
negative index in a CUDA scatter is a device assert, not a drop), so on
data whose products and sums are exact in f32 the graph and the answers
equal the JAX package's element for element.

``BUILDS`` counts graph builds (``"graph"``) and ``SEARCHES`` counts
searches (``"search"``) and their beam iterations (``"trips"``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.counts import LaunchCounter
from ..utils.platform import device_fetch, resolve_device, thread_stream
from .distance import prepare_query, scores_matmul
from .topk import NEG_INF, duplicate_id_mask, masked_topk, top_k

try:  # native wave linker (native/hnsw_link.cpp); python fallback below
    import nucliadb_tpu_native as _native
except ImportError:
    _native = None


# the JAX package's parameters (nidx_vector/src/hnsw/params.rs: M, M_MAX_0,
# efC; EF_SEARCH 50 for its fixed-trip beam)
M = 30
M_MAX_0 = 60
EF_CONSTRUCTION = 100
EF_SEARCH = 50
SEARCH_TRIPS = 6  # minimum beam iterations
SEARCH_TRIPS_MAX = 24  # cap of the filtered search's extra iterations

# corpora past this size get the wider default regime (ef=100 / 12 trips)
EF_WIDE_THRESHOLD = 200_000
EF_SEARCH_WIDE = 100
SEARCH_TRIPS_WIDE = 12

WAVE = 1024  # nodes per build wave
WAVES_PER_CALL = 8  # waves per _waves_chunk call
VISITED_MAX = 64 * 1024 * 1024  # b * n_pad at or below this keeps the visited table

BUILDS = LaunchCounter()
SEARCHES = LaunchCounter()


def default_search_params(n_nodes: int) -> tuple[int, int]:
    """(ef, min trips) of the default search regime at ``n_nodes``."""
    if n_nodes > EF_WIDE_THRESHOLD:
        return EF_SEARCH_WIDE, SEARCH_TRIPS_WIDE
    return EF_SEARCH, SEARCH_TRIPS


@dataclass
class DeviceHnsw:
    """A device-resident graph: one flat level and an exact-scanned entry
    set. A graph stitched from several segments' graphs has disconnected
    components; ``seg_of`` and ``n_segments`` make the search reserve beam
    slots per component."""

    adj: torch.Tensor  # [N_pad, M_MAX_0] int64 neighbour ids (-1 pad)
    entry_ids: torch.Tensor  # [E] int64 node ids of the entry set
    n_nodes: int
    seg_of: torch.Tensor | None = None  # [N_pad] int64 component of each node
    n_segments: int = 1


# --------------------------------------------------------------------------
# Build
# --------------------------------------------------------------------------


def _wave_candidates(vectors, wave_vecs, inserted_mask, ef):
    """Exact top-ef candidates among inserted nodes for a wave of new nodes."""
    scores = scores_matmul(wave_vecs, vectors)  # [W, N_pad]
    return masked_topk(scores, ef, mask=inserted_mask)


def _heuristic_select(cand_scores, cand_vecs, cand_valid):
    """Keep-pruned-connections selection for a whole wave: walk the
    candidates best first and keep c iff sim(c, q) >= the largest sim(c, k)
    over the already kept k. [W, C] scores, [W, C, D] vectors, [W, C] valid
    -> [W, C] bool kept."""
    cv = cand_vecs.float()
    cc = torch.bmm(cv, cv.transpose(1, 2))  # [W, C, C]
    w, c = cand_scores.shape
    kept = torch.zeros((w, c), dtype=torch.bool, device=cand_scores.device)
    for i in range(c):
        sim_to_kept = torch.where(kept, cc[:, i, :], NEG_INF).amax(dim=-1)
        kept[:, i] = cand_valid[:, i] & (cand_scores[:, i] >= sim_to_kept)
    return kept


def _waves_chunk(vectors, inserted_mask, wave_ids, ef):
    """Candidates and the heuristic for C waves in one call.

    ``inserted_mask`` [N_pad] bool (the nodes inserted before the chunk) is
    updated in place between waves; ``wave_ids`` [C, W] (rows past a wave's
    true length repeat valid ids; the host linker slices them off).
    Returns (cand_ids [C, W, ef] int64, kept [C, W, ef] bool)."""
    cand_all, kept_all = [], []
    for ids in wave_ids:
        cand_s, cand_i = _wave_candidates(vectors, vectors[ids], inserted_mask, ef)
        kept = _heuristic_select(cand_s, vectors[cand_i.clamp_min(0)], cand_i >= 0)
        inserted_mask[ids] = True
        cand_all.append(cand_i)
        kept_all.append(kept)
    return torch.stack(cand_all), torch.stack(kept_all)


def build_graph(
    vectors_np: np.ndarray,
    *,
    vectors_dev: torch.Tensor | None = None,
    device: "str | torch.device" = "cuda",
    m: int = M,
    m_max0: int = M_MAX_0,
    ef_construction: int = EF_CONSTRUCTION,
    wave: int = WAVE,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Construct the pruned proximity graph of the [N, D] host corpus.

    ``vectors_dev`` optionally gives an arena already on the device (padded
    rows past N); otherwise the corpus is uploaded to ``device``. Returns
    (adj [N, m_max0] int32 with -1 padding, entry_ids [E] int32)."""
    n, _ = vectors_np.shape
    if vectors_dev is None:
        dev = resolve_device(device)
        thread_stream(dev)
        vectors_dev = torch.from_numpy(np.ascontiguousarray(vectors_np, dtype=np.float32)).to(dev)
    else:
        thread_stream(vectors_dev.device)
    BUILDS.add("graph")
    n_pad = vectors_dev.shape[0]

    rng = np.random.default_rng(seed)
    order = rng.permutation(n)

    adj = np.full((n, m_max0), -1, dtype=np.int32)
    adj_count = np.zeros(n, dtype=np.int32)
    inserted_mask = np.zeros(n_pad, dtype=bool)

    # the entry set: farthest-point sampled when small (a kNN graph has no
    # cross-cluster edges, so every region needs an entry), random when large
    entry_size = max(min(n, 16), int(math.ceil(n / m)))
    if entry_size <= 256:
        chosen = [int(order[0])]
        min_sim = vectors_np @ vectors_np[chosen[0]]
        for _ in range(entry_size - 1):
            nxt = int(np.argmin(min_sim))
            chosen.append(nxt)
            min_sim = np.maximum(min_sim, vectors_np @ vectors_np[nxt])
        entry_ids = np.sort(np.asarray(chosen, dtype=np.int32))
    else:
        entry_ids = np.sort(order[:entry_size]).astype(np.int32)

    vectors_c = np.ascontiguousarray(vectors_np, dtype=np.float32)

    def link_wave_host(wave_nodes: np.ndarray, cand_ids: np.ndarray, kept: np.ndarray):
        """Forward edges of each row, and reverse edges with a prune at
        m_max0 that keeps the closest."""
        if _native is not None:
            _native.hnsw_link_wave(
                adj, adj_count, vectors_c,
                np.ascontiguousarray(wave_nodes, dtype=np.int32),
                np.ascontiguousarray(cand_ids, dtype=np.int32),
                np.ascontiguousarray(kept, dtype=np.uint8),
                m,
            )
            return
        for row, node in enumerate(wave_nodes):
            node = int(node)
            neigh = cand_ids[row][kept[row].astype(bool)][:m]
            free = m_max0 - adj_count[node]
            take = neigh[:free]
            adj[node, adj_count[node] : adj_count[node] + len(take)] = take
            adj_count[node] += len(take)
            for t in neigh:
                t = int(t)
                if adj_count[t] < m_max0:
                    adj[t, adj_count[t]] = node
                    adj_count[t] += 1
                else:
                    edges = adj[t]
                    sims = vectors_c[edges] @ vectors_c[t]
                    weakest = int(np.argmin(sims))
                    if float(vectors_c[node] @ vectors_c[t]) > sims[weakest]:
                        adj[t, weakest] = node

    # bootstrap: the first wave links to itself densely (no graph yet)
    first = order[: min(wave, n)]
    inserted_mask[first] = True
    pos = len(first)
    if len(first) > 1:
        block = vectors_c[first]
        sims = block @ block.T
        np.fill_diagonal(sims, -np.inf)
        nn = np.argsort(-sims, axis=1)[:, : min(m, len(first) - 1)]
        link_wave_host(
            first.astype(np.int32),
            first[nn].astype(np.int32),
            np.ones(nn.shape, dtype=np.uint8),
        )

    ef = min(ef_construction, n)
    waves = [order[p : p + wave].astype(np.int32) for p in range(pos, n, wave)]
    chunks: list[tuple[list[np.ndarray], np.ndarray]] = []
    for p in range(0, len(waves), WAVES_PER_CALL):
        group = waves[p : p + WAVES_PER_CALL]
        ids = np.stack(
            [np.pad(w, (0, wave - len(w)), mode="edge") if len(w) < wave else w for w in group]
        ).astype(np.int64)
        chunks.append((group, ids))

    def link(prev):
        prev_group, (pc, pk) = prev
        pc, pk = device_fetch(pc, pk)
        for wi, wn in enumerate(prev_group):
            link_wave_host(wn, pc[wi, : len(wn)], pk[wi, : len(wn)])

    # candidates depend only on the vectors and the inserted mask, never on
    # the adjacency: chunk t+1 is queued before chunk t is fetched and linked
    mask_dev = torch.from_numpy(inserted_mask).to(vectors_dev.device)
    prev = None
    for group, ids in chunks:
        ids_dev = torch.from_numpy(ids).to(vectors_dev.device)
        out = _waves_chunk(vectors_dev, mask_dev, ids_dev, ef)
        if prev is not None:
            link(prev)
        prev = (group, out)
    if prev is not None:
        link(prev)
    return adj, entry_ids


# --------------------------------------------------------------------------
# Search
# --------------------------------------------------------------------------


def _dedup_scores(scores: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """NEG_INF-out all but the first occurrence of each id per row."""
    return torch.where(duplicate_id_mask(ids), NEG_INF, scores)


def hnsw_search(
    vectors: torch.Tensor,  # [N_pad, D] arena (padding rows masked out)
    adj: torch.Tensor,  # [N_pad, m_max0] (-1 pad)
    entry_ids: torch.Tensor,  # [E]
    queries: torch.Tensor,  # [B, D]
    node_mask: torch.Tensor,  # [N_pad] bool (alive, filter, not padding)
    min_score: float,
    k: int,
    ef: int = EF_SEARCH,
    trips: int = SEARCH_TRIPS,
    max_trips: int = SEARCH_TRIPS_MAX,
    similarity: str = "dot",
    seg_of: torch.Tensor | None = None,  # [N_pad] component of each node
    n_segments: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked adaptive beam search; returns ([B, k] scores, [B, k] ids).

    Each iteration expands the beam and the best filtered results so far,
    scores every neighbour in one batched product, masks visited and
    filtered slots and keeps the top ``max(ef, k)`` (per component when
    ``n_segments > 1``)."""
    thread_stream(vectors.device)
    SEARCHES.add("search")
    q = prepare_query(queries.float(), similarity)
    b = q.shape[0]
    n_pad = adj.shape[0]
    adj = adj.long()
    entry_ids = entry_ids.long()
    per_seg = max(ef, k)
    beam = per_seg * n_segments
    rows = torch.arange(b, device=q.device)[:, None]

    def seg_topk(all_s, all_i):
        """Top per_seg of each component, concatenated -> [B, beam]."""
        segs = torch.where(all_i >= 0, seg_of[all_i.clamp_min(0)], -1)
        take = min(per_seg, all_s.shape[1])
        pad = per_seg - take
        parts_s, parts_i = [], []
        for s in range(n_segments):
            ts, pos = top_k(torch.where(segs == s, all_s, NEG_INF), take)
            ti = torch.where(ts > NEG_INF / 2, all_i.gather(1, pos), -1)
            if pad:
                ts = torch.cat([ts, ts.new_full((b, pad), NEG_INF)], 1)
                ti = torch.cat([ti, ti.new_full((b, pad), -1)], 1)
            parts_s.append(ts)
            parts_i.append(ti)
        return torch.cat(parts_s, 1), torch.cat(parts_i, 1)

    # entry: exact scan over the entry set
    entry_scores = scores_matmul(q, vectors[entry_ids])  # [B, E]
    if n_segments > 1:
        s0, ids0 = seg_topk(entry_scores, entry_ids[None, :].expand(b, -1))
    else:
        s0, p0 = top_k(entry_scores, min(beam, entry_ids.shape[0]))
        ids0 = entry_ids[p0]
        pad = beam - ids0.shape[1]
        if pad:
            ids0 = torch.cat([ids0, ids0.new_full((b, pad), -1)], 1)
            s0 = torch.cat([s0, s0.new_full((b, pad), NEG_INF)], 1)

    # the visited table, [B, n_pad + 1]: the spare column takes the -1 pads
    use_table = b * n_pad <= VISITED_MAX
    if use_table:
        visited = torch.zeros((b, n_pad + 1), dtype=torch.bool, device=q.device)
        visited[rows, torch.where(ids0 >= 0, ids0, n_pad)] = True

    best_k = max(k, ef)
    init_best_s = torch.where(node_mask[ids0.clamp_min(0)] & (ids0 >= 0), s0, NEG_INF)
    best_s, bpos = top_k(init_best_s, best_k)
    best_i = ids0.gather(1, bpos)
    beam_s, beam_i = s0, ids0

    def body(beam_s, beam_i, best_s, best_i):
        # expand from the unfiltered beam AND the best filtered results so
        # far: under a selective mask the beam alone stays in the unfiltered
        # neighbourhood
        exp_i = torch.cat([beam_i, best_i], 1)
        neigh = torch.where(exp_i[:, :, None] >= 0, adj[exp_i.clamp_min(0)], -1)
        flat = neigh.reshape(b, -1)  # [B, (beam + best_k) * m_max]
        safe_f = flat.clamp_min(0)
        ns = torch.bmm(vectors[safe_f].float(), q[:, :, None])[:, :, 0]
        valid = flat >= 0
        if use_table:
            seen = visited.gather(1, safe_f) & valid
            ns = torch.where(valid & ~seen, ns, NEG_INF)
            visited[rows, torch.where(valid, flat, n_pad)] = True
        else:
            ns = torch.where(valid, ns, NEG_INF)
        all_s = torch.cat([beam_s, ns], 1)
        all_i = torch.cat([beam_i, flat], 1)
        if n_segments > 1:
            top_s, top_i = seg_topk(all_s, all_i)
        else:
            top_s, pos = top_k(all_s, beam)
            top_i = torch.where(top_s > NEG_INF / 2, all_i.gather(1, pos), -1)
        # the best FILTERED results so far: cut the frontier to 2 * best_k,
        # drop repeated ids, keep best_k
        f_s = torch.where(node_mask[all_i.clamp_min(0)] & (all_i >= 0), all_s, NEG_INF)
        c_s, c_pos = top_k(f_s, min(2 * best_s.shape[1], f_s.shape[1]))
        cat_s = torch.cat([best_s, c_s], 1)
        cat_i = torch.cat([best_i, all_i.gather(1, c_pos)], 1)
        bs, bpos = top_k(_dedup_scores(cat_s, cat_i), best_s.shape[1])
        SEARCHES.add("trips")
        return top_s, top_i, bs, cat_i.gather(1, bpos)

    for _ in range(trips):
        beam_s, beam_i, best_s, best_i = body(beam_s, beam_i, best_s, best_i)
    for _ in range(trips, max_trips):
        have_k = (best_s > NEG_INF / 2).sum(1) >= min(k, best_s.shape[1])
        (done,) = device_fetch(have_k.all())
        if done:
            break
        beam_s, beam_i, best_s, best_i = body(beam_s, beam_i, best_s, best_i)

    final_s = _dedup_scores(best_s, best_i)
    final_s = torch.where(final_s >= min_score, final_s, NEG_INF)
    top_s, pos = top_k(final_s, k)
    top_i = torch.where(top_s > NEG_INF / 2, best_i.gather(1, pos), -1)
    return top_s, top_i
