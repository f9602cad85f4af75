"""IVF (inverted-file) vector index: matmul k-means and a blocked int8 probe
scan.

Counterpart of ``nucliadb_tpu/ops/ivf.py`` in torch ops (the JAX package's
are jitted XLA programs, not Pallas kernels). Lloyd's iterations take the
nearest centroid by ``argmax`` (the first maximum, as ``jnp.argmax``) and
sum each cluster with a one-hot product per block, the blocks added in the
JAX package's order; a dead cluster keeps its centroid. Members are laid out
as int8 codes in fixed-size blocks ([NB, blk, D] codes, per-member scales,
an id table; a cluster owns ceil(size / blk) blocks through a [K, MB]
table), and a query reads only the blocks of its ``nprobe`` nearest
clusters, then reranks its candidates exactly against the base arena.

The int8 estimate is exact for every D, as XLA's int32 accumulation is:
the dimensions are split into chunks of at most ``quant.INT8_DOT_BLOCK``,
each chunk's f32 product is an exact integer below 2**24 (TF32 is off), and
the chunks are added in int32. Queries are quantised as ``Int8Codes.encode``
quantises rows (``quant.quantize_rows``: a product with f32(1/127), the
arithmetic of the JAX package's compiled ``/ 127.0``).

``KMEANS`` counts k-means runs (``"kmeans"``) and ``SEARCHES`` probe
searches (``"search"``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.counts import LaunchCounter
from ..utils.platform import device_fetch, thread_stream
from . import quant
from .distance import rerank_scores
from .topk import NEG_INF, masked_topk, top_k

KMEANS_ITERS = 8
DEFAULT_NPROBE = 16
QUERY_CHUNK = 8  # queries per probe step (the JAX package's lax.map chunk)

KMEANS = LaunchCounter()
SEARCHES = LaunchCounter()


def ivf_seed_indices(n_valid: int, k_clusters: int) -> np.ndarray:
    """Seed rows strictly among the valid rows, exactly k_clusters of them
    (modulo indexing when the corpus is smaller than k)."""
    span = max(n_valid, 1)
    stride = max(span // k_clusters, 1)
    return ((np.arange(k_clusters) * stride) % span).astype(np.int32)


def default_clusters(n_valid: int) -> int:
    """The cluster count of a corpus: the power of two at or above its
    square root, at least 16."""
    return max(16, 1 << int(math.ceil(math.log2(math.sqrt(max(n_valid, 1))))))


def _blocks(vectors: torch.Tensor, block: int) -> torch.Tensor:
    """[N_pad, D] -> [NB, blk, D]: halve the block while it is above
    ``block`` and even."""
    n_pad, d = vectors.shape
    blk = n_pad
    while blk > block and blk % 2 == 0:
        blk //= 2
    nb = n_pad // blk
    assert nb * blk == n_pad, (n_pad, blk)
    return vectors.reshape(nb, blk, d)


def _nearest(vb: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    return (vb.float() @ centroids.T).argmax(dim=-1)


def kmeans(
    vectors: torch.Tensor,
    valid: torch.Tensor,
    k_clusters: int,
    iters: int = KMEANS_ITERS,
    block: int = 65536,
    seed_idx: np.ndarray | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means with one-hot product updates.

    ``vectors`` [N_pad, D] (padding rows have ``valid`` False); ``seed_idx``
    [k_clusters] picks the seed rows (default: striding the padded arena).
    Returns (centroids [K, D] f32, assign [N_pad] int64)."""
    thread_stream(vectors.device)
    KMEANS.add("kmeans")
    if seed_idx is None:
        seed_idx = ivf_seed_indices(vectors.shape[0], k_clusters)
    centroids = vectors[torch.as_tensor(seed_idx, device=vectors.device).long()].float()
    vblocks = _blocks(vectors, block)
    wblocks = valid.reshape(vblocks.shape[:2]).float()
    d = vectors.shape[1]
    for _ in range(iters):
        sums = torch.zeros((k_clusters, d), device=vectors.device)
        counts = torch.zeros(k_clusters, device=vectors.device)
        for vb, wb in zip(vblocks, wblocks):
            assign = _nearest(vb, centroids)
            onehot = torch.nn.functional.one_hot(assign, k_clusters).float() * wb[:, None]
            sums = sums + onehot.T @ vb.float()
            counts = counts + onehot.sum(dim=0)
        new_c = sums / counts.clamp_min(1.0)[:, None]
        centroids = torch.where(counts[:, None] > 0, new_c, centroids)
    assign = torch.cat([_nearest(vb, centroids) for vb in vblocks])
    return centroids, assign


def assign_all(vectors: torch.Tensor, centroids: torch.Tensor, block: int = 65536) -> torch.Tensor:
    """Nearest centroid of every row, one blocked pass: the cheap part of
    ``build_ivf`` when the centroids are known (persisted by a segment)."""
    thread_stream(vectors.device)
    return torch.cat([_nearest(vb, centroids.float()) for vb in _blocks(vectors, block)])


@dataclass
class DeviceIVF:
    """The blocked int8 member layout. Exact reranking reads f32 rows from
    the base arena, so nothing is held twice at full precision."""

    centroids: torch.Tensor  # [K, D] f32
    block_codes: torch.Tensor  # [NB, blk, D] int8
    block_scale: torch.Tensor  # [NB, blk] f32 per-member scales
    block_ids: torch.Tensor  # [NB, blk] int64 global ids (-1 pad)
    cluster_blocks: torch.Tensor  # [K, MB] int64 block ids (-1 pad)
    block: int


def _gather_blocks(codes, scale, ids):
    safe = ids.clamp_min(0)
    bc = torch.where((ids >= 0)[:, :, None], codes[safe], 0).to(torch.int8)
    bs = torch.where(ids >= 0, scale[safe], 0.0)
    return bc, bs


def build_ivf(
    vectors: torch.Tensor,
    n_valid: int,
    *,
    k_clusters: int | None = None,
    iters: int = KMEANS_ITERS,
    centroids: torch.Tensor | None = None,
    block: int = 1024,
) -> DeviceIVF:
    """Cluster the arena's first ``n_valid`` rows and lay out the blocked
    int8 member arena (the host assembles only the id tables). With
    ``centroids`` given (persisted by a segment) k-means is skipped and one
    assignment pass runs."""
    dev = vectors.device
    thread_stream(dev)
    n_pad = vectors.shape[0]
    if centroids is not None:
        centroids = centroids.to(dev, torch.float32)
        assign = assign_all(vectors, centroids)
    else:
        if k_clusters is None:
            k_clusters = default_clusters(n_valid)
        valid = torch.arange(n_pad, device=dev) < n_valid
        centroids, assign = kmeans(
            vectors, valid, k_clusters, iters,
            seed_idx=ivf_seed_indices(n_valid, k_clusters),
        )
    k_clusters = centroids.shape[0]

    (assign_np,) = device_fetch(assign)
    assign_np = assign_np[:n_valid]
    order = np.argsort(assign_np, kind="stable")
    sizes = np.bincount(assign_np, minlength=k_clusters)
    # small corpora: one right-sized block per cluster; large: fixed blocks
    # bound the padding and the per-probe gather
    blk = int(min(block, -(-int(max(sizes.max(), 1)) // 8) * 8))

    block_rows: list[np.ndarray] = []
    cluster_block_lists: list[list[int]] = []
    cursor = 0
    for c in range(k_clusters):
        cnt = int(sizes[c])
        members = order[cursor : cursor + cnt]
        cursor += cnt
        blocks_of_c: list[int] = []
        for off in range(0, max(cnt, 1), blk):
            chunk = members[off : off + blk]
            row = np.full(blk, -1, np.int64)
            row[: len(chunk)] = chunk
            blocks_of_c.append(len(block_rows))
            block_rows.append(row)
        cluster_block_lists.append(blocks_of_c)
    mb = max(len(bl) for bl in cluster_block_lists)
    cluster_blocks = np.full((k_clusters, mb), -1, np.int64)
    for c, bl in enumerate(cluster_block_lists):
        cluster_blocks[c, : len(bl)] = bl

    ids = torch.from_numpy(np.stack(block_rows)).to(dev)  # [NB, blk]
    codes = quant.Int8Codes.encode(vectors)
    block_codes, block_scale = _gather_blocks(codes.codes, codes.scale, ids)
    return DeviceIVF(
        centroids=centroids,
        block_codes=block_codes,
        block_scale=block_scale,
        block_ids=ids,
        cluster_blocks=torch.from_numpy(cluster_blocks).to(dev),
        block=blk,
    )


def _int8_bdot(qi: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Exact [c, D] x [c, X, D] int8 dot -> [c, X] int32 (module docstring)."""
    if qi.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("_int8_bdot is exact only with TF32 off")
    out = None
    for d0 in range(0, qi.shape[1], quant.INT8_DOT_BLOCK):
        d1 = d0 + quant.INT8_DOT_BLOCK
        part = torch.bmm(codes[:, :, d0:d1].float(), qi[:, d0:d1, None].float())[:, :, 0]
        part = part.to(torch.int32)
        out = part if out is None else out + part
    return out


def ivf_search(
    ivf: DeviceIVF,
    vectors: torch.Tensor,  # [N_pad, D] f32/bf16 base arena (exact rerank)
    queries: torch.Tensor,  # [B, D]
    node_mask: torch.Tensor,  # [N_pad] bool
    min_score: float,
    k: int,
    nprobe: int = DEFAULT_NPROBE,
    chunk: int = QUERY_CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the ``nprobe`` nearest clusters of each query: int8 block
    scan -> candidate cut -> exact f32 rerank. Queries go ``chunk`` at a
    time, which bounds the gathered blocks to chunk * nprobe * MB * blk * D
    bytes."""
    thread_stream(vectors.device)
    SEARCHES.add("search")
    q = queries.float()
    b, d = q.shape
    qc, _ = quant.quantize_rows(q)

    cscores = q @ ivf.centroids.T  # [B, K]
    nprobe = min(nprobe, cscores.shape[-1])
    _, top_c = top_k(cscores, nprobe)  # [B, P]
    probe_blocks = ivf.cluster_blocks[top_c].reshape(b, -1)  # [B, P * MB]
    g = probe_blocks.shape[1]
    c_budget = min(quant.int8_rerank_budget(k), g * ivf.block)

    chunk = min(chunk, b)
    pad_b = -(-b // chunk) * chunk - b
    if pad_b:
        q = torch.cat([q, q.new_zeros((pad_b, d))])
        qc = torch.cat([qc, qc.new_zeros((pad_b, d))])
        probe_blocks = torch.cat([probe_blocks, probe_blocks.new_full((pad_b, g), -1)])

    out_s, out_i = [], []
    for lo in range(0, b + pad_b, chunk):
        qf, qi, pb = q[lo : lo + chunk], qc[lo : lo + chunk], probe_blocks[lo : lo + chunk]
        cc = qf.shape[0]
        safe_b = pb.clamp_min(0)
        ids = ivf.block_ids[safe_b]  # [c, G, blk]
        raw = _int8_bdot(qi, ivf.block_codes[safe_b].reshape(cc, -1, d)).float()
        est = raw.reshape(ids.shape) * ivf.block_scale[safe_b]
        valid = (pb[:, :, None] >= 0) & (ids >= 0) & node_mask[ids.clamp_min(0)]
        flat_s = torch.where(valid, est, NEG_INF).reshape(cc, -1)
        flat_i = torch.where(valid, ids, -1).reshape(cc, -1)
        top_est, pos = top_k(flat_s, c_budget)
        cand = torch.where(top_est > NEG_INF / 2, flat_i.gather(1, pos), -1)  # [c, C]
        exact = rerank_scores(qf, vectors[cand.clamp_min(0)])
        tks, tpos = masked_topk(exact, k, mask=cand >= 0, min_score=min_score)
        tki = torch.where(tpos >= 0, cand.gather(1, tpos.clamp_min(0)), -1)
        out_s.append(tks)
        out_i.append(torch.where(tks > NEG_INF / 2, tki, -1))
    return torch.cat(out_s)[:b], torch.cat(out_i)[:b]
