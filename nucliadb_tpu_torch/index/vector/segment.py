"""Vector segment disk format: create / open / merge, deletions.

Counterpart of ``nucliadb_tpu/index/vector/segment.py`` (which imports jax
through its package). It reads and writes the same immutable directory of
column files, so a segment written by either package opens in the other:

    meta.json          records, n_vectors, dim, config, format version
    vectors.npy        [Nv, D] f32 (normalized already if cosine)
    vec_para.npy       [Nv] int32 owner paragraph
    keys.msgpack       [P] paragraph keys (sorted)
    labels.msgpack     {label -> [paragraph ids]} postings
    para_meta.msgpack  [P] per-paragraph metadata dicts (position, split, ...)
    hnsw_adj.npy       [P, M_MAX_0] int32 graph (flag "hnsw"), -1 padded
    hnsw_entry.npy     [E] int32 entry set of the graph
    ivf_centroids.npy  [K, D] f32 k-means centroids (flag "ivf")

Paragraphs are stored sorted by key, so key-prefix deletions and filters
resolve with two binary searches. The graph and the centroids are built
once, when the segment is created or merged, on the ``device`` the caller
names, and read back when it opens.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import msgpack
import numpy as np
import torch

from ...types import OpenIndexMetadata, SegmentMetadata, Seq
from ...ops import hnsw, ivf
from ...utils.keys import key_prefix_ranges  # noqa: F401  (re-exported)
from ...utils.platform import device_fetch, resolve_device, thread_stream

from .config import VectorConfig

FORMAT_VERSION = 2


@dataclass
class Elem:
    """One indexable record: a paragraph and its vector(s).

    ``vectors`` is [m, D]; m > 1 only for multivector (MaxSim) configs.
    """

    key: str
    vectors: np.ndarray
    labels: list[str] = field(default_factory=list)
    metadata: dict = field(default_factory=dict)


@dataclass
class LoadedSegment:
    """An open (mmap-backed) segment."""

    path: str
    config: VectorConfig
    vectors: np.ndarray  # [Nv, D] f32
    vec_para: np.ndarray  # [Nv] int32
    keys: list[str]  # [P], sorted
    labels: dict[str, np.ndarray]  # label -> sorted int32 paragraph ids
    para_meta: list[dict]
    tags: frozenset[str] = frozenset()
    # the persisted graph and centroids (None without the flag)
    hnsw_adj: np.ndarray | None = None  # [P, m_max0] int32, -1 padded
    hnsw_entry: np.ndarray | None = None  # [E] int32
    ivf_centroids: np.ndarray | None = None  # [K, D] f32

    @property
    def n_paragraphs(self) -> int:
        return len(self.keys)

    def key_prefix_mask(self, prefixes: Sequence[str]) -> np.ndarray:
        """Boolean [P] mask of paragraphs whose key starts with any prefix."""
        mask = np.zeros(self.n_paragraphs, dtype=bool)
        for lo, hi in key_prefix_ranges(self.keys, prefixes):
            mask[lo:hi] = True
        return mask


def _normalize_rows(v: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(v, axis=-1, keepdims=True)
    return v / np.maximum(norms, 1e-12)


def create_segment(
    path: str,
    elems: list[Elem],
    config: VectorConfig,
    *,
    tags: Iterable[str] = (),
    device: "str | torch.device" = "cuda",
) -> SegmentMetadata:
    """Write an immutable segment from a batch of elems (sorted by key).
    The graph (flag "hnsw") and the k-means centroids (flag "ivf") are
    built on ``device``."""
    elems = sorted(elems, key=lambda e: e.key)
    dim = config.dimension
    keys: list[str] = []
    labels: dict[str, list[int]] = {}
    para_meta: list[dict] = []
    vec_chunks: list[np.ndarray] = []
    vec_para: list[int] = []

    for pid, elem in enumerate(elems):
        keys.append(elem.key)
        para_meta.append(elem.metadata)
        for label in set(elem.labels):
            labels.setdefault(label, []).append(pid)
        v = np.asarray(elem.vectors, dtype=np.float32).reshape(-1, dim)
        vec_chunks.append(v)
        vec_para.extend([pid] * v.shape[0])

    vectors = (
        np.concatenate(vec_chunks, axis=0) if vec_chunks else np.zeros((0, dim), np.float32)
    )
    if config.normalize and vectors.size:
        vectors = _normalize_rows(vectors)

    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "vectors.npy"), vectors)
    np.save(os.path.join(path, "vec_para.npy"), np.asarray(vec_para, dtype=np.int32))
    with open(os.path.join(path, "keys.msgpack"), "wb") as f:
        f.write(msgpack.packb(keys))
    with open(os.path.join(path, "labels.msgpack"), "wb") as f:
        f.write(msgpack.packb(labels))
    with open(os.path.join(path, "para_meta.msgpack"), "wb") as f:
        f.write(msgpack.packb(para_meta))
    # the graph, built once here so that searcher (re)loads stitch it
    single = vectors.shape[0] == len(keys) and len(keys) > 0
    has_graph = "hnsw" in config.flags and single
    if has_graph:
        adj, entry_ids = hnsw.build_graph(vectors, device=device)
        np.save(os.path.join(path, "hnsw_adj.npy"), adj)
        np.save(os.path.join(path, "hnsw_entry.npy"), entry_ids)
    # the k-means centroids (8 Lloyd passes) run once here; an index that
    # opens the segment pays one assignment pass
    has_ivf = "ivf" in config.flags and single
    if has_ivf:
        dev = resolve_device(device)
        thread_stream(dev)
        n = vectors.shape[0]
        n_pad = -(-n // 8) * 8
        padded = np.zeros((n_pad, dim), np.float32)
        padded[:n] = vectors
        k_clusters = ivf.default_clusters(n)
        centroids, _ = ivf.kmeans(
            torch.from_numpy(padded).to(dev),
            torch.arange(n_pad, device=dev) < n,
            k_clusters,
            seed_idx=ivf.ivf_seed_indices(n, k_clusters),
        )
        np.save(os.path.join(path, "ivf_centroids.npy"), device_fetch(centroids)[0])
    meta = {
        "format_version": FORMAT_VERSION,
        "records": len(keys),
        "n_vectors": int(vectors.shape[0]),
        "dim": dim,
        "config": config.to_dict(),
        "tags": sorted(tags),
        "has_graph": has_graph,
        "has_ivf": has_ivf,
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    return SegmentMetadata(
        path=path, records=len(keys), tags=frozenset(tags), index_metadata=meta
    )


def open_segment(path: str) -> LoadedSegment:
    """Open a segment directory with mmap-backed columns."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    config = VectorConfig.from_dict(meta["config"])
    vectors = np.load(os.path.join(path, "vectors.npy"), mmap_mode="r")
    vec_para = np.load(os.path.join(path, "vec_para.npy"), mmap_mode="r")
    with open(os.path.join(path, "keys.msgpack"), "rb") as f:
        keys = msgpack.unpackb(f.read())
    with open(os.path.join(path, "labels.msgpack"), "rb") as f:
        labels_raw = msgpack.unpackb(f.read())
    labels = {k: np.asarray(v, dtype=np.int32) for k, v in labels_raw.items()}
    with open(os.path.join(path, "para_meta.msgpack"), "rb") as f:
        para_meta = msgpack.unpackb(f.read())
    hnsw_adj = hnsw_entry = ivf_centroids = None
    if meta.get("has_graph") and os.path.exists(os.path.join(path, "hnsw_adj.npy")):
        hnsw_adj = np.load(os.path.join(path, "hnsw_adj.npy"), mmap_mode="r")
        hnsw_entry = np.load(os.path.join(path, "hnsw_entry.npy"))
    if meta.get("has_ivf") and os.path.exists(os.path.join(path, "ivf_centroids.npy")):
        ivf_centroids = np.load(os.path.join(path, "ivf_centroids.npy"))
    return LoadedSegment(
        path=path,
        config=config,
        vectors=vectors,
        vec_para=vec_para,
        keys=keys,
        labels=labels,
        para_meta=para_meta,
        tags=frozenset(meta.get("tags", [])),
        hnsw_adj=hnsw_adj,
        hnsw_entry=hnsw_entry,
        ivf_centroids=ivf_centroids,
    )


def alive_mask(
    segment: LoadedSegment,
    segment_seq: Seq,
    deletions: Sequence[tuple[str, Seq]],
) -> np.ndarray:
    """Paragraph alive mask after applying key-prefix deletions: a deletion
    applies iff its seq is strictly greater than the segment's seq;
    deletion keys are prefixes (nidx_vector/src/lib.rs:166-200)."""
    mask = np.ones(segment.n_paragraphs, dtype=bool)
    applicable = [key for key, seq in deletions if seq > segment_seq]
    if applicable:
        mask &= ~segment.key_prefix_mask(applicable)
    return mask


def merge_segments(
    out_path: str,
    open_index: OpenIndexMetadata,
    config: VectorConfig,
    *,
    device: "str | torch.device" = "cuda",
) -> SegmentMetadata:
    """Merge operant segments into one, dropping deleted paragraphs
    (``segment::merge``, nidx_vector/src/segment.rs:92-197): a filtered
    concatenation plus a postings rebuild, as the JAX package does. Tags
    are the union of the operants' tags. A flagged config's graph or
    centroids are built anew on ``device`` by ``create_segment``."""
    deletions = list(open_index.deletions())
    elems: list[Elem] = []
    tags: set[str] = set()
    for seg_meta, seq in open_index.segments():
        seg = open_segment(seg_meta.path)
        tags |= set(seg.tags)
        keep = alive_mask(seg, seq, deletions)
        # paragraph labels: invert postings once for this segment
        para_labels: list[list[str]] = [[] for _ in range(seg.n_paragraphs)]
        for label, pids in seg.labels.items():
            for pid in pids:
                para_labels[pid].append(label)
        # group vectors by paragraph (vec_para is sorted: keys are sorted and
        # vectors were appended in key order)
        first = np.searchsorted(seg.vec_para, np.arange(seg.n_paragraphs), side="left")
        last = np.searchsorted(seg.vec_para, np.arange(seg.n_paragraphs), side="right")
        for pid in np.nonzero(keep)[0]:
            elems.append(
                Elem(
                    key=seg.keys[pid],
                    vectors=np.asarray(seg.vectors[first[pid] : last[pid]]),
                    labels=para_labels[pid],
                    metadata=seg.para_meta[pid],
                )
            )
    return create_segment(out_path, elems, config, tags=tags, device=device)
