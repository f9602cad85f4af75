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

Paragraphs are stored sorted by key, so key-prefix deletions and filters
resolve with two binary searches. Segments written with the "hnsw" or "ivf"
flag also hold a graph or centroids, which the port neither builds nor
reads yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import msgpack
import numpy as np

from ...types import OpenIndexMetadata, SegmentMetadata, Seq
from ...utils.keys import key_prefix_ranges  # noqa: F401  (re-exported)

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
) -> SegmentMetadata:
    """Write an immutable segment from a batch of elems (sorted by key)."""
    unported = {"hnsw", "ivf"} & set(config.flags)
    if unported:
        raise NotImplementedError(
            f"segment build for flags {sorted(unported)} is not ported yet "
            "(ROADMAP.md, Queue 1)"
        )
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
    meta = {
        "format_version": FORMAT_VERSION,
        "records": len(keys),
        "n_vectors": int(vectors.shape[0]),
        "dim": dim,
        "config": config.to_dict(),
        "tags": sorted(tags),
        "has_graph": False,
        "has_ivf": False,
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
    return LoadedSegment(
        path=path,
        config=config,
        vectors=vectors,
        vec_para=vec_para,
        keys=keys,
        labels=labels,
        para_meta=para_meta,
        tags=frozenset(meta.get("tags", [])),
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
) -> SegmentMetadata:
    """Merge operant segments into one, dropping deleted paragraphs
    (``segment::merge``, nidx_vector/src/segment.rs:92-197): a filtered
    concatenation plus a postings rebuild, as the JAX package does. Tags
    are the union of the operants' tags. ``create_segment`` refuses the
    ``hnsw``/``ivf`` flags here too."""
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
    return create_segment(out_path, elems, config, tags=tags)
