"""Per-segment postings builder + disk format for the text engine.

Copy of ``nucliadb_tpu/index/text_engine/builder.py`` (importing that
module imports jax through its package). It writes and reads the same
files: a segment built by either package opens in the other.

Replaces the tantivy single-segment writer (nidx_tantivy/src/lib.rs:40-80
TantivyIndexer) with a numpy CSR build. One segment = one immutable
directory; the searcher consolidates many segments into device arenas.

Layout:
    meta.json               records, total_len, kind, extra
    keys.msgpack            [N] doc keys (sorted — prefix deletions/filters)
    terms.msgpack           [T] terms (sorted)
    postings_offsets.npy    [T+1] int64 into docs/tfs/pos_offsets
    postings_docs.npy       [nnz] int32 (local doc ids, ascending per term)
    postings_tfs.npy        [nnz] uint16 (term frequency, clipped)
    positions_offsets.npy   [nnz+1] int64 into positions
    positions.npy           [npos] int32 (token ordinals)
    dlen.npy                [N] int32 (doc length in tokens)
    facets.msgpack          {facet -> [doc ids]} postings
    attrs.msgpack           [N] small per-doc attribute dicts
    columns.npz             named int64 per-doc columns (created, modified, …)
    stored.bin              optional: per-doc zlib blobs (extracted text,
    stored_off.npy          text-index segments only — parity: tantivy's
                            stored `text` field serving get_fields_text /
                            ExtractedTexts, nidx_text/src/lib.rs:130-240)
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Sequence

import msgpack
import numpy as np

from ...types import SegmentMetadata, Seq
from .tokenizer import tokenize_with_positions

# v2: docs carry /f/{field_type} facets (field-type filters + catalog title
# matching); older segments lack them and need a reindex
TEXT_FORMAT_VERSION = 2

try:  # native postings builder (native/postings.cpp) — same output, ~30x faster
    import nucliadb_tpu_native as _native
except ImportError:
    _native = None


@dataclass
class DocEntry:
    """One document to index: a field (text index) or a paragraph."""

    key: str
    text: str
    facets: list[str] = field(default_factory=list)
    attrs: dict = field(default_factory=dict)
    columns: dict[str, int] = field(default_factory=dict)  # int64 columns


@dataclass
class TextSegmentData:
    """An open (mmap-backed) text segment."""

    path: str
    keys: list[str]
    terms: list[str]
    postings_offsets: np.ndarray
    postings_docs: np.ndarray
    postings_tfs: np.ndarray
    positions_offsets: np.ndarray
    positions: np.ndarray
    dlen: np.ndarray
    facets: dict[str, np.ndarray]
    attrs: list[dict]
    columns: dict[str, np.ndarray]
    tags: frozenset[str] = frozenset()
    meta: dict = field(default_factory=dict)
    stored_off: "np.ndarray | None" = None  # [N+1] int64 into stored.bin

    @property
    def n_docs(self) -> int:
        return len(self.keys)

    @property
    def has_stored_text(self) -> bool:
        return self.stored_off is not None

    def stored_blob(self, doc_id: int) -> bytes:
        """Raw compressed blob for one doc (merge carries these verbatim)."""
        assert self.stored_off is not None
        lo, hi = int(self.stored_off[doc_id]), int(self.stored_off[doc_id + 1])
        with open(os.path.join(self.path, "stored.bin"), "rb") as f:
            f.seek(lo)
            return f.read(hi - lo)

    def stored_text(self, doc_id: int) -> str:
        import zlib

        return zlib.decompress(self.stored_blob(doc_id)).decode("utf-8")

    def key_prefix_mask(self, prefixes: Sequence[str]) -> np.ndarray:
        from ...utils.keys import key_prefix_ranges

        mask = np.zeros(self.n_docs, dtype=bool)
        for lo, hi in key_prefix_ranges(self.keys, prefixes):
            mask[lo:hi] = True
        return mask


def build_segment(
    path: str,
    docs: list[DocEntry],
    *,
    kind: str,
    tags: Sequence[str] = (),
    extra_meta: dict | None = None,
    store_text: bool = False,
) -> SegmentMetadata:
    docs = sorted(docs, key=lambda d: d.key)
    keys = [d.key for d in docs]
    attrs = [d.attrs for d in docs]
    facets: dict[str, list[int]] = {}
    col_names = sorted({name for d in docs for name in d.columns})
    columns = {name: np.zeros(len(docs), dtype=np.int64) for name in col_names}

    for did, doc in enumerate(docs):
        for facet in set(doc.facets):
            facets.setdefault(facet, []).append(did)
        for name, value in doc.columns.items():
            columns[name][did] = value

    if _native is not None:
        terms, off_b, docs_b, tfs_b, poff_b, pos_b, dlen_b = _native.build_postings(
            [d.text for d in docs]
        )
        offsets = np.frombuffer(off_b, np.int64)
        docs_np = np.frombuffer(docs_b, np.int32)
        tfs_np = np.frombuffer(tfs_b, np.uint16)
        pos_offsets_np = np.frombuffer(poff_b, np.int64)
        pos_np = np.frombuffer(pos_b, np.int32)
        dlen = np.frombuffer(dlen_b, np.int32)
    else:
        # term -> {doc -> [positions]}
        term_docs: dict[str, dict[int, list[int]]] = {}
        dlen = np.zeros(len(docs), dtype=np.int32)
        for did, doc in enumerate(docs):
            toks = tokenize_with_positions(doc.text)
            dlen[did] = len(toks)
            for tok, pos in toks:
                term_docs.setdefault(tok, {}).setdefault(did, []).append(pos)
        terms = sorted(term_docs)
        offsets = np.zeros(len(terms) + 1, dtype=np.int64)
        docs_arr: list[int] = []
        tfs_arr: list[int] = []
        pos_offsets: list[int] = [0]
        pos_arr: list[int] = []
        for ti, term in enumerate(terms):
            entries = sorted(term_docs[term].items())
            for did, positions in entries:
                docs_arr.append(did)
                tfs_arr.append(min(len(positions), 65535))
                pos_arr.extend(positions)
                pos_offsets.append(len(pos_arr))
            offsets[ti + 1] = len(docs_arr)
        docs_np = np.asarray(docs_arr, np.int32)
        tfs_np = np.asarray(tfs_arr, np.uint16)
        pos_offsets_np = np.asarray(pos_offsets, np.int64)
        pos_np = np.asarray(pos_arr, np.int32)

    stored = None
    if store_text:
        import zlib

        stored = [zlib.compress(d.text.encode("utf-8"), 1) for d in docs]
    return _write_segment(
        path, keys, list(terms), offsets, docs_np, tfs_np, pos_offsets_np,
        pos_np, dlen, facets, attrs, columns, kind=kind, tags=tags,
        extra_meta=extra_meta, stored=stored,
    )


def _write_segment(
    path, keys, terms, offsets, docs_np, tfs_np, pos_offsets_np, pos_np,
    dlen, facets, attrs, columns, *, kind, tags=(), extra_meta=None,
    stored=None,
) -> SegmentMetadata:
    """Write the on-disk segment layout from final arrays (meta.json last —
    its presence marks the directory complete/immutable)."""
    total_len = int(dlen.sum()) if len(dlen) else 0
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "postings_offsets.npy"), offsets)
    np.save(os.path.join(path, "postings_docs.npy"), docs_np)
    np.save(os.path.join(path, "postings_tfs.npy"), tfs_np)
    np.save(os.path.join(path, "positions_offsets.npy"), pos_offsets_np)
    np.save(os.path.join(path, "positions.npy"), pos_np)
    np.save(os.path.join(path, "dlen.npy"), dlen)
    np.savez(os.path.join(path, "columns.npz"), **columns)
    with open(os.path.join(path, "keys.msgpack"), "wb") as f:
        f.write(msgpack.packb(keys))
    with open(os.path.join(path, "terms.msgpack"), "wb") as f:
        f.write(msgpack.packb(terms))
    with open(os.path.join(path, "facets.msgpack"), "wb") as f:
        f.write(msgpack.packb(facets))
    with open(os.path.join(path, "attrs.msgpack"), "wb") as f:
        f.write(msgpack.packb(attrs, default=str))
    if stored is not None:
        off = np.zeros(len(stored) + 1, dtype=np.int64)
        with open(os.path.join(path, "stored.bin"), "wb") as f:
            for i, blob in enumerate(stored):
                f.write(blob)
                off[i + 1] = off[i] + len(blob)
        np.save(os.path.join(path, "stored_off.npy"), off)
    meta = {
        "records": len(keys),
        "total_len": int(total_len),
        "kind": kind,
        "tags": sorted(tags),
        # bumped when indexed content/facets change shape in a way that
        # needs a reindex (v2 added /f/{field_type} facets); the
        # stale-format migration rolls affected KBs forward
        "format_version": TEXT_FORMAT_VERSION,
        **(extra_meta or {}),
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    return SegmentMetadata(
        path=path, records=len(keys), tags=frozenset(tags), index_metadata=meta
    )


# Open-segment cache: segments are immutable once written (meta.json is the
# last file build_segment writes), so re-opens on every searcher refresh —
# msgpack-unpacking O(corpus) keys/attrs each sync — are pure waste. Keyed
# by (path, meta.json stat) so a rewritten directory is never served stale.
# LRU + periodic dead-path sweep: under sustained ingest, merged-away
# segments get purged from disk but their cache entries pinned mmaps and
# unpacked key/attr lists (a 30-min soak grew RSS to 1.4 GB largely from
# ~1024 retained dead segments); entries whose directory is gone are swept
# every _SWEEP_EVERY inserts.
from collections import OrderedDict as _OrderedDict

_OPEN_CACHE: "_OrderedDict[tuple, TextSegmentData]" = _OrderedDict()
_OPEN_CACHE_MAX = 1024
_SWEEP_EVERY = 32
_open_cache_inserts = 0

import threading as _threading

_OPEN_CACHE_LOCK = _threading.Lock()


def open_text_segment(path: str) -> TextSegmentData:
    global _open_cache_inserts
    meta_path = os.path.join(path, "meta.json")
    st = os.stat(meta_path)
    key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    with _OPEN_CACHE_LOCK:
        hit = _OPEN_CACHE.get(key)
        if hit is not None:
            _OPEN_CACHE.move_to_end(key)
            return hit
    seg = _open_text_segment_uncached(path)
    with _OPEN_CACHE_LOCK:
        _open_cache_inserts += 1
        sweep = _open_cache_inserts % _SWEEP_EVERY == 0
        if sweep:
            dead = [k for k in _OPEN_CACHE if not os.path.exists(k[0])]
            for k in dead:
                del _OPEN_CACHE[k]
        while len(_OPEN_CACHE) >= _OPEN_CACHE_MAX:
            _OPEN_CACHE.popitem(last=False)
        _OPEN_CACHE[key] = seg
    return seg


def _open_text_segment_uncached(path: str) -> TextSegmentData:
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(path, "keys.msgpack"), "rb") as f:
        keys = msgpack.unpackb(f.read())
    with open(os.path.join(path, "terms.msgpack"), "rb") as f:
        terms = msgpack.unpackb(f.read())
    with open(os.path.join(path, "facets.msgpack"), "rb") as f:
        facets_raw = msgpack.unpackb(f.read())
    with open(os.path.join(path, "attrs.msgpack"), "rb") as f:
        attrs = msgpack.unpackb(f.read())
    columns_npz = np.load(os.path.join(path, "columns.npz"))
    stored_off_path = os.path.join(path, "stored_off.npy")
    stored_off = (
        np.load(stored_off_path) if os.path.exists(stored_off_path) else None
    )
    return TextSegmentData(
        stored_off=stored_off,
        path=path,
        keys=keys,
        terms=terms,
        # offset tables load into RAM: the hot host paths (phrase/ematch
        # verification, doc_positions) do scalar indexing, and per-scalar
        # memmap reads were the top host cost in the keyword-find profile;
        # the big postings/positions payloads stay memmap'd
        postings_offsets=np.load(os.path.join(path, "postings_offsets.npy")),
        postings_docs=np.load(os.path.join(path, "postings_docs.npy"), mmap_mode="r"),
        postings_tfs=np.load(os.path.join(path, "postings_tfs.npy"), mmap_mode="r"),
        positions_offsets=np.load(os.path.join(path, "positions_offsets.npy")),
        positions=np.load(os.path.join(path, "positions.npy"), mmap_mode="r"),
        dlen=np.load(os.path.join(path, "dlen.npy")),
        facets={k: np.asarray(v, dtype=np.int32) for k, v in facets_raw.items()},
        attrs=attrs,
        columns={k: columns_npz[k] for k in columns_npz.files},
        tags=frozenset(meta.get("tags", [])),
        meta=meta,
    )


def alive_mask_text(
    segment: TextSegmentData, segment_seq: Seq, deletions: Sequence[tuple[str, Seq]]
) -> np.ndarray:
    """Key-prefix deletions with seq > segment seq (same rule as vector)."""
    mask = np.ones(segment.n_docs, dtype=bool)
    applicable = [key for key, seq in deletions if seq > segment_seq]
    if applicable:
        mask &= ~segment.key_prefix_mask(applicable)
    return mask


def merge_text_segments(out_path, open_index, *, kind: str):
    """Merge text segments at the postings level, fully vectorized.

    Replaces nidx_tantivy's merge (index_reader.rs merge) — same semantics:
    alive docs of all operants, deletions applied by seq, merged doc rows
    re-sorted by key (the prefix-range invariant). No per-posting Python
    loop: a 1M-doc run has ~1e8 postings, which must move as numpy slices,
    not via doc-text reconstruction + re-tokenization (the old path; it
    also collapsed position gaps left by dropped over-long tokens — the
    array merge preserves positions exactly).
    """
    deletions = list(open_index.deletions())
    segs: list[tuple[TextSegmentData, np.ndarray]] = []
    tags: set[str] = set()
    for seg_meta, seq in open_index.segments():
        seg = open_text_segment(seg_meta.path)
        tags |= set(seg.tags)
        segs.append((seg, alive_mask_text(seg, seq, deletions)))

    # ---- global doc order: concat kept docs, then stable-sort by key ----
    all_keys: list[str] = []
    kept_ids_per_seg: list[np.ndarray] = []
    for seg, keep in segs:
        kept = np.flatnonzero(keep)
        kept_ids_per_seg.append(kept)
        all_keys.extend(seg.keys[i] for i in kept)
    n = len(all_keys)
    if n == 0:
        empty_i64 = np.zeros(1, np.int64)
        return _write_segment(
            out_path, [], [], empty_i64, np.zeros(0, np.int32),
            np.zeros(0, np.uint16), empty_i64, np.zeros(0, np.int32),
            np.zeros(0, np.int32), {}, [], {}, kind=kind, tags=tags,
        )
    order = np.argsort(np.asarray(all_keys, dtype=object), kind="stable")
    final_of_concat = np.empty(n, np.int64)
    final_of_concat[order] = np.arange(n)

    # per-segment old-doc-id -> final row
    doc_maps: list[np.ndarray] = []
    base = 0
    for (seg, _), kept in zip(segs, kept_ids_per_seg):
        m = np.full(seg.n_docs, -1, np.int64)
        m[kept] = final_of_concat[base : base + kept.size]
        doc_maps.append(m)
        base += kept.size

    # ---- global term dictionary ----
    term_set: set[str] = set()
    for seg, _ in segs:
        term_set.update(seg.terms)
    terms = sorted(term_set)
    terms_arr = np.asarray(terms, dtype=object)

    # ---- postings: per-segment vector filter/remap, then one lexsort ----
    gterm_parts, gdoc_parts, gtf_parts, glen_parts, gpos_parts = [], [], [], [], []
    for (seg, keep), doc_map in zip(segs, doc_maps):
        if not len(seg.terms):
            continue
        counts = np.diff(seg.postings_offsets)
        term_of_post = np.repeat(np.arange(len(seg.terms)), counts)
        pdocs = np.asarray(seg.postings_docs)
        keep_post = keep[pdocs]
        plens = np.diff(seg.positions_offsets)
        gpos_parts.append(
            np.asarray(seg.positions)[np.repeat(keep_post, plens)]
        )
        remap = np.searchsorted(
            terms_arr, np.asarray(seg.terms, dtype=object)
        )
        gterm_parts.append(remap[term_of_post[keep_post]])
        gdoc_parts.append(doc_map[pdocs[keep_post]])
        gtf_parts.append(np.asarray(seg.postings_tfs)[keep_post])
        glen_parts.append(plens[keep_post])

    if gterm_parts:
        gterm = np.concatenate(gterm_parts)
        gdoc = np.concatenate(gdoc_parts)
        gtf = np.concatenate(gtf_parts)
        glen = np.concatenate(glen_parts).astype(np.int64)
        gpos = np.concatenate(gpos_parts)
        starts = np.concatenate(([0], np.cumsum(glen)[:-1]))
        # (term, doc) pairs are unique (docs disjoint across segments),
        # so the lexsorted stream is the final CSR body
        perm = np.lexsort((gdoc, gterm))
        docs_np = gdoc[perm].astype(np.int32)
        tfs_np = gtf[perm].astype(np.uint16)
        lens_sorted = glen[perm]
        pos_offsets_np = np.concatenate(([0], np.cumsum(lens_sorted)))
        # ragged gather: reorder each posting's position run to sorted order
        total = int(pos_offsets_np[-1])
        gather = (
            np.repeat(starts[perm], lens_sorted)
            + np.arange(total)
            - np.repeat(pos_offsets_np[:-1], lens_sorted)
        )
        pos_np = gpos[gather].astype(np.int32)
        offsets = np.concatenate(
            ([0], np.cumsum(np.bincount(gterm, minlength=len(terms))))
        ).astype(np.int64)
    else:
        docs_np = np.zeros(0, np.int32)
        tfs_np = np.zeros(0, np.uint16)
        pos_offsets_np = np.zeros(1, np.int64)
        pos_np = np.zeros(0, np.int32)
        offsets = np.zeros(len(terms) + 1, np.int64)

    # ---- per-doc payloads, reordered to the final key order ----
    keys_final = [all_keys[i] for i in order]
    dlen = np.concatenate(
        [np.asarray(seg.dlen)[kept] for (seg, _), kept in zip(segs, kept_ids_per_seg)]
    )[order].astype(np.int32) if n else np.zeros(0, np.int32)
    attrs_concat: list[dict] = []
    for (seg, _), kept in zip(segs, kept_ids_per_seg):
        attrs_concat.extend(seg.attrs[i] for i in kept)
    attrs_final = [attrs_concat[i] for i in order]

    # stored extracted text: carry the compressed blobs verbatim (only when
    # every operant has them — mixed means pre-stored-text segments, and a
    # partial map would serve wrong ExtractedTexts answers)
    stored_final = None
    if all(seg.has_stored_text for seg, _ in segs):
        blob_concat: list[bytes] = []
        for (seg, _), kept in zip(segs, kept_ids_per_seg):
            if not kept.size:
                continue
            with open(os.path.join(seg.path, "stored.bin"), "rb") as f:
                data = f.read()
            off = seg.stored_off
            blob_concat.extend(
                data[int(off[i]) : int(off[i + 1])] for i in kept
            )
        stored_final = [blob_concat[i] for i in order]

    facets: dict[str, list[int]] = {}
    for (seg, _), doc_map in zip(segs, doc_maps):
        for facet, dids in seg.facets.items():
            mapped = doc_map[np.asarray(dids, np.int64)]
            mapped = mapped[mapped >= 0]
            if mapped.size:
                facets.setdefault(facet, []).extend(int(x) for x in mapped)
    facets = {k: sorted(v) for k, v in facets.items()}

    col_names = sorted({name for seg, _ in segs for name in seg.columns})
    columns = {name: np.zeros(n, np.int64) for name in col_names}
    for (seg, _), doc_map, kept in zip(segs, doc_maps, kept_ids_per_seg):
        rows = doc_map[kept]
        for name in col_names:
            col = seg.columns.get(name)
            if col is not None:
                columns[name][rows] = np.asarray(col)[kept]

    return _write_segment(
        out_path, keys_final, terms, offsets, docs_np, tfs_np,
        pos_offsets_np, pos_np, dlen, facets, attrs_final, columns,
        kind=kind, tags=tags, stored=stored_final,
    )
