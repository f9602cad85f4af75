"""Consolidated BM25 engine on a torch device.

Counterpart of ``nucliadb_tpu/index/text_engine/engine.py``
(``DeviceTextEngine`` and its host half), on an explicit ``device``. The
host half (consolidation, group partition and reuse, tier matrices,
vocabulary, masks, query planning, positions and phrases) is the
reference's, line for line; the device program is ``ops/bm25.py``.

All open segments of one text index consolidate into device arenas, in
GROUPS: every big segment is its own group, the trailing small segments
share one "fresh" group. A group holds **tiered postings** (terms
partitioned by document frequency into padded ``[T_tier, W_tier]``
matrices of docs, tfs and doc lengths; a query gathers its rows and adds
them with one scatter per slot) and a **dense** uint8 tf block for terms
with df above the top tier (stopword-grade terms become elementwise adds).
Per-tier query capacity is adaptive: every planned term is scheduled.

**Incremental refresh**: a group whose segment run is unchanged is reused
as is from ``prev`` (its tensors stay on the device), so a refresh uploads
O(changed groups), and the cached base mask is spliced from the first
changed doc.

Scoring is Lucene/tantivy BM25 (k1=1.2, b=0.75,
idf = ln(1 + (N - df + 0.5)/(df + 0.5))).

Routing is the reference's cost model: scored queries go to the host WAND
tier (``host_tier.py``) when it takes them, otherwise to the device
program; pure filter queries stay on the host.

Not ported yet (ROADMAP.md, Queue 1 items 10 and 15): the legacy
single-arena program ``_bm25_search``/``_bm25_search_batch`` with
``_device_inputs``, ``fixed_caps`` and the solo-group views, which only the
mesh paths reach.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Optional, Sequence

import numpy as np
import torch

from ...query_language import (
    BooleanExpression,
    DateRangeAtom,
    FacetPrefixAtom,
    FieldAtom,
    KeyPrefixAtom,
    KeywordAtom,
    LabelAtom,
    evaluate_bitset,
)
from ...types import Seq
from ...utils.buckets import bucket as _bucket  # shared {2^k, 1.5*2^k} ladder

from ...ops import bm25
from ...ops.bm25 import B, K1
from ...ops.topk import NEG_INF
from ...utils.platform import device_fetch, resolve_device, stream_wait, thread_stream
from .builder import TextSegmentData, alive_mask_text
from .fuzzy import FuzzyIndex
from .tokenizer import tokenize

FUZZY_WEIGHT = 0.7  # score discount for fuzzy-expanded terms
MAX_EXPANSIONS = 50  # fuzzy variants kept per token (Lucene maxExpansions)

TIER_WIDTHS = (32, 128, 512, 2048, 8192, 16384)  # postings padded length per tier
TIER_QUERY_CAP = (32, 32, 16, 8, 4, 4)  # default query terms per tier per query
DENSE_QUERY_CAP = 4
# corpus-adaptive stopword removal: drop non-final query terms present in
# this fraction of documents (min corpus size guards tiny KBs)
STOPWORD_DF_FRACTION = 0.4
STOPWORD_MIN_DOCS = 100
# overlay (incremental-refresh delta) tiers: the delta corpus is small —
# narrow tiers keep the per-refresh upload proportional to the delta's
# postings; df beyond the last width goes to a local dense block
OVERLAY_TIER_WIDTHS = (4, 64, 1024, 8192)
OVERLAY_QUERY_CAP = (16, 8, 4, 4)
OVERLAY_DENSE_CAP = 4
# group-arena structure (the r3 generalization of base+overlay): the open
# segment list partitions into GROUPS — every big segment is its own group,
# the trailing small segments share one "fresh" group (today's overlay
# role). Each group's device arenas (posting tiers with LOCAL doc ids + a
# local dense block) are immutable and REUSED across refreshes while the
# group's segment set is unchanged, so a refresh uploads O(changed groups):
# steady ingest rebuilds only the fresh group, a landed merge rebuilds only
# the merged segment's group. This is the device analogue of the reference
# searcher's incremental per-segment sync + mmap open
# (nidx/src/searcher/sync.rs:57-219 downloads only changed segments).
GROUP_MIN_DOCS = 65536  # a segment at least this big gets its own group
# the fresh group freezes into a standalone group past this size (frozen =
# its already-built arenas are reused as-is; freezing costs nothing). Below
# it, the open small-segment pool re-consolidates per refresh — bounded
# work that keeps the group count (and the device program's layouts) stable
# between freezes instead of growing one group per appended segment
FRESH_FREEZE_DOCS = 32768
MAX_GROUPS = 24  # guard: beyond this, adjacent small groups re-consolidate
OVERLAY_MAX_DOCS = FRESH_FREEZE_DOCS  # legacy alias (tests/docs reference it)
IMPOSSIBLE_REQUIRED = 1_000_000  # AND queries with unknown terms match nothing


# host->device bytes shipped by engine builds (tests assert the incremental
# path's uploads scale with the delta, not the corpus)
UPLOAD_BYTES = 0


def _dput(arr, device: torch.device) -> torch.Tensor:
    global UPLOAD_BYTES
    a = np.ascontiguousarray(arr)
    UPLOAD_BYTES += a.nbytes
    return torch.from_numpy(a).to(device)


@dataclass
class TextQuery:
    """A parsed keyword query against the engine."""

    text: str = ""
    top_k: int = 20
    only_faceted: bool = False  # no text -> pure filter/facet query
    fuzzy: bool = False
    fuzzy_distance: int = 1
    phrases: list[str] = dc_field(default_factory=list)  # quoted phrases (must appear)
    excluded: list[str] = dc_field(default_factory=list)  # -term exclusions
    all_terms: bool = False  # AND semantics (default OR)
    filter: Optional[BooleanExpression] = None
    key_prefixes: Optional[list[str]] = None  # extra doc-key prefix filter
    min_score: Optional[float] = None
    extra_mask: Optional[np.ndarray] = None  # [n_docs] bool, e.g. security


@dataclass(slots=True)
class TextHit:
    # slots: the host WAND tier materializes top-k hit objects per query at
    # ~10k QPS — slotted init measurably beats the dict-backed dataclass
    key: str
    score: float
    doc_id: int
    attrs: dict
    # matched term-row count from the device program (-1 = unknown); a hit with
    # term_count < number-of-query-tokens cannot be an exact match, so the
    # host skips positions verification for it
    term_count: int = -1


class _CountOnly:
    """Stand-in for the matched bitmap when only its sum was downloaded."""

    def __init__(self, count: int, n: int):
        self._count = count
        self._n = n

    def sum(self) -> int:
        return self._count

    def __len__(self) -> int:
        return self._n


class _PendingTextBatch:
    """In-flight batched BM25 search: device buffers dispatched, results not
    yet downloaded. ``finalize()`` downloads (one overlapped device_fetch
    wait for every buffer) and builds the per-query results."""

    __slots__ = ("engine", "queries", "k", "need_matched", "buffers")

    def __init__(self, engine, queries, k, need_matched, *buffers):
        self.engine = engine
        self.queries = queries
        self.k = k
        self.need_matched = need_matched
        self.buffers = buffers

    def finalize(self) -> list:
        return self.engine._finalize_batch(
            self.queries, self.k, self.need_matched, *self.buffers
        )


class _Consolidated:
    """Host-side consolidation of a segment run (pure numpy)."""

    __slots__ = (
        "keys", "attrs", "facet_chunks", "column_chunks", "alive", "dlen",
        "total_len", "terms_sorted", "group_offsets", "pdocs", "ptfs",
        "doc_seg", "n_docs",
    )


def _consolidate(
    segments: Sequence[tuple[TextSegmentData, Seq]],
    deletions: Sequence[tuple[str, Seq]],
    doc_offset0: int,
    seg_idx0: int,
) -> _Consolidated:
    """Remap a run of segments to global term/doc ids. Doc ids start at
    ``doc_offset0``; ``doc_seg`` records (segment idx, doc offset) with
    segment indices starting at ``seg_idx0``.

    Consolidation is pure numpy: per-posting Python loops are a cliff
    (a 1M-doc segment has ~1e8 postings). Per segment we remap its term
    ids to the run dictionary and offset its doc ids; a stable sort by
    term id then groups every term's postings."""
    out = _Consolidated()
    keys: list[str] = []
    attrs: list[dict] = []
    facet_chunks: dict[str, list[np.ndarray]] = {}
    column_chunks: dict[str, list[np.ndarray]] = {}
    alive_chunks: list[np.ndarray] = []
    dlen_chunks: list[np.ndarray] = []
    doc_seg: list[tuple[int, int]] = []
    total_len = 0

    all_terms: set[str] = set()
    for seg, _ in segments:
        all_terms.update(seg.terms)
    terms_sorted = sorted(all_terms)
    term_to_gid = {t: i for i, t in enumerate(terms_sorted)}

    gid_chunks: list[np.ndarray] = []
    doc_chunks: list[np.ndarray] = []
    tf_chunks: list[np.ndarray] = []

    offset = doc_offset0
    for seg_idx, (seg, seq) in enumerate(segments, start=seg_idx0):
        keys.extend(seg.keys)
        attrs.extend(seg.attrs)
        alive_chunks.append(alive_mask_text(seg, seq, deletions))
        dlen_chunks.append(np.asarray(seg.dlen, dtype=np.int32))
        total_len += int(seg.meta.get("total_len", int(np.sum(seg.dlen))))
        for facet, dids in seg.facets.items():
            facet_chunks.setdefault(facet, []).append(dids + offset)
        for name, col in seg.columns.items():
            column_chunks.setdefault(name, []).append(np.asarray(col))
        doc_seg.extend((seg_idx, offset) for _ in range(seg.n_docs))
        po = np.asarray(seg.postings_offsets)
        counts = np.diff(po).astype(np.int64)
        local_gids = np.fromiter(
            (term_to_gid[t] for t in seg.terms), dtype=np.int64, count=len(seg.terms)
        )
        gid_chunks.append(np.repeat(local_gids, counts))
        doc_chunks.append(np.asarray(seg.postings_docs, np.int64) + offset)
        tf_chunks.append(np.asarray(seg.postings_tfs, np.float32))
        offset += seg.n_docs

    if gid_chunks:
        gids = np.concatenate(gid_chunks)
        pdocs = np.concatenate(doc_chunks)
        ptfs = np.concatenate(tf_chunks)
        order = np.argsort(gids, kind="stable")
        gids, pdocs, ptfs = gids[order], pdocs[order], ptfs[order]
        group_counts = np.bincount(gids, minlength=len(terms_sorted))
        group_offsets = np.zeros(len(terms_sorted) + 1, np.int64)
        np.cumsum(group_counts, out=group_offsets[1:])
    else:
        pdocs = np.zeros(0, np.int64)
        ptfs = np.zeros(0, np.float32)
        group_offsets = np.zeros(len(terms_sorted) + 1, np.int64)

    out.keys = keys
    out.attrs = attrs
    out.facet_chunks = facet_chunks
    out.column_chunks = column_chunks
    out.alive = (
        np.concatenate(alive_chunks) if alive_chunks else np.zeros(0, bool)
    )
    out.dlen = (
        np.concatenate(dlen_chunks) if dlen_chunks else np.zeros(0, np.int32)
    )
    out.total_len = total_len
    out.terms_sorted = terms_sorted
    out.group_offsets = group_offsets
    out.pdocs = pdocs
    out.ptfs = ptfs
    out.doc_seg = doc_seg
    out.n_docs = offset - doc_offset0
    return out


class _ArenaGroup:
    """One group's immutable device arenas + host-side column data.

    Doc ids inside the arenas are LOCAL (0..n_docs); the device program biases them
    with the group's runtime offset, so group offsets may shift between
    refreshes (a merge landing upstream) without touching device memory."""

    __slots__ = (
        "sig", "segments", "seg_idx0", "n_docs", "n_pad", "keys", "attrs",
        "doc_seg_local", "facets_local", "columns_local", "dlen_np",
        "total_len", "terms_sorted", "term_info", "tiers_dev", "dense_dev",
        "dl_dev", "widths", "fuzzy",
    )


def _partition_segments(
    segments: Sequence[tuple[TextSegmentData, Seq]],
    prev_groups: "list[_ArenaGroup] | None",
) -> list[list[tuple[TextSegmentData, Seq]]]:
    """Split the open segment list into group runs.

    Policy: reuse the longest in-order prefix-partition of ``prev_groups``
    whose signatures still match; then every remaining big segment is its
    own group; the remaining small segments form the trailing fresh group
    (frozen into its own group once FRESH_FREEZE_DOCS is exceeded — the
    next refresh starts a new fresh group for free)."""
    def seg_sig(s, seq):
        return (s.path, int(seq), s.n_docs)

    # index prev runs by their first segment so an unchanged group is
    # recognized ANYWHERE in the new list (a merge landing upstream shifts
    # later groups' positions; their runs must still reuse)
    prev_runs: dict[tuple, list[_ArenaGroup]] = {}
    for g in prev_groups or []:
        # only FROZEN runs (full-width layout or at/above the freeze bar)
        # are matched for reuse: the open small pool must keep pooling, or
        # every appended segment would become its own group and the device
        # shape set would churn per refresh
        if g.segments and (
            g.widths == TIER_WIDTHS or g.n_docs >= FRESH_FREEZE_DOCS
        ):
            prev_runs.setdefault(g.sig[0], []).append(g)

    runs: list[list[tuple[TextSegmentData, Seq]]] = []
    rest = list(segments)
    cur: list[tuple[TextSegmentData, Seq]] = []
    cur_docs = 0

    def close_cur():
        nonlocal cur, cur_docs
        if cur:
            runs.append(cur)
            cur, cur_docs = [], 0

    i = 0
    while i < len(rest):
        s, seq = rest[i]
        matched = 0
        for g in prev_runs.get(seg_sig(s, seq), []):
            k = len(g.segments)
            if i + k <= len(rest) and g.sig == tuple(
                seg_sig(x, q) for x, q in rest[i : i + k]
            ):
                matched = max(matched, k)
        if matched:
            close_cur()
            runs.append(rest[i : i + matched])
            i += matched
            continue
        # new segments, in order: big ones solo; small ones pool into runs
        # that FREEZE once they reach FRESH_FREEZE_DOCS (boundaries are
        # then stable, so later refreshes reuse them; only the trailing
        # open run rebuilds under steady ingest)
        if s.n_docs >= GROUP_MIN_DOCS:
            close_cur()
            runs.append([(s, seq)])
        else:
            cur.append((s, seq))
            cur_docs += s.n_docs
            if cur_docs >= FRESH_FREEZE_DOCS:
                close_cur()
        i += 1
    if cur or not runs:
        runs.append(cur)
    if len(runs) > MAX_GROUPS:
        # re-consolidate the smallest adjacent pair until under the guard
        while len(runs) > MAX_GROUPS:
            sizes = [sum(s.n_docs for s, _ in r) for r in runs]
            j = min(
                range(len(runs) - 1), key=lambda i: sizes[i] + sizes[i + 1]
            )
            runs[j : j + 2] = [runs[j] + runs[j + 1]]
    return runs


def _build_group(
    run: Sequence[tuple[TextSegmentData, Seq]],
    *,
    solo: bool,
    device: torch.device,
) -> _ArenaGroup:
    """Consolidate one segment run into an immutable arena group.

    Small groups (below GROUP_MIN_DOCS) use the narrow overlay tier widths
    — their per-refresh re-consolidation stays proportional to their size;
    big groups and ``solo`` cold builds use the full widths (solo engines
    must keep the fixed layout the mesh stacker expects). Everything
    inside is LOCAL (doc ids, segment positions); ``seg_idx0`` is assigned
    by the engine on every assembly because positions shift when an
    upstream merge lands."""
    g = _ArenaGroup()
    g.segments = list(run)
    g.sig = tuple((s.path, int(seq), s.n_docs) for s, seq in run)
    g.seg_idx0 = 0
    c = _consolidate(run, (), 0, 0)
    g.n_docs = c.n_docs
    g.keys = c.keys
    g.attrs = c.attrs
    g.doc_seg_local = c.doc_seg
    g.facets_local = {
        f: np.sort(np.concatenate(ch)) for f, ch in c.facet_chunks.items()
    }
    g.columns_local = {n: np.concatenate(ch) for n, ch in c.column_chunks.items()}
    g.total_len = c.total_len
    g.terms_sorted = c.terms_sorted
    g.fuzzy = None

    if g.n_docs < GROUP_MIN_DOCS and not solo:
        g.widths = OVERLAY_TIER_WIDTHS
        g.n_pad = _bucket(max(g.n_docs, 1), minimum=1024)
    else:
        g.widths = TIER_WIDTHS
        g.n_pad = _bucket(max(g.n_docs, 1))
    dlen_p = np.ones(g.n_pad, np.float32)
    dlen_p[: g.n_docs] = np.maximum(c.dlen, 1)
    g.dlen_np = dlen_p
    g.dl_dev = _dput(dlen_p, device)

    tiers_np, term_info, dense_rows = _build_tier_matrices(
        c.terms_sorted, c.group_offsets, c.pdocs, c.ptfs, g.widths, dlen_p
    )
    g.term_info = term_info
    g.tiers_dev = [
        (_dput(d, device), _dput(t, device), _dput(l, device)) for d, t, l in tiers_np
    ]
    g.dense_dev = None
    if dense_rows:
        dense_m = np.zeros(
            (_bucket(len(dense_rows), minimum=1), g.n_pad), np.uint8
        )
        for row, (term, lo, hi, df) in enumerate(dense_rows):
            dense_m[row, c.pdocs[lo:hi]] = np.minimum(c.ptfs[lo:hi], 255).astype(
                np.uint8
            )
            g.term_info[term] = (-1, row, df)
        g.dense_dev = _dput(dense_m, device)
    return g


class _DocSegView:
    """Lazy global-doc -> (segment idx, segment's global doc offset) map.

    Replaces the materialized doc_seg list: groups bake LOCAL pairs once;
    this view adds the group's current offsets at lookup time, so a group
    shifting position (an upstream merge landed) costs nothing."""

    __slots__ = ("_groups", "_offsets", "_n")

    def __init__(self, groups: list[_ArenaGroup], offsets: np.ndarray):
        self._groups = groups
        self._offsets = offsets  # [G+1] int64 dense doc offsets
        self._n = int(offsets[-1])

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, gid: int):
        gi = int(np.searchsorted(self._offsets, gid, side="right")) - 1
        g = self._groups[gi]
        ls, lo = g.doc_seg_local[gid - int(self._offsets[gi])]
        return (g.seg_idx0 + ls, lo + int(self._offsets[gi]))

    def lookup_many(self, gids) -> "list[tuple[int, int]]":
        """Batched __getitem__: ONE searchsorted for the whole id list —
        the per-doc bisect was ~4 µs each and dominated batched phrase /
        exact-match verification over thousands of candidates."""
        gd = np.asarray(gids, np.int64)
        gis = (np.searchsorted(self._offsets, gd, side="right") - 1).tolist()
        offs = self._offsets.tolist()
        groups = self._groups
        out = []
        for gdoc, gi in zip(gd.tolist(), gis):
            g = groups[gi]
            goff = offs[gi]
            ls, lo = g.doc_seg_local[gdoc - goff]
            out.append((g.seg_idx0 + ls, lo + goff))
        return out


class DeviceTextEngine:
    """Consolidated segments of one text index + the BM25 device program.

    ``prev`` (the engine being replaced on a searcher refresh) enables the
    incremental group reuse — see the module docstring. Its groups live on
    its device, so ``prev`` must share ``device``."""

    def __init__(
        self,
        segments: Sequence[tuple[TextSegmentData, Seq]],
        deletions: Sequence[tuple[str, Seq]] = (),
        prev: "DeviceTextEngine | None" = None,
        *,
        device: "str | torch.device" = "cuda",
    ):
        self.device = resolve_device(device)
        if prev is not None and prev.device != self.device:
            raise ValueError(f"prev engine is on {prev.device}, this one on {self.device}")
        thread_stream(self.device)
        self._seg_sig = tuple(
            (s.path, int(seq), s.n_docs) for s, seq in segments
        )
        self._base_mask_dev: torch.Tensor | None = None
        # memoized host postings, keyed by (segment path, term): immutable
        # per segment, so the cache carries across refreshes unconditionally
        self._host_postings_cache: dict = (
            dict(prev._host_postings_cache) if prev is not None else {}
        )
        self._assemble(segments, deletions, prev)
        # searches on other threads' streams read the uploaded groups and
        # the spliced mask once this engine is published
        stream_wait(self.device)

    # ------------------------------------------------------------------
    # build
    # ------------------------------------------------------------------

    # ------------------------------------------------------------------
    # build (group assembly)
    # ------------------------------------------------------------------

    def _assemble(self, segments, deletions, prev) -> None:
        """Partition segments into arena groups, reusing every group of
        ``prev`` whose segment run is unchanged (device uploads scale with
        the CHANGED groups, not the corpus)."""
        prev_groups = prev.groups if prev is not None else None
        runs = _partition_segments(segments, prev_groups)
        prev_by_sig = {g.sig: g for g in (prev_groups or [])}
        solo = len(runs) == 1
        groups: list[_ArenaGroup] = []
        self.reused_groups = 0
        for run in runs:
            sig = tuple((s.path, int(seq), s.n_docs) for s, seq in run)
            g = prev_by_sig.get(sig)
            # any matched group reuses as-is; the only exception is a
            # narrow-layout group becoming SOLO (the legacy single-arena
            # views need the full tier layout)
            if g is not None and not (solo and g.widths != TIER_WIDTHS):
                groups.append(g)
                self.reused_groups += 1
            else:
                groups.append(_build_group(run, solo=solo, device=self.device))
        self.groups = groups

        # positions + dense doc-id offsets (runtime values, never baked
        # into device arenas)
        seg_idx0 = 0
        offsets = np.zeros(len(groups) + 1, np.int64)
        for gi, g in enumerate(groups):
            g.seg_idx0 = seg_idx0
            seg_idx0 += len(g.segments)
            offsets[gi + 1] = offsets[gi] + g.n_docs
        self.group_offsets = offsets
        self.n_docs = int(offsets[-1])
        self.total_len = sum(g.total_len for g in groups)
        # flat segment order follows the GROUP runs (groups may reorder the
        # input: big segments extracted, small ones pooled at the end);
        # doc ids, seg_bounds and doc_seg all live in this order
        self.segments = [seg for g in groups for seg, _ in g.segments]

        # score-space length: bucketed, and every group's dense window
        # [off, off + n_pad) must fit (the window may overlap the NEXT
        # group's docs with zero contributions — harmless — but must not
        # run past the buffer)
        need = max(
            [max(self.n_docs, 1)]
            + [int(offsets[gi]) + g.n_pad for gi, g in enumerate(groups)]
        )
        self.n_pad = _bucket(need)

        # host-side composed columns (O(n_docs) pointer/array concats per
        # refresh, same budget as the old base+overlay concat)
        self.keys = []
        self.attrs = []
        for g in groups:
            self.keys.extend(g.keys)
            self.attrs.extend(g.attrs)
        self.doc_seg = _DocSegView(groups, offsets)
        facets: dict[str, list[np.ndarray]] = {}
        columns: dict[str, list[tuple[int, np.ndarray]]] = {}
        for gi, g in enumerate(groups):
            off = int(offsets[gi])
            for f, ids in g.facets_local.items():
                facets.setdefault(f, []).append(ids + off)
            for name, col in g.columns_local.items():
                columns.setdefault(name, []).append((gi, col))
        self.facets = {f: np.concatenate(ch) for f, ch in facets.items()}
        self.columns = {}
        for name, parts in columns.items():
            by_gi = dict(parts)
            full = [
                by_gi.get(gi, np.zeros(g.n_docs, np.int64))
                for gi, g in enumerate(groups)
            ]
            self.columns[name] = (
                np.concatenate(full) if full else np.zeros(0, np.int64)
            )

        # aliveness: per-segment bisects against the CURRENT deletion list
        # (never baked into the reusable groups)
        alive_chunks = [
            alive_mask_text(seg, seq, deletions)
            for g in groups
            for seg, seq in g.segments
        ]
        self.alive = (
            np.concatenate(alive_chunks) if alive_chunks else np.zeros(0, bool)
        )
        self._rebuild_seg_bounds()

        # cached device base mask: splice from the first changed doc when
        # the previous engine's mask is compatible (same score length)
        if (
            prev is not None
            and prev._base_mask_dev is not None
            and prev.n_pad == self.n_pad
        ):
            prev_mask = prev.base_mask()
            new_mask = self.base_mask()
            diff = np.nonzero(prev_mask != new_mask)[0]
            if diff.size == 0:
                self._base_mask_dev = prev._base_mask_dev
            else:
                lo = int(diff[0])
                self._base_mask_dev = bm25.splice_1d(
                    prev._base_mask_dev, _dput(new_mask[lo:], self.device), lo
                )

    def _rebuild_seg_bounds(self) -> None:
        # per-segment sorted runs of self.keys (prefix bisects must stay
        # within a segment — the concatenation is NOT globally sorted)
        self.seg_bounds: list[tuple[int, int]] = []
        run_lo = 0
        for seg in self.segments:
            self.seg_bounds.append((run_lo, run_lo + seg.n_docs))
            run_lo += seg.n_docs

    # ------------------------------------------------------------------
    # vocabulary
    # ------------------------------------------------------------------

    def fuzzy_expand(self, token: str, distance: int) -> list[str]:
        """Vocabulary terms within edit distance, across every group.

        Expansion is capped at ``MAX_EXPANSIONS`` variants, keeping the
        highest-df neighbors (the intended word behind a typo is almost
        always a common term). Lucene's FuzzyQuery applies the same bound
        (maxExpansions=50); without it an adversarial vocabulary — e.g.
        serial identifiers where every digit substitution is a real term —
        schedules O(neighbors) posting rows per query token and the scored
        posting volume, not the matmul, becomes the device cost."""
        out: list[str] = []
        seen: set[str] = set()
        for g in self.groups:
            if g.fuzzy is None:
                g.fuzzy = FuzzyIndex(g.terms_sorted)
            for t in g.fuzzy.expand(token, distance):
                if t not in seen:
                    seen.add(t)
                    out.append(t)
        if len(out) > MAX_EXPANSIONS:
            exact = [t for t in out if t == token]
            rest = sorted(
                (t for t in out if t != token),
                key=lambda t: -self.term_df(t),
            )
            out = exact + rest[: MAX_EXPANSIONS - len(exact)]
        return out

    def has_term(self, term: str) -> bool:
        return any(term in g.term_info for g in self.groups)

    def term_df(self, term: str) -> int:
        total = 0
        for g in self.groups:
            info = g.term_info.get(term)
            if info is not None:
                total += info[2]
        return total

    def prefix_terms(self, prefix: str, limit: int = 10) -> list[str]:
        """Vocabulary terms starting with ``prefix`` (suggest expansion)."""
        import bisect

        # exclusive bound via last-char increment: a U+FFFF sentinel would
        # exclude terms whose next char is astral-plane (> U+FFFF)
        hi_key = (
            prefix[:-1] + chr(ord(prefix[-1]) + 1)
            if prefix and ord(prefix[-1]) < 0x10FFFF
            else None
        )
        out: list[str] = []
        for g in self.groups:
            terms = g.terms_sorted
            lo = bisect.bisect_left(terms, prefix)
            hi = bisect.bisect_left(terms, hi_key) if hi_key else len(terms)
            out.extend(
                t for t in terms[lo : min(hi, lo + limit)] if t.startswith(prefix)
            )
        return sorted(set(out))[:limit]

    # ------------------------------------------------------------------

    def base_mask(self) -> np.ndarray:
        mask = np.zeros(self.n_pad, dtype=bool)
        mask[: self.n_docs] = self.alive
        return mask

    def base_mask_device(self) -> torch.Tensor:
        if self._base_mask_dev is None:
            mask = _dput(self.base_mask(), self.device)
            stream_wait(self.device)  # other threads' streams read the cache
            self._base_mask_dev = mask
        return self._base_mask_dev

    def idf(self, df: int) -> float:
        return float(np.log(1.0 + (self.n_docs - df + 0.5) / (df + 0.5)))

    def filter_doc_ids(self, expr) -> np.ndarray:
        """Live doc ids matching a boolean filter expression (or all live
        docs when ``expr`` is None) — the stream plane's full-scan
        counterpart of the per-query filter mask (NidxSearcher Paragraphs/
        Documents over StreamRequest, nodereader.proto:506-510)."""
        m = self.alive[: self.n_docs]
        if expr is not None:
            m = m & evaluate_bitset(expr, self.n_docs, self._resolve_atom)
        return np.flatnonzero(m)

    def doc_facets(self) -> list[list[str]]:
        """Inverse facet map (doc -> sorted facets), built per call — stream
        consumers are full scans, so O(postings) once is the right cost."""
        out: list[list[str]] = [[] for _ in range(self.n_docs)]
        for facet in sorted(self.facets):
            for d in self.facets[facet]:
                if d < self.n_docs:
                    out[int(d)].append(facet)
        return out

    def facet_postings(self, facet: str) -> np.ndarray:
        return self.facets.get(facet, np.zeros(0, np.int32))

    def stored_text(self, gid: int) -> "str | None":
        """Stored extracted text of one doc (text-index segments persist the
        field text; parity: tantivy stored `text` field behind
        TextSearcher::get_fields_text, nidx_text/src/lib.rs:130-240)."""
        seg_idx, offset = self.doc_seg[gid]
        seg = self.segments[seg_idx]
        if not seg.has_stored_text:
            return None
        return seg.stored_text(gid - offset)

    def key_prefix_postings(self, prefixes: Sequence[str]) -> np.ndarray:
        from ...utils.keys import key_prefix_ranges

        out = [
            np.arange(lo, hi, dtype=np.int32)
            for lo, hi in key_prefix_ranges(self.keys, prefixes, self.seg_bounds)
        ]
        return np.concatenate(out) if out else np.zeros(0, np.int32)

    def _resolve_atom(self, atom) -> np.ndarray:
        if isinstance(atom, LabelAtom):
            return self.facet_postings(atom.label)
        if isinstance(atom, FacetPrefixAtom):
            prefix = atom.facet.rstrip("/")
            chunks = [
                p
                for f, p in self.facets.items()
                if f == atom.facet or f.startswith(prefix + "/")
            ]
            return np.unique(np.concatenate(chunks)) if chunks else np.zeros(0, np.int32)
        if isinstance(atom, KeyPrefixAtom):
            return self.key_prefix_postings(atom.prefixes)
        if isinstance(atom, FieldAtom):
            return self._field_postings(atom.field_type, atom.field_name)
        if isinstance(atom, KeywordAtom):
            return self._keyword_postings(atom.keyword)
        if isinstance(atom, DateRangeAtom):
            col = self.columns.get(atom.column)
            if col is None or (atom.since is None and atom.until is None):
                # parity: nidx_text produce_date_range_query -> AllQuery
                # when no bound constrains anything
                return np.arange(self.n_docs, dtype=np.int32)
            m = np.ones(self.n_docs, dtype=bool)
            if atom.since is not None:
                m &= col >= atom.since
            if atom.until is not None:
                m &= col <= atom.until
            return np.flatnonzero(m).astype(np.int32)
        raise TypeError(f"unsupported filter atom for text index: {atom!r}")

    def _field_postings(self, field_type: str, field_name: "str | None") -> np.ndarray:
        """Docs whose field id is ``{type}/{name}`` (or any field of
        ``type`` when name is None). Parity: the reference's `/type[/name]`
        field facet term (nidx_text search_query.rs field_key). Built
        lazily from the doc attrs and cached until the overlay refreshes
        (attrs identity changes)."""
        cache = getattr(self, "_field_postings_cache", None)
        if cache is None or cache[0] is not self.attrs:
            by_field: dict[str, list[int]] = {}
            by_type: dict[str, list[int]] = {}
            for i, a in enumerate(self.attrs):
                fid = a.get("field") or (
                    self.keys[i].split("/", 1)[1] if "/" in self.keys[i] else ""
                )
                by_field.setdefault(fid, []).append(i)
                by_type.setdefault(fid.split("/", 1)[0], []).append(i)
            cache = (
                self.attrs,
                {k: np.asarray(v, np.int32) for k, v in by_field.items()},
                {k: np.asarray(v, np.int32) for k, v in by_type.items()},
            )
            self._field_postings_cache = cache
        _, by_field, by_type = cache
        if field_name is None:
            return by_type.get(field_type, np.zeros(0, np.int32))
        return by_field.get(f"{field_type}/{field_name}", np.zeros(0, np.int32))

    def _keyword_postings(self, keyword: str) -> np.ndarray:
        """Docs containing ``keyword`` (tokenized; multi-word = consecutive
        phrase). Parity: nidx_text query_io.rs
        translate_keyword_to_text_query (term / phrase query)."""
        terms = tokenize(keyword)
        if not terms:
            return np.zeros(0, np.int32)
        if len(terms) == 1:
            return self.term_doc_ids(terms[0]).astype(np.int32)
        cand: "np.ndarray | None" = None
        for t in terms:
            ids = self.term_doc_ids(t)
            cand = ids if cand is None else np.intersect1d(cand, ids)
            if cand.size == 0:
                return np.zeros(0, np.int32)
        flags = self.phrase_match_many([int(d) for d in cand], terms)
        return np.asarray(
            [int(d) for d, ok in zip(cand, flags) if ok], np.int32
        )

    def term_doc_ids(self, term: str) -> np.ndarray:
        """Global doc ids containing the exact term (all segments)."""
        out = []
        for seg_idx, (lo, _) in enumerate(self.seg_bounds):
            docs, _base = self._term_postings_host(seg_idx, term)
            if docs is not None and len(docs):
                out.append(np.asarray(docs, np.int64) + lo)
        return np.concatenate(out) if out else np.zeros(0, np.int64)

    def build_mask(self, query: TextQuery) -> np.ndarray:
        mask = self.base_mask()
        if query.filter is not None:
            m = evaluate_bitset(query.filter, self.n_docs, self._resolve_atom)
            mask[: self.n_docs] &= m
        if query.key_prefixes is not None:
            m = np.zeros(self.n_docs, dtype=bool)
            pids = self.key_prefix_postings(query.key_prefixes)
            m[pids] = True
            mask[: self.n_docs] &= m
        if query.extra_mask is not None:
            mask[: self.n_docs] &= query.extra_mask
        # -term exclusions drop matching docs before scoring (the query
        # grammar's Excluded token, nidx_paragraph query_parser/tokenizer.rs;
        # implemented as a hard filter rather than the reference's
        # Should(MustNot) clause — the documented "exclude documents
        # containing the term" semantics)
        for term in query.excluded:
            ids = self.term_doc_ids(term)
            if len(ids):
                mask[ids] = False
        return mask

    # ------------------------------------------------------------------
    # query planning
    # ------------------------------------------------------------------

    def _plan_terms(self, query: TextQuery) -> tuple[list[tuple[str, float]], int]:
        """Resolve query text to weighted terms; returns (terms, n_required)."""
        tokens = tokenize(query.text)
        # stopword-grade term removal (the reference drops static-list stop
        # words from queries, preserving the LAST term for suggest prefixing
        # — query_parser/stop_words.rs:94-110; here the corpus-adaptive
        # analogue: terms in nearly every document carry ~zero idf and only
        # cost capacity). AND queries keep everything: a dropped term would
        # change which documents satisfy "all terms".
        if (
            tokens
            and not query.all_terms
            and self.n_docs >= STOPWORD_MIN_DOCS
        ):
            cutoff = STOPWORD_DF_FRACTION * self.n_docs
            kept = [t for t in tokens[:-1] if self.term_df(t) < cutoff]
            tokens = kept + [tokens[-1]]
        for phrase in query.phrases:
            tokens.extend(tokenize(phrase))
        seen: dict[str, float] = {}
        satisfiable: set[str] = set()
        for tok in tokens:
            if self.has_term(tok):
                satisfiable.add(tok)
                seen[tok] = max(seen.get(tok, 0.0), 1.0)
            if query.fuzzy:
                for cand in self.fuzzy_expand(tok, query.fuzzy_distance):
                    if cand != tok:
                        satisfiable.add(tok)
                        seen.setdefault(cand, FUZZY_WEIGHT)
        if query.all_terms:
            distinct = len(set(tokens))
            # a token with no exact or fuzzy variant makes an AND query
            # unsatisfiable (sentinel bypasses the scheduling clamp). The
            # device count is a LOWER-BOUND filter: every true match has at
            # least one hit per token group, so counts >= len(satisfiable);
            # exactness comes from the host verify_all_terms pass.
            required = (
                IMPOSSIBLE_REQUIRED if len(satisfiable) < distinct else distinct
            )
        else:
            required = min(1, len(seen))
        return sorted(seen.items()), required

    def _tier_group_counts(self) -> list[int]:
        return [len(g.tiers_dev) for g in self.groups]

    def _plan_slots(
        self, terms: list[tuple[str, float]]
    ) -> list[list[tuple[int, float, str]]]:
        """Assign weighted terms to device-program slot groups. Layout (matches the
        caps tuple): every arena group's posting tiers in group order, then
        one dense slot-group per arena group. A term present in several
        groups schedules in each (their doc sets are disjoint); the weight
        carries the GLOBAL idf, so scores add exactly."""
        tier_counts = self._tier_group_counts()
        n_t = sum(tier_counts)
        tier_base = np.concatenate([[0], np.cumsum(tier_counts)])
        slots: list[list[tuple[int, float, str]]] = [
            [] for _ in range(n_t + len(self.groups))
        ]
        for term, weight in terms:
            df = self.term_df(term)
            if df == 0:
                continue
            w = weight * self.idf(df)
            for gi, g in enumerate(self.groups):
                info = g.term_info.get(term)
                if info is None:
                    continue
                tier, row, _ = info
                if tier < 0:
                    slots[n_t + gi].append((row, w, term))
                else:
                    slots[int(tier_base[gi]) + tier].append((row, w, term))
        return slots

    def _default_caps(self) -> tuple[int, ...]:
        caps: list[int] = []
        for g in self.groups:
            caps.extend(
                TIER_QUERY_CAP if g.widths == TIER_WIDTHS else OVERLAY_QUERY_CAP
            )
        for g in self.groups:
            caps.append(
                (DENSE_QUERY_CAP if g.widths == TIER_WIDTHS else OVERLAY_DENSE_CAP)
                if g.dense_dev is not None
                else 0
            )
        return tuple(caps)

    def _caps_for(self, slots, adaptive: bool) -> tuple[int, ...]:
        """Per-group query capacities.

        Adaptive mode sizes each group to the query's actual need, rounded
        to a power of two (min 2) — so long queries score every term AND
        short queries don't pay for the static defaults: every slot costs
        ``width`` gathered and scattered lanes. Power-of-two rounding is the
        reference's bound on its compiled shapes, kept so both packages
        schedule the same slots; the per-group default remains the fixed
        (non-adaptive) layout."""
        defaults = self._default_caps()
        if not adaptive:
            return defaults
        caps = []
        for entries, dflt in zip(slots, defaults):
            n = len(entries)
            if dflt <= 0 or n == 0:
                caps.append(0)
            else:
                caps.append(max(2, 1 << (n - 1).bit_length()))
        return tuple(caps)

    @staticmethod
    def _pack_slots(slots, caps) -> tuple[np.ndarray, np.ndarray, set]:
        """Lay slot groups into the flat rows/idfs arrays; overflowing terms
        drop lowest-weight first (only possible in fixed-caps mode)."""
        rows = np.full(sum(caps), -1, np.int32)
        idfs = np.zeros(sum(caps), np.float32)
        scheduled: set[str] = set()
        off = 0
        for entries, cap in zip(slots, caps):
            kept = sorted(entries, key=lambda e: -e[1])[:cap]
            for j, (row, w, term) in enumerate(kept):
                rows[off + j] = row
                idfs[off + j] = w
                scheduled.add(term)
            off += cap
        return rows, idfs, scheduled

    def _params_for(
        self, required: int, scheduled: set, query: TextQuery
    ) -> np.ndarray:
        # all_terms queries clamp `required` to the terms actually scheduled:
        # fixed caps can drop the lowest-idf terms, and an unclamped
        # requirement could exceed the maximum achievable match count (zero
        # results for documents that DO contain every term)
        if required >= IMPOSSIBLE_REQUIRED:
            required_eff = IMPOSSIBLE_REQUIRED  # unsatisfiable AND stays so
        else:
            required_eff = max(min(required, len(scheduled)), 1)
        return np.array(
            [
                self.avgdl,
                float(required_eff),
                NEG_INF if query.min_score is None else query.min_score,
            ],
            dtype=np.float32,
        )

    @property
    def avgdl(self) -> float:
        return float(self.total_len) / max(self.n_docs, 1) if self.n_docs else 1.0

    def _device_inputs_planned(
        self,
        terms: list[tuple[str, float]],
        required: int,
        query: TextQuery,
        *,
        adaptive: bool = True,
    ):
        """(rows, idfs, params, caps) numpy inputs for one scored query."""
        slots = self._plan_slots(terms)
        caps = self._caps_for(slots, adaptive)
        rows, idfs, scheduled = self._pack_slots(slots, caps)
        params = self._params_for(required, scheduled, query)
        return rows, idfs, params, caps

    def _group_tensors(self):
        """Device-program operands: per group (tiers, dense block, dlen)."""
        return tuple(
            (tuple(g.tiers_dev), g.dense_dev, g.dl_dev) for g in self.groups
        )

    def _offsets(self) -> tuple[int, ...]:
        """Each group's first doc id in the score space."""
        return tuple(int(o) for o in self.group_offsets[:-1])

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------

    def search(
        self, query: TextQuery, *, need_matched: bool = True,
        need_total: bool = True,
    ) -> tuple[list[TextHit], np.ndarray]:
        """Run a query; returns (hits, matched bitmap over global docs).

        The bitmap feeds host-side facet counting and date ordering; callers
        that only need the match count pass ``need_matched=False`` and get a
        sum-only proxy (avoids downloading n_pad bytes per search).
        ``need_total=False`` additionally skips computing the count at all
        (the /find path never reads the paragraph total) — the proxy then
        carries -1.
        """
        scored = bool(query.text.strip() or query.phrases)
        if scored:
            # cost-model routing (the text analogue of EXACT_SCAN_THRESHOLD):
            # scored queries — OR via WAND, AND via the required-count
            # evaluator — go to the host WAND tier when it wins; see
            # host_tier.py for the measured regime map; results identical
            tier = self.host_tier()
            if tier is not None:
                res = tier.search(
                    query, need_matched=need_matched, need_total=need_total
                )
                if res is not None:
                    hits, matched_np = res
                    if query.all_terms and query.fuzzy and query.text.strip():
                        # same exact-AND tail as the device path below
                        hits = [
                            h for h in hits
                            if self.verify_all_terms(h.doc_id, query)
                        ]
                    return hits, matched_np
        unfiltered = (
            query.filter is None and query.key_prefixes is None
            and query.extra_mask is None and not query.excluded
        )
        # build the host mask only when a filter needs it: for the common
        # unfiltered scored query the device program takes the cached device base
        # mask, and an eager build here wasted O(n_docs) host work per query
        mask = None if unfiltered else self.build_mask(query)

        if not scored:
            # pure filter query: matched = mask; order by key
            if mask is None:
                mask = self.build_mask(query)
            matched = mask[: self.n_docs].copy()
            dids = np.nonzero(matched)[0][: query.top_k]
            hits = [
                TextHit(key=self.keys[d], score=0.0, doc_id=int(d), attrs=self.attrs[d])
                for d in dids
            ]
            return hits, matched

        terms, required = self._plan_terms(query)
        if not terms:
            return [], np.zeros(self.n_docs, dtype=bool)

        rows_np, idfs_np, params_np, caps = self._device_inputs_planned(
            terms, required, query
        )
        dev = self.device
        thread_stream(dev)
        all_rows = torch.from_numpy(rows_np).to(dev)
        all_idfs = torch.from_numpy(idfs_np).to(dev)
        params = torch.from_numpy(params_np).to(dev)
        mask_t = self.base_mask_device() if unfiltered else torch.from_numpy(mask).to(dev)

        k = min(query.top_k, self.n_pad)
        top_s, top_ic, matched = bm25.bm25_groups(
            self._group_tensors(), self._offsets(),
            mask_t, all_rows, all_idfs, params, k, caps,
            tuple(self._tier_group_counts()), bool(query.all_terms),
        )
        if need_matched:
            # all three output buffers fetch behind ONE device wait
            top_s, top_ic, matched_full = device_fetch(top_s, top_ic, matched)
            matched_np = matched_full[: self.n_docs]
        elif need_total:
            # only the count comes back, not the ~n_pad-byte bitmap
            top_s, top_ic, count = device_fetch(top_s, top_ic, matched.sum())
            matched_np = _CountOnly(int(count), self.n_docs)
        else:
            top_s, top_ic = device_fetch(top_s, top_ic)
            matched_np = _CountOnly(-1, self.n_docs)
        top_i, top_counts = top_ic[:k], top_ic[k:]

        if query.only_faceted:
            # facets-only: the matched set reflects the query, hits are not
            # materialized (parity: only_faceted skips result building)
            return [], matched_np

        hits = [
            TextHit(key=self.keys[d], score=float(s), doc_id=int(d),
                    attrs=self.attrs[d], term_count=int(c))
            for s, d, c in zip(top_s, top_i, top_counts)
            if d >= 0
        ]
        if query.all_terms and query.fuzzy and query.text.strip():
            # device counts are a superset test under fuzzy (variants of one
            # token can satisfy another token's requirement) — exact AND
            # verification happens host-side on the top-k only; the matched
            # bitmap stays the (slightly over-inclusive) device set
            hits = [h for h in hits if self.verify_all_terms(h.doc_id, query)]
        return hits, matched_np

    def hits_from_cut(
        self, query: TextQuery, top_s: np.ndarray, top_ic: np.ndarray, k: int
    ) -> list[TextHit]:
        """Materialize TextHits from an externally-run device cut (the mesh
        text group path): ``top_ic`` is the packed [k ids | k counts] array
        of a BM25 program. Applies the same host-side all_terms
        verification as ``search``."""
        top_i, top_counts = top_ic[:k], top_ic[k:]
        hits = [
            TextHit(key=self.keys[d], score=float(s), doc_id=int(d),
                    attrs=self.attrs[d], term_count=int(c))
            for s, d, c in zip(top_s, top_i, top_counts)
            if d >= 0
        ]
        if query.all_terms and query.fuzzy and query.text.strip():
            hits = [h for h in hits if self.verify_all_terms(h.doc_id, query)]
        return hits

    _HOST_TIER_UNSET = object()

    def host_tier(self):
        """The cost-model host WAND tier, or None (see host_tier.py)."""
        cached = getattr(self, "_host_tier_cached", self._HOST_TIER_UNSET)
        if cached is self._HOST_TIER_UNSET:
            from .host_tier import host_tier_for

            cached = self._host_tier_cached = host_tier_for(self)
        return cached

    def search_batch(
        self, queries: list[TextQuery], *, need_matched: bool = True,
        need_total: bool = True,
    ) -> list[tuple[list[TextHit], np.ndarray]]:
        """Score a batch of keyword queries in ONE device dispatch.

        All queries share top_k (the max of the batch is used) and the
        elementwise-max caps layout. Pure-filter queries are not batchable
        (no scoring) and raise.

        When every query is unfiltered, ONE shared [n_pad] base mask feeds
        the whole batch — no per-query mask upload.
        ``need_matched=False`` downloads only per-query match counts instead
        of [B, n_pad] bitmaps (the count-only discipline of ``search``).
        """
        tier = self.host_tier()
        if tier is not None and queries:
            out = [
                tier.search(q, need_matched=need_matched, need_total=need_total)
                for q in queries
            ]
            if all(r is not None for r in out):
                result = []
                for q, (hits, matched) in zip(queries, out):
                    if q.all_terms and q.fuzzy and q.text.strip():
                        hits = [
                            h for h in hits
                            if self.verify_all_terms(h.doc_id, q)
                        ]
                    result.append((hits, matched))
                return result
        pending = self.dispatch_batch(queries, need_matched=need_matched)
        return pending.finalize() if pending is not None else []

    def dispatch_batch(
        self, queries: list[TextQuery], *, need_matched: bool = True
    ) -> "Optional[_PendingTextBatch]":
        """The async half of ``search_batch``: plan + upload + dispatch the
        device program, return a pending handle whose device buffers are
        still in flight. ``finalize()`` downloads and builds results. The
        split lets a hybrid batcher dispatch the BM25 and vector programs
        back-to-back and wait once for both."""
        if not queries:
            return None
        if any(not (q.text.strip() or q.phrases) for q in queries):
            raise ValueError("search_batch requires scored (non-empty) queries")
        unfiltered = all(
            q.filter is None and q.key_prefixes is None and q.extra_mask is None
            and not q.excluded
            for q in queries
        )
        k, caps, rows, idfs, params = self.plan_batch(queries)
        dev = self.device
        thread_stream(dev)
        if unfiltered:
            masks_in = self.base_mask_device()
        else:
            masks_in = torch.from_numpy(np.stack([self.build_mask(q) for q in queries])).to(dev)
        top_s, top_ic, matched = bm25.bm25_groups_batch(
            self._group_tensors(), self._offsets(), masks_in,
            torch.from_numpy(rows).to(dev), torch.from_numpy(idfs).to(dev),
            torch.from_numpy(params).to(dev), k, caps,
            tuple(self._tier_group_counts()),
            shared_mask=unfiltered, count_only=not need_matched,
            with_counts=any(q.all_terms for q in queries),
        )
        return _PendingTextBatch(
            self, list(queries), k, need_matched, top_s, top_ic, matched
        )

    def plan_batch(self, queries: list[TextQuery]):
        """Host planning of a scored batch: (k, caps, rows [B, sum(caps)]
        int32, idfs [B, sum(caps)] f32, params [B, 3] f32). All queries
        share k (the batch's largest top_k) and the elementwise-max caps."""
        k = min(max(q.top_k for q in queries), self.n_pad)
        planned = [self._plan_terms(q) for q in queries]
        slots_list = [self._plan_slots(terms) for terms, _ in planned]
        caps_list = [self._caps_for(s, adaptive=True) for s in slots_list]
        caps = tuple(
            max(c[i] for c in caps_list) for i in range(len(caps_list[0]))
        )
        rows, idfs, params = [], [], []
        for slots, (terms, required), q in zip(slots_list, planned, queries):
            r, w, scheduled = self._pack_slots(slots, caps)
            rows.append(r)
            idfs.append(w)
            params.append(self._params_for(required, scheduled, q))
        return (
            k, caps, np.stack(rows), np.stack(idfs),
            np.stack(params).astype(np.float32),
        )

    def _finalize_batch(
        self, queries, k, need_matched, top_s, top_ic, matched
    ) -> list[tuple[list[TextHit], np.ndarray]]:
        # one device wait for all output buffers
        top_s, top_ic, matched = device_fetch(top_s, top_ic, matched)
        top_i, top_counts = top_ic[:, :k], top_ic[:, k:]
        if need_matched:
            matched_rows = list(matched[:, : self.n_docs])
        else:
            matched_rows = [_CountOnly(int(c), self.n_docs) for c in matched]
        out = []
        for b, query in enumerate(queries):
            hits = [
                TextHit(
                    key=self.keys[d], score=float(s), doc_id=int(d),
                    attrs=self.attrs[d], term_count=int(c),
                )
                for s, d, c in zip(
                    top_s[b][: query.top_k], top_i[b][: query.top_k],
                    # device counts tally SCHEDULED term rows; OR queries may
                    # have stopword-dropped tokens, so a real count can sit
                    # below the caller's distinct-token bar on a true exact
                    # match — only all_terms queries (which schedule every
                    # token) may trust counts as an ematch pruner; OR hits
                    # carry the -1 "unknown, verify" sentinel
                    top_counts[b][: query.top_k] if query.all_terms
                    else [-1] * query.top_k,
                )
                if d >= 0
            ]
            if query.all_terms and query.fuzzy and query.text.strip():
                hits = [h for h in hits if self.verify_all_terms(h.doc_id, query)]
            out.append((hits, matched_rows[b]))
        return out

    # ------------------------------------------------------------------
    # positions (host) for phrase verification
    # ------------------------------------------------------------------

    def _term_postings_host(self, seg_idx: int, term: str):
        """(docs array in RAM, postings base offset) for one segment term,
        memoized — ematch/phrase verification hits the same few query terms
        for every scored hit, and re-bisecting + re-slicing the memmap per
        hit was a top host cost in the keyword-find profile."""
        seg = self.segments[seg_idx]
        cache = self._host_postings_cache
        key = (seg.path, term)
        entry = cache.get(key)
        if entry is None:
            import bisect
            ti = bisect.bisect_left(seg.terms, term)
            if ti >= len(seg.terms) or seg.terms[ti] != term:
                entry = (None, 0)
            else:
                lo, hi = int(seg.postings_offsets[ti]), int(seg.postings_offsets[ti + 1])
                entry = (np.asarray(seg.postings_docs[lo:hi]), lo)
            if len(cache) > 4096:
                cache.clear()
            cache[key] = entry
        return entry

    def doc_positions(self, global_doc: int, term: str) -> np.ndarray:
        """Token positions of ``term`` in one document (host, mmap reads)."""
        seg_idx, offset = self.doc_seg[global_doc]
        seg = self.segments[seg_idx]
        local = global_doc - offset
        docs, lo = self._term_postings_host(seg_idx, term)
        if docs is None:
            return np.zeros(0, np.int32)
        j = np.searchsorted(docs, local)
        if j >= len(docs) or docs[j] != local:
            return np.zeros(0, np.int32)
        plo = int(seg.positions_offsets[lo + j])
        phi = int(seg.positions_offsets[lo + j + 1])
        return np.asarray(seg.positions[plo:phi])

    def doc_has_term(self, global_doc: int, term: str) -> bool:
        """Membership test via the per-segment CSR postings (host)."""
        seg_idx, offset = self.doc_seg[global_doc]
        local = global_doc - offset
        docs, _ = self._term_postings_host(seg_idx, term)
        if docs is None:
            return False
        j = np.searchsorted(docs, local)
        return bool(j < len(docs) and docs[j] == local)

    def _token_variant_groups(self, query: TextQuery) -> list[list[str]]:
        """Per distinct query token: the token + its fuzzy expansions."""
        groups: dict[str, list[str]] = {}
        for tok in tokenize(query.text):
            if tok in groups:
                continue
            variants = [tok] if self.has_term(tok) else []
            if query.fuzzy:
                variants.extend(
                    c for c in self.fuzzy_expand(tok, query.fuzzy_distance)
                    if c != tok
                )
            groups[tok] = variants
        return list(groups.values())

    def verify_all_terms(self, global_doc: int, query: TextQuery) -> bool:
        """Exact AND semantics: every query token must match via itself or
        one of ITS OWN fuzzy variants. The device program's match count is a
        superset test (two variants of one token can reach the required
        count), so all_terms hits re-verify here before they surface."""
        for variants in self._token_variant_groups(query):
            if not variants:
                return False
            if not any(self.doc_has_term(global_doc, v) for v in variants):
                return False
        return True

    def phrase_match_many(
        self, global_docs: Sequence[int], phrase_terms: list[str]
    ) -> list[bool]:
        """Consecutive-phrase membership for many docs in one pass. Uses the
        native GIL-free verifier (native/phrase.cpp) when built; falls back
        to per-doc ``phrase_match``."""
        if not phrase_terms:
            return [True] * len(global_docs)
        try:
            import nucliadb_tpu_native as _native
        except ImportError:
            return [self.phrase_match(d, phrase_terms) for d in global_docs]

        out = [False] * len(global_docs)
        # group by segment: postings arrays and position CSRs are per-segment
        pairs = self.doc_seg.lookup_many(global_docs)
        by_seg: dict[int, list[int]] = {}
        for i, (seg_idx, _off) in enumerate(pairs):
            by_seg.setdefault(seg_idx, []).append(i)
        for seg_idx, idxs in by_seg.items():
            seg = self.segments[seg_idx]
            offset = pairs[idxs[0]][1]
            term_docs = []
            term_lo = []
            missing = False
            for term in phrase_terms:
                docs, lo = self._term_postings_host(seg_idx, term)
                if docs is None:
                    missing = True
                    break
                term_docs.append(np.ascontiguousarray(docs, np.int32))
                term_lo.append(lo)
            if missing:
                continue
            locals_i64 = np.asarray(
                [global_docs[i] - offset for i in idxs], np.int64
            )
            flags = _native.phrase_match_batch(
                locals_i64, term_docs, term_lo,
                np.ascontiguousarray(seg.positions_offsets, np.int64),
                np.ascontiguousarray(seg.positions, np.int32),
            )
            for pos, i in enumerate(idxs):
                out[i] = flags[pos] == 1
        return out

    def phrase_match(self, global_doc: int, phrase_terms: list[str]) -> bool:
        """True if the terms appear consecutively in the document."""
        if not phrase_terms:
            return True
        positions = self.doc_positions(global_doc, phrase_terms[0])
        current = set(positions.tolist())
        for step, term in enumerate(phrase_terms[1:], start=1):
            nxt = set((self.doc_positions(global_doc, term) - step).tolist())
            current &= nxt
            if not current:
                return False
        return bool(current)


# --------------------------------------------------------------------------
# tier construction (host numpy)
# --------------------------------------------------------------------------


def _build_tier_matrices(terms_sorted, group_offsets, pdocs, ptfs, widths, dl):
    """Partition terms into df tiers and lay their postings into padded
    [T, width] matrices (vectorized: no per-posting python).

    ``dl`` is the per-GLOBAL-doc length array (min 1): each posting's doc
    length is materialized alongside its tf so the device program's BM25 norm reads
    it with the same contiguous row gather as the tf — a per-posting
    ``dlen[doc]`` random gather per posting costs a latency-bound access
    (latency-bound, like scatters), which dominated the batched program.

    Returns (tiers_np, term_info, dense_rows): ``tiers_np`` is a list of
    (docs int32 [T,W], tfs float32 [T,W], dls float32 [T,W]); ``term_info``
    maps term -> (tier idx local to this set, row, df); ``dense_rows``
    lists (term, lo, hi, df) posting ranges for terms with df beyond the
    last width — the caller materializes those as dense tf columns."""
    dfs = np.diff(group_offsets)
    tier_idx = np.searchsorted(np.asarray(widths), dfs, side="left")

    term_info: dict[str, tuple[int, int, int]] = {}
    tiers_np: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    for tier, width in enumerate(widths):
        gids_t = np.nonzero(tier_idx == tier)[0]
        if not len(gids_t):
            # a [1,1] placeholder keeps gathers well-formed without
            # uploading a full-width dummy row
            tiers_np.append(
                (
                    np.full((1, 1), -1, np.int32),
                    np.zeros((1, 1), np.float32),
                    np.ones((1, 1), np.float32),
                )
            )
            continue
        # bucket the row count (the reference's shared shape ladder, kept
        # for the same layout); the minimum scales inversely with width so
        # skipping the small rungs costs a bounded ~1 MB of padding per tier
        t = _bucket(len(gids_t), minimum=max(1, 4096 // width))
        docs_m = np.full((t, width), -1, np.int32)
        tfs_m = np.zeros((t, width), np.float32)
        dls_m = np.ones((t, width), np.float32)
        if len(gids_t):
            lengths = dfs[gids_t]
            total = int(lengths.sum())
            excl = np.concatenate([[0], np.cumsum(lengths)[:-1]])
            within = np.arange(total) - np.repeat(excl, lengths)
            dst = np.repeat(np.arange(len(gids_t)) * width, lengths) + within
            src = np.repeat(group_offsets[gids_t], lengths) + within
            docs_m.reshape(-1)[dst] = pdocs[src]
            tfs_m.reshape(-1)[dst] = ptfs[src]
            dls_m.reshape(-1)[dst] = dl[pdocs[src]]
            for row, gid in enumerate(gids_t):
                term_info[terms_sorted[gid]] = (tier, row, int(dfs[gid]))
        tiers_np.append((docs_m, tfs_m, dls_m))

    dense_rows = [
        (
            terms_sorted[gid],
            int(group_offsets[gid]),
            int(group_offsets[gid + 1]),
            int(dfs[gid]),
        )
        for gid in np.nonzero(tier_idx == len(widths))[0]
    ]
    return tiers_np, term_info, dense_rows
