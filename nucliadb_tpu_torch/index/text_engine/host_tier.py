"""Host WAND tier: cost-model-routed CPU scoring for keyword queries.

Copy of ``nucliadb_tpu/index/text_engine/host_tier.py``, bound to the
port's engine; the routing, the environment switches and the results are
the reference's. The reference's docstring gives the measurements behind
the routing; they were taken for the TPU build of the device program, and
this card's crossover between the two routes is not measured yet (PERF.md).

WHAT: scored OR queries run through native/bm25_wand.cpp's multi-cursor
evaluator straight off the per-segment memmapped CSR (builder.py
postings_*.npy) — no consolidated copy, no device upload.
Deletions/filters/security arrive as the same host mask
``DeviceTextEngine.build_mask`` produces for the device program; scores
use the same BM25 constants, idf, fuzzy weights and avgdl, so hits equal
the device program's within float rounding. The corpus-wide matched
count/bitmap the callers need for totals/facets comes from a union pass
over the same cursors (device parity: ``matched = score>0 & mask``).

AND (all_terms) queries run here too: bm25_wand_req_multi extends the WAND
pivot with the required-count condition — a doc qualifies only when at
least ``required`` cursors land on it, exactly the device program's
``counts >= required`` gate — and the matched set comes from a per-doc
count pass (bm25_count_multi), up to AND_HOST_MAX_POSTINGS scheduled
postings; a heavier conjunction goes to the device program. The engine
applies the same host verify_all_terms tail to the tier's top-k as to the
device program's.

WHAT STAYS ON DEVICE: pure-filter queries (the engine's host filter path
serves those without any device program), AND queries above
AND_HOST_MAX_POSTINGS, a batch in which any query falls out of the tier,
and corpora above NDBTPU_TEXT_HOST_TIER_MAX_DOCS (default 16M).
NDBTPU_TEXT_HOST_TIER=0 disables the tier, =1 forces it (test use).

One subtlety: the device program's dense (stopword-grade) columns clip tf
at 255 (engine.py dense_m build); segments store uint16 — a document
repeating one stopword more than 255 times scores slightly HIGHER here
(the host value is the exact one). Each route keeps its own side.
"""

from __future__ import annotations

import bisect
import os
import threading
from typing import TYPE_CHECKING, Optional

import numpy as np

from .tokenizer import tokenize

if TYPE_CHECKING:  # pragma: no cover
    from .engine import DeviceTextEngine, TextHit, TextQuery

try:
    import nucliadb_tpu_native as _native

    _HAS_WAND = hasattr(_native, "bm25_wand_multi")
except Exception:  # pragma: no cover
    _native = None
    _HAS_WAND = False

# the reference's cap (measured there against the TPU program, not on this
# card): the host tier stays the default through the log-merge top bucket
# of 10M docs/segment (nidx/src/settings.rs:247-255); the cap is a guard
# for pathological segments, not a crossover
DEFAULT_MAX_DOCS = 16_000_000

# AND (required-count) routing by postings volume: a conjunction of
# high-df terms fully scores every candidate reaching the count bar, so
# the host cost scales with the scheduled postings while the device
# program's counts-scatter cost is corpus-shaped. The reference's cap
# (its crossover against the TPU program); above it AND queries go to the
# device program.
AND_HOST_MAX_POSTINGS = int(
    os.environ.get("NDBTPU_TEXT_AND_HOST_MAX_POSTINGS", 65536) or 0
)


def host_tier_for(engine: "DeviceTextEngine") -> "Optional[HostTextTier]":
    """Build (or refuse) the host tier for one engine instance."""
    flag = os.environ.get("NDBTPU_TEXT_HOST_TIER", "").strip()
    if flag == "0" or not _HAS_WAND or engine.n_docs == 0:
        return None
    if flag != "1" and engine.n_docs > int(
        os.environ.get("NDBTPU_TEXT_HOST_TIER_MAX_DOCS", DEFAULT_MAX_DOCS)
    ):
        return None
    try:
        return HostTextTier(engine)
    except Exception:  # unexpected layout: the device program always works
        import logging

        logging.getLogger(__name__).warning(
            "host text tier unavailable; using the device program",
            exc_info=True,
        )
        return None


class HostTextTier:
    def __init__(self, engine: "DeviceTextEngine"):
        from .engine import B, IMPOSSIBLE_REQUIRED, K1, TextHit, _CountOnly

        # bound once: the per-query `from .engine import ...` cost ~1-2 µs
        # at the tier's ~10k QPS operating point
        self._TextHit = TextHit
        self._CountOnly = _CountOnly
        self._IMPOSSIBLE = IMPOSSIBLE_REQUIRED
        self.engine = engine
        self._k1 = float(K1)
        n = engine.n_docs
        seg_lens = [len(seg.dlen) for seg in engine.segments]
        if sum(seg_lens) != n:
            raise ValueError("segment dlen sum != n_docs")
        dl = np.empty(n, np.float32)
        pos = 0
        for seg, m in zip(engine.segments, seg_lens):
            dl[pos : pos + m] = seg.dlen
            pos += m
        dl = np.maximum(dl, 1.0)
        self.seg_offsets = np.concatenate(
            [[0], np.cumsum(seg_lens)]
        ).astype(np.int64)
        self.dl_norm = np.ascontiguousarray(
            1.0 - B + B * dl / max(engine.avgdl, 1e-9), np.float32
        )
        self._alive_u8 = np.ascontiguousarray(
            engine.alive[:n].astype(np.uint8)
        )
        # term -> cursor list. Segment CSRs are immutable for this tier's
        # lifetime (a refresh builds a new engine, hence a new tier), so a
        # term's cursors never change. Profiled: the per-term Python walk
        # over every segment (bisect + memmap slicing) dominated /find at
        # ~19 ms/query on a many-segment corpus; cached terms skip it all.
        # LRU: a vocab-heavy workload evicts one stale term per insert
        # instead of paying a wholesale rebuild spike at the cap.
        from collections import OrderedDict

        self._cursor_cache: "OrderedDict[str, list]" = OrderedDict()
        self._cursor_lock = threading.Lock()

    def _seg_maxtf(self, si: int, seg) -> np.ndarray:
        """Per-term max tf-saturation for one segment (WAND upper bounds),
        computed ONCE in C++ over the whole CSR and cached on the SEGMENT
        object — open segments are reused across engine refreshes, so a
        steady-state sync never recomputes a landed segment's bounds."""
        cached = getattr(seg, "_wand_maxtf", None)
        avgdl = float(self.engine.avgdl)  # dl_norm (so the bounds) depend on
        if cached is None or cached[0] != avgdl:  # the ENGINE-wide avgdl
            off = int(self.seg_offsets[si])
            dl_local = np.ascontiguousarray(
                self.dl_norm[off : off + len(seg.dlen)]
            )
            arr = np.frombuffer(
                _native.bm25_max_tfnorm(
                    np.ascontiguousarray(seg.postings_offsets, np.int64),
                    np.ascontiguousarray(seg.postings_tfs, np.uint16),
                    dl_local,
                    np.ascontiguousarray(seg.postings_docs, np.int32),
                    self._k1,
                ),
                np.float32,
            )
            cached = seg._wand_maxtf = (avgdl, arr)
        return cached[1]

    _CURSOR_CACHE_CAP = 262_144  # bounded by live vocabulary

    def _bundle(self, term: str):
        """Everything the evaluator needs for one term, in one cached
        lookup: (doc buffer list, tf buffer list, offsets list, max-tfnorm
        list, idf) — the buffers are views straight into the memmapped CSR
        and the idf is engine-wide, so the whole bundle is immutable for
        the tier's lifetime. The cache is shared across threads (the
        native evaluator releases the GIL), so entries publish only AFTER
        they are fully built, and eviction is per-entry LRU under a lock —
        never a wholesale clear."""
        with self._cursor_lock:
            out = self._cursor_cache.get(term)
            if out is not None:
                self._cursor_cache.move_to_end(term)
                return out
        engine = self.engine
        doc_bufs: list = []
        tf_bufs: list = []
        offs: list = []
        mts: list = []
        for si, seg in enumerate(engine.segments):
            terms = seg.terms
            ti = bisect.bisect_left(terms, term)
            if ti >= len(terms) or terms[ti] != term:
                continue
            lo = int(seg.postings_offsets[ti])
            hi = int(seg.postings_offsets[ti + 1])
            if lo == hi:
                continue
            doc_bufs.append(seg.postings_docs[lo:hi])
            tf_bufs.append(seg.postings_tfs[lo:hi])
            offs.append(int(self.seg_offsets[si]))
            mts.append(float(self._seg_maxtf(si, seg)[ti]))
        df = engine.term_df(term)
        idf = engine.idf(df) if df else 0.0
        out = (doc_bufs, tf_bufs, offs, mts, idf)
        with self._cursor_lock:
            while len(self._cursor_cache) >= self._CURSOR_CACHE_CAP:
                self._cursor_cache.popitem(last=False)
            self._cursor_cache[term] = out
        return out

    def _cursors(self, term: str):
        """(docs view, tfs view, global offset, max tfnorm) per segment
        holding the term — the tuple view of ``_bundle`` (kept for tooling
        and tests)."""
        doc_bufs, tf_bufs, offs, mts, _idf = self._bundle(term)
        return list(zip(doc_bufs, tf_bufs, offs, mts))

    def search(
        self, query: "TextQuery", *, need_matched: bool = True,
        need_total: bool = True,
    ):
        """Mirror of DeviceTextEngine.search's scored branch; returns None
        when this query must take the device program. AND (all_terms)
        queries run the required-count evaluator (bm25_wand_req_multi) —
        the device program's `counts >= required` gate as cursor conjunction; the
        caller applies the same verify_all_terms tail as the device path.
        ``need_total=False`` (with need_matched=False) skips the
        corpus-wide matched pass entirely — the /find product path never
        reads the paragraph leg's total, and the union/count pass is the
        single largest non-evaluator cost at 1M docs (~100 µs/query)."""
        engine = self.engine
        scored = bool(query.text.strip() or query.phrases)
        if not scored:
            return None  # pure-filter queries keep the engine's host path

        terms, required = engine._plan_terms(query)
        n = engine.n_docs
        if not terms:
            return [], np.zeros(n, dtype=bool)
        if query.all_terms and required >= self._IMPOSSIBLE:
            # a token with no exact/fuzzy variant: unsatisfiable AND — the
            # device program returns zero hits and an all-false matched set
            empty = (
                np.zeros(n, dtype=bool) if need_matched
                else self._CountOnly(0, n)
            )
            return [], empty

        doc_bufs, tf_bufs, offs, weights, maxtf = [], [], [], [], []
        n_scheduled = 0
        for term, weight in terms:
            t_docs, t_tfs, t_offs, t_mts, idf = self._bundle(term)
            if idf == 0.0:
                continue
            n_scheduled += 1
            w = weight * idf
            doc_bufs += t_docs
            tf_bufs += t_tfs
            offs += t_offs
            maxtf += t_mts
            weights += [w] * len(t_offs)
        if not doc_bufs:
            return [], np.zeros(n, dtype=bool)

        unfiltered = (
            query.filter is None and query.key_prefixes is None
            and query.extra_mask is None and not query.excluded
        )
        if unfiltered:
            mask_u8 = self._alive_u8
        else:
            mask_u8 = np.ascontiguousarray(
                engine.build_mask(query)[:n].astype(np.uint8)
            )

        offs_np = np.asarray(offs, np.int64)
        w_np = np.asarray(weights, np.float32)
        mt_np = np.asarray(maxtf, np.float32)
        k = max(1, min(query.top_k, n))
        min_score = query.min_score

        if query.all_terms:
            if (
                AND_HOST_MAX_POSTINGS
                and sum(len(d) for d in doc_bufs) > AND_HOST_MAX_POSTINGS
            ):
                return None  # heavy conjunction: the device program wins
            # the same clamp as _params_for: fixed caps can't drop terms
            # here (every cursor schedules), but the requirement must not
            # exceed the achievable count
            required_eff = max(min(required, n_scheduled), 1)
            s_b, i_b, c_b = _native.bm25_wand_req_multi(
                doc_bufs, tf_bufs, offs_np, w_np, mt_np, self.dl_norm,
                mask_u8, k, self._k1, required_eff,
            )
            top_c = np.frombuffer(c_b, np.int32)
            if need_matched:
                bm = _native.bm25_count_multi(
                    doc_bufs, offs_np, mask_u8, n, required_eff, True
                )
                matched = np.frombuffer(bm, np.uint8).astype(bool)
            elif need_total:
                count = _native.bm25_count_multi(
                    doc_bufs, offs_np, mask_u8, n, required_eff, False
                )
                matched = self._CountOnly(int(count), n)
            else:
                matched = self._CountOnly(-1, n)  # total not computed
        else:
            # required=1 degenerates to plain WAND (the count condition is
            # always met at the first cursor) and rides counts along — a
            # hit's matched-term count lets the caller's exact-match pruner
            # skip position verification (engine.py TextHit.term_count)
            s_b, i_b, c_b = _native.bm25_wand_req_multi(
                doc_bufs, tf_bufs, offs_np, w_np, mt_np, self.dl_norm,
                mask_u8, k, self._k1, 1,
            )
            # counts are a SAFE ematch pruner only if every query token is
            # scheduled (a stopword-dropped token could make a true exact
            # match count below the caller's distinct-token bar) or absent
            # from the corpus entirely (then no doc can exact-match anyway)
            scheduled_terms = {t for t, _ in terms}
            all_toks = tokenize(query.text)
            for p in query.phrases:
                all_toks.extend(tokenize(p))
            counts_safe = all(
                t in scheduled_terms or not engine.has_term(t)
                for t in all_toks
            )
            top_c = np.frombuffer(c_b, np.int32) if counts_safe else None
            if need_matched:
                bm = _native.bm25_match_multi(doc_bufs, offs_np, mask_u8, n, True)
                matched = np.frombuffer(bm, np.uint8).astype(bool)
            elif need_total:
                count = _native.bm25_match_multi(doc_bufs, offs_np, mask_u8, n, False)
                matched = self._CountOnly(int(count), n)
            else:
                matched = self._CountOnly(-1, n)  # total not computed
        top_s = np.frombuffer(s_b, np.float32)
        top_i = np.frombuffer(i_b, np.int64)

        if query.only_faceted:
            return [], matched

        TextHit = self._TextHit
        keys = engine.keys
        attrs = engine.attrs
        if top_c is None:
            hits = [
                TextHit(keys[d], float(s), int(d), attrs[d], -1)
                for s, d in zip(top_s, top_i)
                if d >= 0 and (min_score is None or s >= min_score)
            ]
        else:
            hits = [
                TextHit(keys[d], float(s), int(d), attrs[d], int(c))
                for s, d, c in zip(top_s, top_i, top_c)
                if d >= 0 and (min_score is None or s >= min_score)
            ]
        return hits, matched
