"""Device-resident consolidated vector index and its search routes.

Counterpart of ``nucliadb_tpu/index/vector/device.py`` for SINGLE
cardinality with a resident arena. All open segments of an index become
one padded arena ``vectors [p_pad, D]`` on ``device`` (``bucket()``
padding, at least one pad row); paragraph ids are arena rows.

Routes of ``search``, as in the JAX package:

- host exact tier: a small f32 arena (``p_pad * D <= HOST_SCAN_ELEMS``)
  without codes is scanned with numpy on the host;
- ``_search_exact``: exact f32 scan + masked top-k (+ the Fssc dedup);
- ``_search_int8`` above ``EXACT_SCAN_THRESHOLD`` rows: int8 candidates,
  then the exact rerank and cut. Candidates come from the top-2 slot scan
  (``ops/slot_scan.py``) under the JAX package's gate (``device.py:929-933``),
  otherwise from an exact top-c of the int8 estimates;
- ``_search_int8_pallas`` (flag ``pallas``, ``slot_scan.eligible``): the
  candidates come from the top-1 slot scan ``int8_scan_slots``;
- binary codes (quantization ``binary``) above the threshold:
  ``_search_binary_pallas`` (flag ``pallas``, a bucketed batch of at most
  64, ``binary_scan.binary_eligible``) takes its candidates from the
  popcount slot scan (``ops/binary_scan.py``); ``_search_binary`` from an
  exact top-c of the optimistic estimates.

The routes and their gates are the JAX package's (``device.py:589-632``);
each slot scan is a CUDA kernel for tensors on the card and its plain
version on the CPU.

Not ported yet, and raising ``NotImplementedError`` (ROADMAP.md, Queue 1):
MULTI cardinality, the ``ivf``/``hnsw`` flags and
``NDBTPU_VECTOR_ARENA_BUDGET`` paging.

Unlike JAX arrays, torch tensors are updated in place: an incremental
refresh writes the new rows into the previous index's arena (see
``__init__``), so the two indexes share it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ...types import Seq
from ...utils.buckets import bucket

from ...ops import binary_scan, quant, slot_scan
from ...ops.distance import prepare_query, rerank_scores, scores_matmul
from ...ops.topk import NEG_INF, masked_topk
from ...utils.platform import device_fetch, resolve_device, stream_wait, thread_stream
from .config import EXACT_SCAN_THRESHOLD, Quantization, VectorCardinality, VectorConfig
from .segment import LoadedSegment, alive_mask, key_prefix_ranges

# host numpy exact tier eligibility: p_pad * dim at or below this runs the
# exact scan on host BLAS instead of the device; 0 disables the tier
HOST_SCAN_ELEMS = int(os.environ.get("NDBTPU_VECTOR_HOST_SCAN_ELEMS", 2_097_152) or 0)


@dataclass
class VectorHit:
    key: str
    score: float
    labels: list[str]
    metadata: dict


def _check_ported(config: VectorConfig) -> None:
    where = "is not ported yet (ROADMAP.md, Queue 1)"
    if config.cardinality == VectorCardinality.MULTI:
        raise NotImplementedError(f"MULTI cardinality (MaxSim) {where}")
    unported = {"ivf", "hnsw"} & set(config.flags)
    if unported:
        raise NotImplementedError(f"vector flags {sorted(unported)} {where}")
    if int(os.environ.get("NDBTPU_VECTOR_ARENA_BUDGET", "0") or 0) > 0:
        raise NotImplementedError(f"NDBTPU_VECTOR_ARENA_BUDGET paging {where}")


def _store_dtype(config: VectorConfig) -> torch.dtype:
    # flag "bf16": the rerank arena in bfloat16 (half the device memory);
    # scores still accumulate in f32
    return torch.bfloat16 if "bf16" in config.flags else torch.float32


class DeviceVectorIndex:
    """All open segments of one vector index, resident on ``device``."""

    def __init__(
        self,
        config: VectorConfig,
        segments: Sequence[tuple[LoadedSegment, Seq]],
        deletions: Sequence[tuple[str, Seq]] = (),
        prev: "DeviceVectorIndex | None" = None,
        *,
        device: "str | torch.device" = "cuda",
    ):
        _check_ported(config)
        self.device = resolve_device(device)
        thread_stream(self.device)
        self.config = config
        dim = config.dimension

        keys: list[str] = []
        para_meta: list[dict] = []
        postings: dict[str, list[np.ndarray]] = {}
        seg_tags: list[frozenset[str]] = []
        para_seg_chunks: list[np.ndarray] = []
        alive_chunks: list[np.ndarray] = []
        vec_chunks: list[np.ndarray] = []
        self.seg_bounds: list[tuple[int, int]] = []
        para_offset = 0
        for seg_idx, (seg, seq) in enumerate(segments):
            seg_tags.append(seg.tags)
            keys.extend(seg.keys)
            para_meta.extend(seg.para_meta)
            for label, pids in seg.labels.items():
                postings.setdefault(label, []).append(pids + para_offset)
            para_seg_chunks.append(np.full(seg.n_paragraphs, seg_idx, dtype=np.int32))
            alive_chunks.append(alive_mask(seg, seq, deletions))
            sv = np.asarray(seg.vectors, dtype=np.float32)
            if sv.shape[0] != seg.n_paragraphs:
                raise ValueError("single-cardinality index with multi-vector segment")
            vec_chunks.append(sv)
            self.seg_bounds.append((para_offset, para_offset + seg.n_paragraphs))
            para_offset += seg.n_paragraphs

        self.keys = keys
        # per-segment identity for the incremental-refresh prefix check
        self._seg_sig = tuple(
            (seg.path, int(seq), seg.n_paragraphs) for seg, seq in segments
        )
        self._extended = False
        self.para_meta = para_meta
        self.seg_tags = seg_tags
        self.labels = {
            label: np.sort(np.concatenate(chunks)) for label, chunks in postings.items()
        }
        self.n_para = para_offset
        self.para_seg = (
            np.concatenate(para_seg_chunks) if para_seg_chunks else np.zeros(0, np.int32)
        )
        self.alive = np.concatenate(alive_chunks) if alive_chunks else np.zeros(0, bool)
        # reserve >=1 padding slot so the pad paragraph is always maskable
        self.p_pad = bucket(self.n_para + 1)
        flat = np.concatenate(vec_chunks) if vec_chunks else np.zeros((0, dim), np.float32)
        store_dtype = _store_dtype(config)

        delta_dev = None
        if self._can_extend(prev, store_dtype):
            # incremental refresh: prev's rows are a prefix of ours, so only
            # the delta is uploaded, padded to a small ladder of row counts.
            # It is written IN PLACE into prev's arena, past prev.n_para: those
            # rows are padding that prev masks out, so prev keeps answering
            # correctly. A torch slice does not clamp an out-of-range start as
            # dynamic_update_slice does, hence the guard; and prev's tail is
            # handed to one successor only (_extended).
            delta = flat[prev.n_para :]
            pad_rows = bucket(max(delta.shape[0], 1), minimum=64)
            if prev.n_para + pad_rows <= self.p_pad:
                delta_padded = np.zeros((pad_rows, dim), np.float32)
                delta_padded[: delta.shape[0]] = delta
                delta_dev = torch.from_numpy(delta_padded).to(self.device, store_dtype)
                rows = slice(prev.n_para, prev.n_para + pad_rows)
                prev.vectors[rows] = delta_dev
                prev._extended = True
        if delta_dev is not None:
            self.vectors = prev.vectors
        else:
            arena = np.zeros((self.p_pad, dim), np.float32)
            arena[: self.n_para] = flat
            self.vectors = torch.from_numpy(arena).to(self.device, store_dtype)
        self._base_mask_dev: torch.Tensor | None = None
        self._set_host_arena(flat)

        self.codes: quant.Int8Codes | quant.BinaryCodes | None = None
        quantized = self.n_para > EXACT_SCAN_THRESHOLD
        if quantized and config.quantization == Quantization.INT8:
            if delta_dev is not None and isinstance(prev.codes, quant.Int8Codes):
                # int8 encoding is per-row: encode only the delta and splice
                dcodes = quant.Int8Codes.encode(delta_dev)
                prev.codes.codes[rows] = dcodes.codes
                prev.codes.scale[rows] = dcodes.scale
                self.codes = prev.codes
            else:
                self.codes = quant.Int8Codes.encode(self.vectors)
        elif quantized and config.quantization == Quantization.BINARY:
            # as the JAX package does, re-encode the whole arena (a delta is
            # already written into it above)
            self.codes = quant.BinaryCodes.encode(self.vectors)
        # searches on other threads' streams read the arena (the in-place
        # delta included) once this index is published
        stream_wait(self.device)

    @classmethod
    def from_reference_state(
        cls,
        config: VectorConfig,
        keys: Sequence[str],
        para_meta: Sequence[dict],
        labels: dict[str, np.ndarray],
        seg_tags: Sequence[frozenset[str]],
        seg_bounds: Sequence[tuple[int, int]],
        arrays: dict[str, np.ndarray],
        *,
        device: "str | torch.device" = "cuda",
    ) -> "DeviceVectorIndex":
        """An index holding given state instead of building it from segments.

        ``arrays``: ``vectors [p_pad, D]``, ``alive [n_para] bool``,
        ``para_seg [n_para] i32`` and, when the index has int8 codes,
        ``codes [p_pad, D] i8`` and ``scale [p_pad] f32``, or, when it has
        binary codes, ``codes_t [D/32, p_pad] u32`` (or its int32 view),
        ``bin_scale``, ``resid`` and ``popcnt`` (``[p_pad] f32``); for
        example the ``np.asarray`` of a JAX ``DeviceVectorIndex``'s buffers.
        Such an index has no segment identity, so it is never extended in
        place."""
        _check_ported(config)
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        thread_stream(self.device)
        self.config = config
        self.keys = list(keys)
        self.para_meta = list(para_meta)
        self.labels = {k: np.asarray(v, np.int32) for k, v in labels.items()}
        self.seg_tags = list(seg_tags)
        self.seg_bounds = [tuple(b) for b in seg_bounds]
        self.n_para = len(self.keys)
        self.alive = np.asarray(arrays["alive"], dtype=bool)
        self.para_seg = np.asarray(arrays["para_seg"], dtype=np.int32)
        vectors = np.asarray(arrays["vectors"], dtype=np.float32)
        self.p_pad = vectors.shape[0]
        if self.p_pad != bucket(self.n_para + 1) or vectors.shape[1] != config.dimension:
            raise ValueError(f"arena shape {vectors.shape} does not fit {self.n_para} rows")
        self._seg_sig = None
        self._extended = False
        # torch.tensor copies: the given arrays may be read-only views
        self.vectors = torch.tensor(vectors, dtype=_store_dtype(config), device=self.device)
        self._base_mask_dev = None
        self._set_host_arena(vectors[: self.n_para])
        self.codes = None

        def f32(key):
            return torch.tensor(arrays[key], dtype=torch.float32, device=self.device)

        if "codes" in arrays:
            self.codes = quant.Int8Codes(
                codes=torch.tensor(arrays["codes"], dtype=torch.int8, device=self.device),
                scale=f32("scale"),
            )
        elif "codes_t" in arrays:
            words = np.ascontiguousarray(arrays["codes_t"]).view(np.int32)
            self.codes = quant.BinaryCodes(
                codes_t=torch.tensor(words, device=self.device),
                scale=f32("bin_scale"), resid=f32("resid"), popcnt=f32("popcnt"),
                dim=config.dimension,
            )
        stream_wait(self.device)
        return self

    def _set_host_arena(self, flat: np.ndarray) -> None:
        """Host numpy exact tier: a corpus this small is bounded by per-call
        device costs, not FLOPs. Disabled for bf16 arenas (bf16 rounding
        changes scores) and by NDBTPU_VECTOR_HOST_SCAN_ELEMS=0."""
        self._host_arena: np.ndarray | None = None
        dim = self.config.dimension
        if _store_dtype(self.config) == torch.float32 and self.p_pad * dim <= HOST_SCAN_ELEMS:
            host_arena = np.zeros((self.p_pad, dim), np.float32)
            host_arena[: self.n_para] = flat
            self._host_arena = host_arena

    def host_resident(self) -> bool:
        """True when ``search`` serves from the host exact tier and so
        launches nothing on the device: a host arena and no codes. (The
        JAX package also rules out an IVF layout, a graph and paged arenas,
        which this index refuses when it opens.)"""
        return self._host_arena is not None and self.codes is None

    def _can_extend(self, prev: "DeviceVectorIndex | None", store_dtype) -> bool:
        """True when ``prev``'s arena is reusable as a prefix of this one:
        same device, shape, dtype and padding, identical leading segments,
        and its tail not already handed to another successor."""
        if prev is None or prev._seg_sig is None or prev._extended:
            return False
        if prev.device != self.device:
            return False
        if prev.config.dimension != self.config.dimension:
            return False
        if set(prev.config.flags) != set(self.config.flags):
            return False
        if prev.p_pad != self.p_pad or prev.n_para > self.n_para:
            return False
        if prev.vectors.dtype != store_dtype:
            return False
        return self._seg_sig[: len(prev._seg_sig)] == prev._seg_sig

    # ------------------------------------------------------------------
    # Masks (host side)
    # ------------------------------------------------------------------

    def base_mask(self) -> np.ndarray:
        """alive ∧ not-padding, padded to p_pad."""
        mask = np.zeros(self.p_pad, dtype=bool)
        mask[: self.n_para] = self.alive
        return mask

    def base_mask_device(self) -> torch.Tensor:
        if self._base_mask_dev is None:
            mask = torch.from_numpy(self.base_mask()).to(self.device)
            stream_wait(self.device)  # other threads' streams read the cache
            self._base_mask_dev = mask
        return self._base_mask_dev

    def label_postings(self, label: str) -> np.ndarray:
        return self.labels.get(label, np.zeros(0, np.int32))

    def key_prefix_postings(self, prefixes: Sequence[str]) -> np.ndarray:
        out = []
        # bisect within each segment's sorted run — the concatenated key
        # list is NOT globally sorted across segments
        for lo, hi in key_prefix_ranges(self.keys, prefixes, self.seg_bounds):
            out.append(np.arange(lo, hi, dtype=np.int32))
        return np.concatenate(out) if out else np.zeros(0, np.int32)

    def segment_tag_mask(self, allowed: Sequence[int]) -> np.ndarray:
        """Mask keeping only paragraphs from the given segment indices."""
        keep = np.zeros(len(self.seg_tags), dtype=bool)
        keep[list(allowed)] = True
        mask = np.zeros(self.p_pad, dtype=bool)
        mask[: self.n_para] = keep[self.para_seg]
        return mask

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------

    def search(
        self,
        queries: np.ndarray,
        top_k: int,
        *,
        para_mask: np.ndarray | None = None,
        min_score: float | None = None,
        with_duplicates: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top-k paragraphs per query.

        queries: [B, D]. para_mask: [p_pad] or [n_para] bool (combined with
        the base mask). ``with_duplicates=False`` drops results repeating an
        identical vector (the reference's Fssc dedup).
        Returns ([B, k] scores, [B, k] paragraph ids, -1 = empty).
        """
        dedup = not with_duplicates
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim != 2:
            raise ValueError("multivector (MaxSim) queries are not ported yet")
        if para_mask is not None and para_mask.shape[0] == self.n_para:
            full = np.zeros(self.p_pad, dtype=bool)
            full[: self.n_para] = para_mask
            para_mask = full
        if self.host_resident():
            mask_np = self.base_mask() if para_mask is None else self.base_mask() & para_mask
            return self._search_host_exact(
                q, top_k, mask_np,
                float(NEG_INF) if min_score is None else float(min_score),
                dedup,
            )
        thread_stream(self.device)
        if para_mask is None:
            mask_t = self.base_mask_device()
        else:
            mask_t = torch.from_numpy(self.base_mask() & para_mask).to(self.device)
        # the floor compares in f32, as the JAX package's device scalar does
        ms = float(np.float32(NEG_INF if min_score is None else min_score))

        b = q.shape[0]
        b_pad = bucket(b, minimum=8)
        qp = np.zeros((b_pad, q.shape[1]), np.float32)
        qp[:b] = q
        qt = torch.from_numpy(qp).to(self.device)
        sim = self.config.similarity.value
        pallas = "pallas" in self.config.flags
        dim = self.config.dimension
        args = (self.codes, self.vectors, qt, mask_t, ms, top_k, sim, dedup)
        if isinstance(self.codes, quant.Int8Codes):
            if pallas and slot_scan.eligible(self.p_pad, dim, False):
                s, i = _search_int8_pallas(*args)
            else:
                s, i = _search_int8(*args)
        elif isinstance(self.codes, quant.BinaryCodes):
            # the JAX package's gate: the bucketed batch, and the Pallas
            # kernel's block for it
            if (
                pallas
                and b_pad <= 64
                and binary_scan.binary_eligible(
                    self.p_pad, dim, False,
                    block_n=binary_scan.binary_block_for(self.p_pad, b_pad, slot_scan.SLOTS),
                )
            ):
                s, i = _search_binary_pallas(*args)
            else:
                s, i = _search_binary(*args)
        else:
            s, i = _search_exact(self.vectors, qt, mask_t, ms, top_k, sim, dedup)
        s, i = device_fetch(s, i)
        return s[:b], i[:b]

    def _search_host_exact(
        self, q: np.ndarray, k: int, mask_np: np.ndarray,
        min_score_f: float, dedup: bool,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Host numpy mirror of _search_exact: full f32 scan + stable top-k
        (+ the same 2k+8 Fssc dedup window)."""
        arena = self._host_arena
        if self.config.similarity.value == "cosine":
            n = np.linalg.norm(q, axis=-1, keepdims=True)
            q = q / np.maximum(n, np.float32(1e-12))
        neg = np.float32(NEG_INF)
        scores = (q @ arena.T).astype(np.float32, copy=False)  # [B, p_pad]
        scores = np.where(mask_np[None, :], scores, neg)
        if min_score_f > float(NEG_INF):
            scores = np.where(scores >= np.float32(min_score_f), scores, neg)
        if dedup:
            k2 = min(2 * k + 8, scores.shape[-1])
            order = np.argsort(-scores, axis=-1, kind="stable")[:, :k2]
            cand_s = np.take_along_axis(scores, order, axis=-1)
            cand = np.where(cand_s > neg / 2, order, -1)
            rows = arena[np.maximum(cand, 0)]
            valid = cand >= 0
            valid = valid & ~_host_duplicate_mask(rows, valid)
            scored = np.where(valid, cand_s, neg)
            order2 = np.argsort(-scored, axis=-1, kind="stable")[:, :k]
            top_s = np.take_along_axis(scored, order2, axis=-1)
            top_i = np.take_along_axis(cand, order2, axis=-1)
            top_i = np.where(top_s > neg / 2, top_i, -1)
        else:
            order = np.argsort(-scores, axis=-1, kind="stable")[:, :k]
            top_s = np.take_along_axis(scores, order, axis=-1)
            top_i = np.where(top_s > neg / 2, order, -1)
        if k > top_s.shape[1]:
            pad_s = np.full((top_s.shape[0], k - top_s.shape[1]), NEG_INF, np.float32)
            pad_i = np.full((top_i.shape[0], k - top_i.shape[1]), -1, np.int64)
            top_s = np.concatenate([top_s, pad_s], axis=-1)
            top_i = np.concatenate([top_i, pad_i], axis=-1)
        return top_s.astype(np.float32), top_i.astype(np.int64)

    def _labels_of(self, pid: int) -> list[str]:
        """Labels of one paragraph; the inverted lists build lazily once."""
        inv = getattr(self, "_para_labels", None)
        if inv is None:
            inv = [[] for _ in range(self.n_para)]
            for label, pids in self.labels.items():
                for p in pids.tolist():
                    inv[p].append(label)
            self._para_labels = inv
        return inv[pid]

    def hits(self, scores_row: np.ndarray, ids_row: np.ndarray) -> list[VectorHit]:
        """Materialize one query's results as VectorHits (host)."""
        out = []
        for pid, score in zip(ids_row.tolist(), scores_row.tolist()):
            if pid < 0:
                continue
            out.append(
                VectorHit(
                    key=self.keys[pid],
                    score=float(score),
                    labels=self._labels_of(pid),
                    metadata=self.para_meta[pid],
                )
            )
        return out


# --------------------------------------------------------------------------
# Search programs — paragraph ids == arena rows
# --------------------------------------------------------------------------


def _host_duplicate_mask(cand_vecs: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Host mirror of _duplicate_mask (same double-hash projections, f32)."""
    d = cand_vecs.shape[-1]
    idx = np.arange(d, dtype=np.float32)
    w1 = np.sin(idx * 0.7310585) + 1.0
    w2 = np.cos(idx * 0.4142135) - 0.5
    h1 = (cand_vecs @ w1).astype(np.float32)
    h2 = (cand_vecs @ w2).astype(np.float32)
    same = (h1[:, :, None] == h1[:, None, :]) & (h2[:, :, None] == h2[:, None, :])
    c = cand_vecs.shape[1]
    earlier = np.tril(np.ones((c, c), bool), k=-1)[None]
    return np.any(same & earlier & valid[:, None, :], axis=-1)


def _search_exact(vectors, queries, para_mask, min_score, k, similarity, dedup=False):
    q = prepare_query(queries, similarity)
    scores = scores_matmul(q, vectors)  # [B, P]
    if not dedup:
        return masked_topk(scores, k, mask=para_mask, min_score=min_score)
    # over-fetch, drop identical-vector duplicates, cut back to k
    k2 = min(2 * k + 8, scores.shape[-1])
    _, cand = masked_topk(scores, k2, mask=para_mask, min_score=min_score)
    return _rerank_and_cut(vectors, q, cand, min_score, k, dedup=True)


def _duplicate_mask(cand_vecs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[B, C] bool — True where a candidate repeats an EARLIER candidate's
    vector (the reference's Fssc vector dedup). Equality is detected through
    two deterministic projections, computed by one product so that equal
    rows reduce in the same order and hash equal."""
    d = cand_vecs.shape[-1]
    idx = torch.arange(d, dtype=torch.float32, device=cand_vecs.device)
    w = torch.stack([torch.sin(idx * 0.7310585) + 1.0, torch.cos(idx * 0.4142135) - 0.5], 1)
    h = cand_vecs.float() @ w  # [B, C, 2]
    h1, h2 = h[..., 0], h[..., 1]
    same = (h1[:, :, None] == h1[:, None, :]) & (h2[:, :, None] == h2[:, None, :])
    c = cand_vecs.shape[1]
    earlier = torch.ones((c, c), dtype=torch.bool, device=cand_vecs.device).tril(-1)
    return (same & earlier[None] & valid[:, None, :]).any(dim=-1)


def _rerank_and_cut(vectors, q, cand_ids, min_score, k, dedup=False):
    """Exact rescoring of candidates; candidate ids are paragraph ids."""
    ids = cand_ids.long()
    cand_vecs = vectors[ids.clamp_min(0)]  # [B, C, D]
    exact = rerank_scores(q, cand_vecs)
    valid = ids >= 0
    if dedup:
        valid = valid & ~_duplicate_mask(cand_vecs, valid)
    top_s, pos = masked_topk(exact, k, mask=valid, min_score=min_score)
    top_ids = torch.gather(ids, -1, pos.clamp_min(0))
    return top_s, torch.where(pos >= 0, top_ids, -1)


def _exact_dedup_cut(vectors, queries, cand_ids, min_score, k, similarity):
    """Exact rescore + Fssc duplicate cut over externally-found candidates."""
    q = prepare_query(queries, similarity)
    return _rerank_and_cut(vectors, q, cand_ids, min_score, k, dedup=True)


def _int8_candidates(codes, q, budget, para_mask):
    """Int8 estimate scan -> [B, C] candidate ids.

    Under the JAX package's gate (rerank budget within the 2S-wide table,
    ``resident2_eligible``) the top-2-per-slot scan selects candidates:
    the CUDA kernel for tensors on the card, its plain version on the CPU.
    Otherwise an exact top-c of the int8 estimates does."""
    n, d = codes.codes.shape
    b = q.shape[0]
    if budget <= 2 * slot_scan.RESIDENT2_SLOTS and slot_scan.resident2_eligible(
        n, d, b, False
    ):
        qc, _ = quant.quantize_rows(q)
        slot_s, slot_i = slot_scan.int8_scan_slots_resident2(
            qc, codes.codes, codes.scale, para_mask
        )
        return _slot_candidates(slot_s, slot_i, budget)
    est = quant.int8_estimate_scores(codes, q)
    _, cand = masked_topk(est, min(budget, est.shape[-1]), mask=para_mask)
    return cand


def _slot_candidates(slot_s, slot_i, budget):
    """[B, C] candidate ids from a slot table: its top-C entries (C = the
    budget, at most the table's width) in ``lax.top_k``'s order (a stable
    descending sort: the lower slot index first among equal scores), empty
    slots cut to -1."""
    c = min(budget, slot_s.shape[-1])
    top_s, pos = torch.sort(slot_s, dim=-1, descending=True, stable=True)
    top_s, pos = top_s[:, :c], pos[:, :c]
    return torch.where(top_s > slot_scan.NEG_INF / 2, torch.gather(slot_i, -1, pos), -1)


def _search_int8(codes, vectors, queries, para_mask, min_score, k, similarity, dedup=False):
    """Int8 estimate scan -> candidates -> exact rerank (see _int8_candidates)."""
    q = prepare_query(queries, similarity)
    cand = _int8_candidates(codes, q, quant.int8_rerank_budget(k), para_mask)
    return _rerank_and_cut(vectors, q, cand, min_score, k, dedup=dedup)


def _int8_pallas_candidates(codes, q, budget, para_mask):
    """[B, C] candidate ids from the top-1 slot scan ``int8_scan_slots``."""
    qc, _ = quant.quantize_rows(q)
    slot_s, slot_i = slot_scan.int8_scan_slots(
        qc, codes.codes, codes.scale, para_mask,
        block_n=slot_scan.BLOCK_N, slots=slot_scan.SLOTS,
    )
    return _slot_candidates(slot_s, slot_i, budget)


def _search_int8_pallas(codes, vectors, queries, para_mask, min_score, k, similarity, dedup=False):
    """Int8 candidates from the top-1 slot scan (config flag "pallas"),
    then the exact rerank and cut."""
    q = prepare_query(queries, similarity)
    cand = _int8_pallas_candidates(codes, q, quant.int8_rerank_budget(k), para_mask)
    return _rerank_and_cut(vectors, q, cand, min_score, k, dedup=dedup)


def _binary_pallas_candidates(codes, q, budget, para_mask):
    """[B, C] candidate ids from the popcount slot scan ``binary_scan_slots``
    (optimistic scores: estimate + bound)."""
    n = codes.codes_t.shape[1]
    slot_s, slot_i = binary_scan.binary_scan_slots(
        *quant.binary_query_params(q),
        codes.codes_t, codes.scale, codes.popcnt, codes.resid, para_mask,
        dim=codes.dim,
        block_n=binary_scan.binary_block_for(n, q.shape[0], slot_scan.SLOTS),
        slots=slot_scan.SLOTS,
    )
    return _slot_candidates(slot_s, slot_i, budget)


def _search_binary_pallas(codes, vectors, queries, para_mask, min_score, k, similarity, dedup=False):
    """Binary candidates from the popcount slot scan (config flag "pallas"):
    no [B, N] estimate matrix is formed, only the [B, S] slot table; then
    the exact rerank and cut."""
    q = prepare_query(queries, similarity)
    cand = _binary_pallas_candidates(codes, q, quant.binary_rerank_budget(k), para_mask)
    return _rerank_and_cut(vectors, q, cand, min_score, k, dedup=dedup)


def _search_binary(codes, vectors, queries, para_mask, min_score, k, similarity, dedup=False):
    """Binary candidates from an exact top-c of the optimistic estimates,
    taken over column chunks (``quant.binary_scan_candidates``), then the
    exact rerank and cut."""
    q = prepare_query(queries, similarity)
    _, cand = quant.binary_scan_candidates(codes, q, k, mask=para_mask)
    return _rerank_and_cut(vectors, q, cand, min_score, k, dedup=dedup)
