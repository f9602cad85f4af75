"""Device-resident consolidated vector index and its search routes.

Counterpart of ``nucliadb_tpu/index/vector/device.py``. All open segments
of an index become one padded arena on ``device`` (``bucket()`` padding, at
least one pad paragraph):

- SINGLE cardinality: ``vectors [p_pad, D]``; paragraph ids are arena rows;
- MULTI cardinality (multivector MaxSim): uniform slots ``vectors
  [p_pad * m_max, D]``, slot ``p * m_max + j`` the j-th vector of paragraph
  p (zero-padded), ``m_count [p_pad]`` the vectors of each paragraph.

Routes of ``search``, as in the JAX package:

- host exact tier: a small f32 SINGLE arena (``p_pad * D <=
  HOST_SCAN_ELEMS``) without codes is scanned with numpy on the host;
- ``_maxsim_core`` for a MULTI index: a 3-D query ``[B, M, D]`` (a 2-D
  one is M = 1) against every slot in one product, the max over each
  paragraph's slots, the sum over the query's non-zero rows, a masked
  top-k (+ the dedup over whole slot blocks). MULTI builds no codes, no
  IVF layout and no graph;
- ``_search_paged`` when the arena exceeds ``NDBTPU_VECTOR_ARENA_BUDGET``
  bytes (SINGLE only): ``host_rerank`` keeps int8 codes on the device
  (candidates from ``_int8_candidates``) and the f32 rows in host memory
  for ``_host_rerank_cut``; ``stream`` keeps nothing on the device and
  scans the host arena in uploaded chunks (``_stream_chunk_topk``);
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
  exact top-c of the optimistic estimates;
- flag ``ivf``: the probe scan of ``ops/ivf.py`` over a blocked int8 layout
  built when the index opens (from the biggest segment's persisted
  centroids when it holds at least a quarter of the rows);
- flag ``hnsw``: the beam search of ``ops/hnsw.py`` over the segments'
  persisted graphs stitched together (up to 8), or one graph built over
  the arena, while at least a tenth of the rows pass the filter
  (``_use_graph``); otherwise the scan routes above.
  Both over-fetch ``2k + 8`` under ``with_duplicates=False`` and cut with
  ``_exact_dedup_cut``.

The routes and their gates are the JAX package's (``device.py:523-632``);
each slot scan is a CUDA kernel for tensors on the card and its plain
version on the CPU.

While tracing is on, a search of a resident SINGLE index (every route but
the host exact tier, MaxSim and the paged tiers) records three spans in
turn: ``device_index.prepare`` (the thread's stream, the mask, the padding
and the pageable query upload; attributes ``rows`` and ``padded_rows``),
``device_index.enqueue`` (the route's launches, ``_search_resident``) and
``device_index.fetch`` (``device_fetch``: the copies and the wait for the
thread's stream).

On a card, the resident int8 route (``_search_int8`` and
``_search_int8_pallas``, no IVF layout or graph) replays a captured CUDA
graph a call (``graphs.py``) where its launches dominate: at most
``graphs.MAX_ROWS`` padded rows, candidates from a slot table. ``prepare``
checks a replay out of the index's ``GraphCache`` by ``(b_pad, top_k, dedup,
floor present, filtered)`` and uploads the padded queries and the floor into
its static buffer (a filtered call its mask too), ``enqueue`` replays it
(attribute ``graph``: ``replay``, ``capture`` or ``eager``), and the replay
is checked in after the fetch (a new one is captured there). Every other
route, and every CPU tensor, runs eagerly.

Unlike JAX arrays, torch tensors are updated in place: an incremental
refresh writes the new rows into the previous index's arena (see
``__init__``), so the two indexes share it.
"""

from __future__ import annotations

import functools
import os
import weakref
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ...telemetry import tracing
from ...types import Seq
from ...utils.buckets import bucket

from ...ops import binary_scan, hnsw, ivf, quant, slot_scan
from ...ops.distance import prepare_query, rerank_scores, scores_matmul
from ...ops.topk import NEG_INF, masked_topk
from ...utils.platform import device_fetch, resolve_device, stream_wait, thread_stream
from . import graphs
from .config import EXACT_SCAN_THRESHOLD, Quantization, VectorCardinality, VectorConfig
from .graphs import GRAPHS  # the replayed route's counter, also read as device.GRAPHS
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
        self.device = resolve_device(device)
        thread_stream(self.device)
        self._init_graphs()
        self.config = config
        self.multi = config.cardinality == VectorCardinality.MULTI
        dim = config.dimension

        keys: list[str] = []
        para_meta: list[dict] = []
        postings: dict[str, list[np.ndarray]] = {}
        seg_tags: list[frozenset[str]] = []
        para_seg_chunks: list[np.ndarray] = []
        alive_chunks: list[np.ndarray] = []
        vec_chunks: list[np.ndarray] = []
        # multi: each segment's vectors, the paragraph of each and its count
        vec_para_chunks: list[np.ndarray] = []
        count_chunks: list[np.ndarray] = []
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
            if self.multi:
                vp = np.asarray(seg.vec_para, dtype=np.int64)
                vec_para_chunks.append(vp + para_offset)
                count_chunks.append(np.bincount(vp, minlength=seg.n_paragraphs).astype(np.int32))
            elif sv.shape[0] != seg.n_paragraphs:
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
        store_dtype = _store_dtype(config)
        self._base_mask_dev: torch.Tensor | None = None
        self._host_arena: np.ndarray | None = None
        self.paging: str | None = None
        self.vectors_host: np.ndarray | None = None
        self.codes: quant.Int8Codes | quant.BinaryCodes | None = None
        self.ivf: ivf.DeviceIVF | None = None
        self.graph: hnsw.DeviceHnsw | None = None

        if self.multi:
            self._build_multi(vec_chunks, vec_para_chunks, count_chunks, store_dtype)
            stream_wait(self.device)  # other threads' streams read the arena
            return
        self.m_max = 1
        self.m_count = None
        flat = np.concatenate(vec_chunks) if vec_chunks else np.zeros((0, dim), np.float32)
        if self._page(flat, store_dtype):
            stream_wait(self.device)  # other threads' streams read the codes
            return

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
        self._set_host_arena(flat)

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

        # flag "ivf": reuse the biggest segment's persisted centroids when it
        # holds at least a quarter of the rows (one assignment pass)
        if "ivf" in config.flags and self.n_para > 0:
            best = max(
                (s for s, _ in segments if s.ivf_centroids is not None),
                key=lambda s: s.n_paragraphs,
                default=None,
            )
            centroids = None
            if best is not None and best.n_paragraphs * 4 >= self.n_para:
                centroids = torch.from_numpy(np.asarray(best.ivf_centroids, np.float32))
            self.ivf = ivf.build_ivf(self.vectors, self.n_para, centroids=centroids)

        # flag "hnsw": the segments' persisted graphs stitched, else one
        # graph built over the arena
        if "hnsw" in config.flags and self.n_para > 0:
            stitched = self._stitch_segment_graphs(segments)
            if stitched is not None:
                adj, entry_ids = stitched
                n_components = len(segments)
            else:
                adj, entry_ids = hnsw.build_graph(flat, vectors_dev=self.vectors)
                n_components = 1
            self.graph = self._device_graph(adj, entry_ids, n_components)
        # searches on other threads' streams read the arena (the in-place
        # delta included) and the strategies' state once this index is
        # published
        stream_wait(self.device)

    def _build_multi(self, vec_chunks, vec_para_chunks, count_chunks, store_dtype) -> None:
        """The uniform slot arena ``[p_pad * m_max, D]`` on the device, with
        ``m_max = bucket(most vectors of a paragraph, minimum=1)``, and
        ``m_count [p_pad]`` i32. Only the segments' vectors are uploaded;
        each lands in its slot on the device."""
        counts = np.concatenate(count_chunks) if count_chunks else np.zeros(0, np.int32)
        self.m_max = bucket(int(counts.max()) if counts.size else 1, minimum=1)
        dim = self.config.dimension
        self.vectors = torch.zeros((self.p_pad * self.m_max, dim), dtype=store_dtype, device=self.device)
        for sv, vp in zip(vec_chunks, vec_para_chunks):
            if not sv.shape[0]:
                continue
            # vec_para is sorted: a vector's slot is its rank within its paragraph
            first = np.searchsorted(vp, vp, side="left")
            slots = vp * self.m_max + (np.arange(vp.shape[0]) - first)
            rows = torch.from_numpy(slots).to(self.device)
            # torch.tensor copies: a segment's columns are read-only maps
            self.vectors[rows] = torch.tensor(sv, dtype=store_dtype, device=self.device)
        m_count = np.zeros(self.p_pad, np.int32)
        m_count[: self.n_para] = counts
        self.m_count = torch.from_numpy(m_count).to(self.device)

    def _page(self, flat: np.ndarray, store_dtype) -> bool:
        """The beyond-HBM tiers (the reference's mmap'd stores and segment
        paging, nidx_vector/src/data_store.rs): when the arena and its codes
        exceed the budget, the f32 arena stays in host memory
        (``vectors_host``) and ``paging`` names the tier:

        - ``host_rerank`` (int8 quantization, the codes within the budget):
          int8 codes on the device, encoded on the host (``_host_int8_encode``)
          and uploaded; only the candidates' f32 rows are read per query;
        - ``stream``: nothing resident; a query scans the host arena in
          chunks of ``chunk_rows``, the largest power of two whose f32 rows
          fit the budget.

        True when the index pages (no IVF layout, no graph: it opens as the
        JAX package's does, ``device.py:198-249``)."""
        # NDBTPU_VECTOR_ARENA_BUDGET: the bytes of device memory one index may
        # hold (0 or unset: no limit)
        budget = int(os.environ.get("NDBTPU_VECTOR_ARENA_BUDGET", "0") or 0)
        if budget <= 0:
            return False
        dim = self.config.dimension
        itemsize = 2 if store_dtype == torch.bfloat16 else 4
        vec_bytes = self.p_pad * dim * itemsize
        code_bytes = self.p_pad * (dim + 4)  # int8 codes + f32 scale
        if vec_bytes + code_bytes <= budget:
            return False
        arena_np = np.zeros((self.p_pad, dim), np.float32)
        arena_np[: self.n_para] = flat
        self.vectors_host = arena_np
        self.vectors = None
        if self.config.quantization == Quantization.INT8 and code_bytes <= budget:
            self.paging = "host_rerank"
            codes_np, scale_np = _host_int8_encode(arena_np)
            self.codes = quant.Int8Codes(
                codes=torch.from_numpy(codes_np).to(self.device),
                scale=torch.from_numpy(scale_np).to(self.device),
            )
        else:
            self.paging = "stream"
            rows = max(budget // (dim * 4), 8)
            self.chunk_rows = 1 << (rows.bit_length() - 1)
        return True

    def _device_graph(self, adj: np.ndarray, entry_ids: np.ndarray, n_components: int) -> hnsw.DeviceHnsw:
        """The [n_para] graph padded to the arena's rows, on the device."""
        adj_pad = np.full((self.p_pad, adj.shape[1]), -1, np.int64)
        adj_pad[: self.n_para] = adj
        seg_of = None
        if n_components > 1:
            seg_pad = np.zeros(self.p_pad, np.int64)
            seg_pad[: self.n_para] = self.para_seg
            seg_of = torch.from_numpy(seg_pad).to(self.device)
        return hnsw.DeviceHnsw(
            adj=torch.from_numpy(adj_pad).to(self.device),
            entry_ids=torch.from_numpy(np.asarray(entry_ids, np.int64)).to(self.device),
            n_nodes=self.n_para,
            seg_of=seg_of,
            n_segments=n_components,
        )

    @staticmethod
    def _stitch_segment_graphs(
        segments: Sequence[tuple[LoadedSegment, Seq]],
    ) -> tuple[np.ndarray, np.ndarray] | None:
        """Disjoint union of the segments' persisted graphs: node ids shift
        by each segment's row offset and the entry sets unite; no edge
        crosses segments (the search reserves beam slots per component).
        None (build one graph) when a segment has no graph or there are
        more than 8."""
        if (
            not segments
            or len(segments) > 8
            or any(seg.hnsw_adj is None for seg, _ in segments)
        ):
            return None
        m_max = max(seg.hnsw_adj.shape[1] for seg, _ in segments)
        adj_parts: list[np.ndarray] = []
        entry_parts: list[np.ndarray] = []
        offset = 0
        for seg, _ in segments:
            adj = np.asarray(seg.hnsw_adj, dtype=np.int32)
            if adj.shape[1] < m_max:
                adj = np.pad(adj, ((0, 0), (0, m_max - adj.shape[1])), constant_values=-1)
            adj_parts.append(np.where(adj >= 0, adj + offset, -1))
            entry_parts.append(np.asarray(seg.hnsw_entry, dtype=np.int32) + offset)
            offset += seg.n_paragraphs
        return np.concatenate(adj_parts), np.concatenate(entry_parts)

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

        ``arrays``: ``alive [n_para] bool``, ``para_seg [n_para] i32`` and
        the arena ``vectors [p_pad, D]``, or for a MULTI config ``vectors
        [p_pad * m_max, D]``, ``m_count [p_pad] i32`` and ``m_max``, or for
        a paged index ``paging`` (``"host_rerank"`` or ``"stream"``) and the
        host arena ``vectors_host [p_pad, D]``, with ``chunk_rows`` on the
        ``stream`` tier. When the index has int8 codes (``host_rerank``
        too): ``codes [p_pad, D] i8`` and ``scale [p_pad] f32``; binary
        codes: ``codes_t [D/32, p_pad] u32`` (or its int32 view),
        ``bin_scale``, ``resid`` and ``popcnt`` (``[p_pad] f32``); with a
        graph, ``hnsw_adj [p_pad, m]``, ``hnsw_entry_ids [E]``,
        ``hnsw_n_segments`` and (stitched) ``hnsw_seg_of [p_pad]``; with an
        IVF layout, ``ivf_centroids``, ``ivf_block_codes``,
        ``ivf_block_scale``, ``ivf_block_ids``, ``ivf_cluster_blocks`` and
        ``ivf_block``; for example the ``np.asarray`` of a JAX
        ``DeviceVectorIndex``'s buffers. Such an index has no segment
        identity, so it is never extended in place."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        thread_stream(self.device)
        self._init_graphs()
        self.config = config
        self.multi = config.cardinality == VectorCardinality.MULTI
        self.keys = list(keys)
        self.para_meta = list(para_meta)
        self.labels = {k: np.asarray(v, np.int32) for k, v in labels.items()}
        self.seg_tags = list(seg_tags)
        self.seg_bounds = [tuple(b) for b in seg_bounds]
        self.n_para = len(self.keys)
        self.alive = np.asarray(arrays["alive"], dtype=bool)
        self.para_seg = np.asarray(arrays["para_seg"], dtype=np.int32)
        self.paging = arrays.get("paging")
        self.m_max = int(arrays.get("m_max", 1))
        vectors = np.asarray(arrays["vectors_host" if self.paging else "vectors"], dtype=np.float32)
        self.p_pad = vectors.shape[0] // self.m_max
        if (
            self.p_pad != bucket(self.n_para + 1)
            or vectors.shape != (self.p_pad * self.m_max, config.dimension)
        ):
            raise ValueError(f"arena shape {vectors.shape} does not fit {self.n_para} rows")
        self._seg_sig = None
        self._extended = False
        self._base_mask_dev = None
        self._host_arena = None
        self.vectors_host = None
        self.vectors = None
        self.m_count = None
        if self.paging:
            self.vectors_host = np.array(vectors)  # a copy: the given arrays may be read-only
            if self.paging == "stream":
                self.chunk_rows = int(arrays["chunk_rows"])
        else:
            # torch.tensor copies: the given arrays may be read-only views
            self.vectors = torch.tensor(vectors, dtype=_store_dtype(config), device=self.device)
            if self.multi:
                self.m_count = torch.tensor(arrays["m_count"], dtype=torch.int32, device=self.device)
            else:
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

        def i64(key):
            return torch.tensor(np.asarray(arrays[key]), dtype=torch.int64, device=self.device)

        self.graph = None
        if "hnsw_adj" in arrays:
            self.graph = hnsw.DeviceHnsw(
                adj=i64("hnsw_adj"),
                entry_ids=i64("hnsw_entry_ids"),
                n_nodes=self.n_para,
                seg_of=i64("hnsw_seg_of") if "hnsw_seg_of" in arrays else None,
                n_segments=int(arrays.get("hnsw_n_segments", 1)),
            )
        self.ivf = None
        if "ivf_centroids" in arrays:
            self.ivf = ivf.DeviceIVF(
                centroids=f32("ivf_centroids"),
                block_codes=torch.tensor(arrays["ivf_block_codes"], dtype=torch.int8, device=self.device),
                block_scale=f32("ivf_block_scale"),
                block_ids=i64("ivf_block_ids"),
                cluster_blocks=i64("ivf_cluster_blocks"),
                block=int(arrays["ivf_block"]),
            )
        stream_wait(self.device)
        return self

    def _init_graphs(self) -> None:
        """The index's own captured graphs, dropped with it (released by the
        capture thread, ``graphs._drop``)."""
        self._graphs = graphs.GraphCache(self.device)
        weakref.finalize(self, self._graphs.close)

    def _set_host_arena(self, flat: np.ndarray) -> None:
        """Host numpy exact tier (SINGLE, resident): a corpus this small is
        bounded by per-call device costs, not FLOPs. Disabled for bf16
        arenas (bf16 rounding changes scores) and by
        NDBTPU_VECTOR_HOST_SCAN_ELEMS=0."""
        self._host_arena = None
        dim = self.config.dimension
        if _store_dtype(self.config) == torch.float32 and self.p_pad * dim <= HOST_SCAN_ELEMS:
            host_arena = np.zeros((self.p_pad, dim), np.float32)
            host_arena[: self.n_para] = flat
            self._host_arena = host_arena

    def host_resident(self) -> bool:
        """True when ``search`` serves from the host exact tier and so
        launches nothing on the device: a resident SINGLE index with a host
        arena, and no codes, IVF layout or graph."""
        return (
            self._host_arena is not None
            and not self.multi
            and self.paging is None
            and self.codes is None
            and self.ivf is None
            and self.graph is None
        )

    def _can_extend(self, prev: "DeviceVectorIndex | None", store_dtype) -> bool:
        """True when ``prev``'s arena is reusable as a prefix of this one:
        both resident SINGLE indexes on the same device, with the same
        shape, dtype and padding, identical leading segments, and prev's
        tail not already handed to another successor."""
        if prev is None or prev._seg_sig is None or prev._extended:
            return False
        if prev.paging is not None or prev.multi:
            return False  # a paged arena has no device prefix; slots are not rows
        if prev.device != self.device:
            return False
        if prev.config.dimension != self.config.dimension:
            return False
        if set(prev.config.flags) != set(self.config.flags):
            return False
        if "ivf" in self.config.flags or "hnsw" in self.config.flags:
            return False  # those strategies hold state derived from the whole arena
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

        queries: [B, D], or [B, M, D] against a MULTI index (a MaxSim
        query of M vectors; its all-zero rows are padding). para_mask:
        [p_pad] or [n_para] bool (combined with the base mask).
        ``with_duplicates=False`` drops results repeating an identical
        vector (the reference's Fssc dedup; a MULTI paragraph's whole slot
        block). Returns ([B, k] scores, [B, k] paragraph ids, -1 = empty).
        """
        dedup = not with_duplicates
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 3 and not self.multi:
            raise ValueError("multivector query against a single-vector index")
        if q.ndim == 2 and self.multi:
            q = q[:, None, :]  # a single vector against a MULTI index: MaxSim with M = 1
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
        if self.paging is not None:
            thread_stream(self.device)
            mask_np = self.base_mask() if para_mask is None else self.base_mask() & para_mask
            s, i = self._search_paged(q, top_k, mask_np, min_score, dedup)
            return s[: q.shape[0]], i[: q.shape[0]]
        # the floor compares in f32, as the JAX package's device scalar does
        ms = float(np.float32(NEG_INF if min_score is None else min_score))
        sim = self.config.similarity.value

        if self.multi:
            thread_stream(self.device)
            mask_t, _ = self._device_mask(para_mask)
            b = q.shape[0]
            b_pad = bucket(b, minimum=1)
            qp = np.zeros((b_pad,) + q.shape[1:], np.float32)
            qp[:b] = q
            qmask = np.zeros(qp.shape[:2], dtype=bool)
            qmask[:b] = np.abs(q).sum(-1) > 0
            s, i = _maxsim_core(
                self.vectors, self.m_count, torch.from_numpy(qp).to(self.device),
                torch.from_numpy(qmask).to(self.device), mask_t, ms, top_k, self.m_max,
                sim, dedup=dedup,
            )
            s, i = device_fetch(s, i)
            return s[:b], i[:b]

        graphed = self._graphed()
        replay = None
        try:
            with tracing.span("device_index.prepare") as span:
                thread_stream(self.device)
                b = q.shape[0]
                b_pad = bucket(b, minimum=8)
                if graphed and self._replays(b_pad, top_k):
                    key = graphs.key_of(b_pad, top_k, dedup, min_score is not None, para_mask is not None)
                    replay = self._graphs.checkout(
                        key, lambda: graphs.new_replay(key, q.shape[1], self.base_mask_device())
                    )
                qt, floor, mask_t, matching = self._upload(q, b_pad, ms, para_mask, replay)
                if span is not None:
                    span.set_attribute("rows", b)
                    span.set_attribute("padded_rows", b_pad)
            with tracing.span("device_index.enqueue") as span:
                if graphed:
                    (s, i), mode = graphs.enqueue(replay, functools.partial(
                        self._int8_route(), self.codes, self.vectors, qt, mask_t, floor, top_k, sim, dedup,
                    ))
                    if span is not None:
                        span.set_attribute("graph", mode)
                else:
                    s, i = self._search_resident(qt, mask_t, matching, ms, top_k, sim, dedup, b_pad)
            with tracing.span("device_index.fetch"):
                s, i = device_fetch(s, i)
        except BaseException:
            if replay is not None:
                self._graphs.checkin(replay, ok=False)
            raise
        if replay is not None:
            self._graphs.checkin(replay)
        return s[:b], i[:b]

    def _graphed(self) -> bool:
        """True when a search takes the resident int8 route on a card, with
        no IVF layout or graph: the route ``graphs.py`` replays."""
        return (
            self.device.type == "cuda"
            and isinstance(self.codes, quant.Int8Codes)
            and self.ivf is None
            and self.graph is None
        )

    def _replays(self, b_pad: int, top_k: int) -> bool:
        """True when a call of the route replays a graph: at most
        ``graphs.MAX_ROWS`` padded rows, and candidates from a slot table
        (the rerank budget within the top-2 table, or the ``pallas`` route),
        never from a ``[B, N]`` estimate matrix."""
        if b_pad > graphs.MAX_ROWS or quant.int8_rerank_budget(top_k) > 2 * slot_scan.RESIDENT2_SLOTS:
            return False
        return self._int8_route() is _search_int8_pallas or slot_scan.resident2_eligible(
            self.p_pad, self.config.dimension, b_pad, False
        )

    def _upload(self, q: np.ndarray, b_pad: int, ms: float, para_mask: "np.ndarray | None", replay):
        """The padded queries, the floor, the eligible rows on the device and
        how many they are. Into ``replay``'s buffers when there is one: the
        queries and the floor in one copy, a filtered call's mask into its
        mask, and otherwise the mask it holds, since ``base_mask_device`` is
        filled lazily and threads that race there each make one, so the
        index's may not be the one this replay's graph reads."""
        if replay is None:
            mask_t, matching = self._device_mask(para_mask)
            qp = np.zeros((b_pad, q.shape[1]), np.float32)
            qp[: q.shape[0]] = q
            return torch.from_numpy(qp).to(self.device), ms, mask_t, matching
        inputs = np.zeros(replay.inputs.shape[0], np.float32)
        inputs[: q.size] = q.reshape(-1)
        inputs[-1] = ms
        replay.inputs.copy_(torch.from_numpy(inputs))
        if para_mask is not None:
            replay.mask.copy_(torch.from_numpy(self.base_mask() & para_mask))
        floor_present = replay.key[3]
        return replay.queries, replay.floor if floor_present else ms, replay.mask, None

    def _device_mask(self, para_mask: "np.ndarray | None") -> "tuple[torch.Tensor, int]":
        """The eligible rows on the device and how many there are."""
        if para_mask is None:
            return self.base_mask_device(), int(self.alive.sum())
        combined = self.base_mask() & para_mask
        return torch.from_numpy(combined).to(self.device), int(combined.sum())

    def _int8_route(self):
        """``_search_int8_pallas`` under the ``pallas`` flag and its gate, else
        ``_search_int8``."""
        if "pallas" in self.config.flags and slot_scan.eligible(self.p_pad, self.config.dimension, False):
            return _search_int8_pallas
        return _search_int8

    def _search_resident(self, qt, mask_t, matching, ms, top_k, sim, dedup, b_pad):
        """Queue the resident SINGLE route's programs for the padded
        queries ``qt``; returns the [b_pad, k] scores and ids on the device."""
        pallas = "pallas" in self.config.flags
        dim = self.config.dimension
        args = (self.codes, self.vectors, qt, mask_t, ms, top_k, sim, dedup)
        # ivf/hnsw honour the dedup by over-fetching and running the exact
        # rescore + duplicate cut
        k1 = min(2 * top_k + 8, self.p_pad) if dedup else top_k
        if self.ivf is not None:
            s, i = ivf.ivf_search(self.ivf, self.vectors, prepare_query(qt, sim), mask_t, ms, k1)
            if dedup:
                s, i = _exact_dedup_cut(self.vectors, qt, i, ms, top_k, sim)
            return s, i
        if self.graph is not None and self._use_graph(matching, top_k):
            # the size-scaled default regime holds the 0.95 recall bar
            ef, trips = hnsw.default_search_params(self.graph.n_nodes)
            g = self.graph
            s, i = hnsw.hnsw_search(
                self.vectors, g.adj, g.entry_ids, qt, mask_t, ms, k1, ef=ef, trips=trips,
                similarity=sim, seg_of=g.seg_of, n_segments=g.n_segments,
            )
            if dedup:
                s, i = _exact_dedup_cut(self.vectors, qt, i, ms, top_k, sim)
            return s, i
        if isinstance(self.codes, quant.Int8Codes):
            return self._int8_route()(*args)
        if isinstance(self.codes, quant.BinaryCodes):
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
                return _search_binary_pallas(*args)
            return _search_binary(*args)
        return _search_exact(self.vectors, qt, mask_t, ms, top_k, sim, dedup)

    # ---- beyond-HBM search tiers ----------------------------------------

    def _search_paged(
        self, q: np.ndarray, k: int, mask_np: np.ndarray,
        min_score: "float | None", dedup: bool,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Search when the f32 arena lives in host memory (see ``_page``).

        host_rerank: the int8 candidates on the device (the top-2 slot scan
        under its gate), one fetch, then the exact f32 rescore, dedup and
        cut over the candidates' host rows. stream: an exact top-k of each
        uploaded chunk, pipelined one chunk ahead (at most two chunks on the
        device: the next chunk's upload and product are queued before the
        previous one's fetch waits), a stable host merge, then the same host
        rescore."""
        sim = self.config.similarity.value
        b_pad = bucket(q.shape[0], minimum=8)
        qp = np.zeros((b_pad, q.shape[1]), np.float32)
        qp[: q.shape[0]] = q
        qt = prepare_query(torch.from_numpy(qp).to(self.device), sim)
        if self.paging == "host_rerank":
            c = min(quant.int8_rerank_budget(k), self.p_pad)
            cand = _int8_candidates(self.codes, qt, c, torch.from_numpy(mask_np).to(self.device))
            q_np, cand = device_fetch(qt, cand)
            return self._host_rerank_cut(q_np, cand, k, min_score, dedup)
        k2 = min((2 * k + 8) if dedup else k, self.p_pad)
        rows = self.chunk_rows
        parts_s, parts_i = [], []
        pending = None  # (chunk start, device scores, device ids)

        def collect(p):
            s, i = device_fetch(p[1], p[2])
            parts_s.append(s)
            parts_i.append(np.where(i >= 0, i + p[0], -1))

        for start in range(0, self.p_pad, rows):
            chunk = self.vectors_host[start : start + rows]
            if chunk.shape[0] < rows:  # the tail keeps the chunk's shape
                chunk = np.concatenate([chunk, np.zeros((rows - chunk.shape[0], chunk.shape[1]), np.float32)])
            m = np.zeros(rows, dtype=bool)
            m[: min(rows, self.p_pad - start)] = mask_np[start : start + rows]
            # from pageable memory: the copy has read the host rows when the
            # call returns, so nothing waits on a staging buffer's reuse
            s, i = _stream_chunk_topk(
                torch.from_numpy(chunk).to(self.device), qt,
                torch.from_numpy(m).to(self.device), min(k2, rows),
            )
            if pending is not None:
                collect(pending)
            pending = (start, s, i)
        if pending is not None:
            collect(pending)
        all_s = np.concatenate(parts_s, axis=-1)
        all_i = np.concatenate(parts_i, axis=-1)
        order = np.argsort(-all_s, axis=-1, kind="stable")[:, :k2]
        cand = np.take_along_axis(all_i, order, axis=-1)
        (q_np,) = device_fetch(qt)
        return self._host_rerank_cut(q_np, cand, k, min_score, dedup)

    def _host_rerank_cut(
        self, q: np.ndarray, cand: np.ndarray, k: int,
        min_score: "float | None", dedup: bool,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact f32 rescore + Fssc dedup + top-k cut over host-gathered
        candidate rows (the host mirror of _rerank_and_cut)."""
        safe = np.maximum(cand, 0)
        rows = self.vectors_host[safe]  # [B, C, D]
        exact = np.einsum("bd,bcd->bc", q, rows, dtype=np.float32)
        valid = cand >= 0
        if dedup:
            valid = valid & ~_host_duplicate_mask(rows, valid)
        scored = np.where(valid, exact, np.float32(NEG_INF))
        if min_score is not None:
            scored = np.where(scored >= min_score, scored, np.float32(NEG_INF))
        order = np.argsort(-scored, axis=-1, kind="stable")[:, :k]
        top_s = np.take_along_axis(scored, order, axis=-1)
        top_i = np.take_along_axis(cand, order, axis=-1)
        top_i = np.where(top_s > np.float32(NEG_INF) / 2, top_i, -1)
        if k > top_s.shape[1]:  # pad to the requested width
            pad_s = np.full((top_s.shape[0], k - top_s.shape[1]), NEG_INF, np.float32)
            pad_i = np.full((top_i.shape[0], k - top_i.shape[1]), -1, np.int64)
            top_s = np.concatenate([top_s, pad_s], axis=-1)
            top_i = np.concatenate([top_i, pad_i], axis=-1)
        return top_s.astype(np.float32), top_i.astype(np.int64)

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

    def _use_graph(self, matching: int, top_k: int) -> bool:
        """The graph walk while at least a tenth of the rows pass the mask
        (the reference's use_hnsw cost model, nidx_vector/src/segment.rs:
        626-660); under a more selective filter the walk wastes its visits
        on masked nodes, and the scan is exact."""
        return self.n_para > 0 and matching / self.n_para >= 0.1

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


def _stream_chunk_topk(chunk, queries, mask, k):
    """One streamed chunk: exact f32 scores and a masked local top-k."""
    return masked_topk(scores_matmul(queries, chunk), k, mask=mask)


def _host_int8_encode(vectors: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Int8 codes of the paged tiers, encoded on the host so the f32 arena
    is never uploaded to be quantised. The JAX package's numpy arithmetic,
    kept verbatim: a true division by 127 and by the scale, where the
    resident ``quant.Int8Codes.encode`` multiplies by f32(1/127) (XLA's
    rewrite), so a scale can differ from the resident one in its last bit."""
    v = vectors.astype(np.float32)
    s = np.maximum(np.abs(v).max(axis=-1), 1e-12) / 127.0
    codes = np.clip(np.round(v / s[:, None]), -127, 127).astype(np.int8)
    return codes, s.astype(np.float32)


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


def _maxsim_core(vectors, m_count, queries, qmask, para_mask, min_score, k, m_max, similarity, dedup=False):
    """Multivector MaxSim (the JAX package's ``_search_maxsim`` and its
    core): the sum over the query's vectors (where ``qmask``) of each
    paragraph's best slot score (nidx_vector/src/multivector.rs:33-46), as
    one ``[B*M, D] x [P*m_max, D]`` product, the slots past ``m_count`` set
    to ``NEG_INF`` in place (the product is the largest tensor of the
    search), a max over each paragraph's slots and a sum over M. A
    paragraph without slots (padding) sums to 0, so the base mask drops it.

    With dedup: a top-(2k+8), then the duplicate mask over whole slot
    blocks (slots are zero-padded, so equal blocks mean the same count and
    vectors), then a top-k of the survivors."""
    b, m, d = queries.shape
    p_pad = vectors.shape[0] // m_max
    q = prepare_query(queries.reshape(b * m, d), similarity)
    slots = scores_matmul(q, vectors).view(b, m, p_pad, m_max)
    slot_valid = torch.arange(m_max, device=vectors.device) < m_count[:, None]
    slots.masked_fill_(~slot_valid, NEG_INF)
    para = slots.amax(dim=-1)  # [B, M, P]
    del slots
    contrib = torch.where(qmask[:, :, None] & (para > NEG_INF / 2), para, 0.0)
    maxsim = contrib.sum(dim=1)  # [B, P]
    if not dedup:
        return masked_topk(maxsim, k, mask=para_mask, min_score=min_score)
    k2 = min(2 * k + 8, maxsim.shape[-1])
    top_s, cand = masked_topk(maxsim, k2, mask=para_mask, min_score=min_score)
    cand_vecs = vectors.view(p_pad, m_max * d)[cand.clamp_min(0)]
    valid = (cand >= 0) & ~_duplicate_mask(cand_vecs, cand >= 0)
    s2, pos = masked_topk(torch.where(valid, top_s, NEG_INF), k, min_score=min_score)
    ids = torch.gather(cand, -1, pos.clamp_min(0))
    return s2, torch.where(pos >= 0, ids, -1)
