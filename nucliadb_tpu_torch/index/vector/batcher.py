"""Concurrent-query coalescing for the vector index.

The port's counterpart of ``nucliadb_tpu/index/vector/batcher.py``: its
counters ``dispatches`` and ``batched_queries`` grow under the coalescer's
lock, so that dispatchers draining at once lose no count, and it records
two spans a coalesced query (``telemetry/tracing.py``).

The device index takes a batch ([B, D] queries in one dispatch), but each
request otherwise dispatches its own: a DeviceVectorIndex.search spends
milliseconds of host time under the interpreter lock (the padding, the
upload, its launches, the fetch) for a fraction of a millisecond of card
work at B = 8, so N concurrent single-query searches pay N of them for
work the card does in one.

Design — **bounded-pipeline continuous batching**:

- up to ``concurrency`` dispatches per key may be in flight at once, so at
  low load queries pipeline as without the coalescer;
- when every slot is busy, arriving queries queue; a slot that frees drains
  everything queued into one batch. Batch size adapts to load by itself —
  no timed windows;
- batches are padded to the next power of two: that bounds the batch
  shapes the card sees at log2(max_batch) + 1, each one a shape of the
  slot scan's grid, the rerank's products and the caching allocator's
  blocks; the padded rows are scanned and reranked like the real ones;
- compatible = same searcher, top_k, min_score and include_hidden, and NO
  per-query filters (a filtered query needs its own [N] mask; masks are
  shared across a batch inside the kernel). Filtered queries dispatch solo,
  exactly as before.

Spans, while tracing is on, both with attribute ``dispatch`` (the batch's
number among ``dispatches``): ``coalescer.wait`` from ``search_one``
queueing the query to ``_drain`` taking the batch that holds it, and
``coalescer.handoff`` from ``_drain`` setting the query's ``done`` to its
caller's wait returning. Both are recorded on the caller's thread.

This is the product-level realization of the "searcher batches concurrent
requests into one device program" design (the reference's analogue is tokio
handling many shard queries concurrently inside one searcher process,
nidx/src/searcher/shards_query.rs:29-72 — there concurrency costs threads,
here a bigger batch costs nothing until HBM).
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Optional

import numpy as np

from ...telemetry import tracing

if TYPE_CHECKING:  # pragma: no cover
    from . import VectorHit, VectorSearcher, VectorSearchRequest


class _Entry:
    __slots__ = ("vector", "result", "error", "done", "queued", "taken", "released", "dispatch")

    def __init__(self, vector: np.ndarray):
        self.vector = vector
        self.result: Optional[list] = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        # tracing.stamp()s, 0 while tracing is off, and the dispatch number
        self.queued = tracing.stamp()
        self.taken = self.released = self.dispatch = 0

    def release(self) -> None:
        if self.queued:
            self.released = tracing.stamp()
        self.done.set()


class QueryCoalescer:
    """Merges concurrent unfiltered vector queries into shared batches."""

    def __init__(self, max_batch: int = 2048, concurrency: int = 4):
        # 2048: measured MORE efficient per query than smaller batches at
        # 1M x 768 (8.0 vs 11.5 ms/1024 queries — the estimate matmul fuses
        # with approx_max_k so big batches never materialize [B, N]); the
        # cap only binds past 2048 queued queries on one key
        self.max_batch = max_batch
        self.concurrency = concurrency
        self._lock = threading.Lock()
        self._pending: dict[tuple, list[_Entry]] = {}
        self._active: dict[tuple, int] = {}  # key -> in-flight dispatchers
        # observability
        self.batched_queries = 0
        self.dispatches = 0

    @staticmethod
    def eligible(request: "VectorSearchRequest") -> bool:
        q = np.asarray(request.vectors)
        single = q.ndim == 1 or (q.ndim == 2 and q.shape[0] == 1)
        return (
            single
            and request.filter is None
            and request.field_filter.is_all
            and not request.key_prefixes
        )

    def search_one(
        self, searcher: "VectorSearcher", request: "VectorSearchRequest"
    ) -> "list[VectorHit]":
        """One single-vector query; may ride a shared batch. Returns the
        hits for THIS query (the [0] row of a solo search)."""
        if not self.eligible(request):
            return searcher.search(request)[0]
        entry = _Entry(np.asarray(request.vectors, dtype=np.float32).reshape(-1))
        key = (
            id(searcher),
            request.top_k,
            request.min_score,
            request.include_hidden,
            request.with_duplicates,
        )
        with self._lock:
            self._pending.setdefault(key, []).append(entry)
            dispatcher = self._active.get(key, 0) < self.concurrency
            if dispatcher:
                self._active[key] = self._active.get(key, 0) + 1

        if dispatcher:
            self._drain(key, searcher, request)

        if not entry.done.wait(timeout=120.0):
            raise TimeoutError("coalesced vector search timed out")
        if entry.taken and entry.released:
            tracing.record_span("coalescer.wait", entry.queued, entry.taken, dispatch=entry.dispatch)
            tracing.record_span("coalescer.handoff", entry.released, tracing.stamp(), dispatch=entry.dispatch)
        if entry.error is not None:
            raise RuntimeError("coalesced vector search failed") from entry.error
        return entry.result

    def _release(self, key) -> None:
        n = self._active.get(key, 1) - 1
        if n <= 0:
            self._active.pop(key, None)
        else:
            self._active[key] = n

    def _drain(self, key, searcher, template) -> None:
        """Dispatch pending batches for `key` until the queue is empty."""
        from . import VectorSearchRequest as VSR

        while True:
            with self._lock:
                queue = self._pending.get(key, [])
                batch, rest = queue[: self.max_batch], queue[self.max_batch :]
                if rest:
                    self._pending[key] = rest
                else:
                    self._pending.pop(key, None)
                if not batch:
                    self._release(key)
                    return
                self.dispatches += 1
                self.batched_queries += len(batch)
                if batch[0].queued:
                    taken = tracing.stamp()
                    for e in batch:
                        e.taken, e.dispatch = taken, self.dispatches
            try:
                vecs = [e.vector for e in batch]
                padded = 1 << (len(vecs) - 1).bit_length()
                vecs += [vecs[0]] * (padded - len(vecs))
                out = searcher.search(
                    VSR(
                        vectors=np.stack(vecs),
                        top_k=template.top_k,
                        min_score=template.min_score,
                        include_hidden=template.include_hidden,
                        with_duplicates=template.with_duplicates,
                    )
                )
                for e, hits in zip(batch, out):
                    e.result = hits
            except BaseException as exc:
                for e in batch:
                    e.error = exc
                with self._lock:
                    # fail the rest of the queue too rather than strand it
                    for e in self._pending.pop(key, []):
                        e.error = exc
                        e.release()
                    self._release(key)
                for e in batch:
                    e.release()
                # do NOT re-raise: the dispatcher may be draining OTHER
                # callers' batches after its own entry already succeeded —
                # every affected caller sees the failure through its entry,
                # and the dispatcher's own result must not be discarded
                import logging

                logging.getLogger(__name__).warning(
                    "coalesced vector dispatch failed", exc_info=True
                )
                return
            for e in batch:
                e.release()


# process-wide coalescer shared by every shard searcher
import os as _os

# in-flight dispatch slots per key: lower values force BIGGER
# coalesced batches under load (each dispatch pays its host time under
# the interpreter lock, so batch size is the throughput lever); higher
# values pipeline better at low load. Tunable for benches/deployments.
coalescer = QueryCoalescer(
    concurrency=int(_os.environ.get("NDBTPU_COALESCER_CONCURRENCY", 4))
)
