"""Concurrent-query coalescing for the BM25 text engine.

Copy of ``nucliadb_tpu/index/text_engine/batcher.py``, bound to the port's
engine. Up to ``concurrency`` dispatches per engine may be in flight; when
every slot is busy, arriving queries queue and a freed slot drains them
all through ``DeviceTextEngine.search_batch`` — one device program for B
queries. Batches are padded to the next power of two (the reference's
bound on compiled shapes; kept so both packages form the same batches).

Unlike the vector batch, BM25 queries are heterogeneous by nature (each
brings its own term rows/idfs), so ONLY the mask must be shared: eligible
queries are scored and unfiltered (no filter / key_prefixes / extra_mask),
which is exactly ``search_batch``'s shared-base-mask fast path. Filtered
queries dispatch solo, exactly as before.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:  # pragma: no cover
    from .engine import DeviceTextEngine, TextQuery


class _Entry:
    __slots__ = ("query", "need_total", "result", "error", "done")

    def __init__(self, query, need_total=True):
        self.query = query
        self.need_total = need_total
        self.result = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()


class TextQueryCoalescer:
    """Merges concurrent unfiltered BM25 queries into shared batches."""

    # 512: the reference's cap (its measured throughput peak on a TPU; not
    # measured on this card). The batch only grows this large when that
    # many queries are actually queued, so low-load latency is unaffected.
    def __init__(self, max_batch: int = 512, concurrency: int = 4):
        self.max_batch = max_batch
        self.concurrency = concurrency
        self._lock = threading.Lock()
        self._pending: dict[int, list[_Entry]] = {}
        self._active: dict[int, int] = {}
        self.batched_queries = 0
        self.dispatches = 0

    @staticmethod
    def eligible(query: "TextQuery") -> bool:
        return (
            bool(query.text.strip() or query.phrases)
            and not query.only_faceted
            and query.filter is None
            and query.key_prefixes is None
            and query.extra_mask is None
            and not query.excluded
        )

    def search_one(
        self, engine: "DeviceTextEngine", query: "TextQuery",
        need_total: bool = True,
    ):
        """One query -> (hits, matched-count proxy); may ride a batch.
        Matched comes back count-only (``need_matched=False`` semantics);
        ``need_total=False`` callers never read it (the proxy may carry -1
        when every query in the ridden batch opted out)."""
        if not self.eligible(query):
            return engine.search(
                query, need_matched=False, need_total=need_total
            )
        entry = _Entry(query, need_total)
        key = id(engine)
        with self._lock:
            self._pending.setdefault(key, []).append(entry)
            dispatcher = self._active.get(key, 0) < self.concurrency
            if dispatcher:
                self._active[key] = self._active.get(key, 0) + 1

        if dispatcher:
            self._drain(key, engine)

        if not entry.done.wait(timeout=120.0):
            raise TimeoutError("coalesced text search timed out")
        if entry.error is not None:
            raise RuntimeError("coalesced text search failed") from entry.error
        return entry.result

    def _release(self, key: int) -> None:
        n = self._active.get(key, 1) - 1
        if n <= 0:
            self._active.pop(key, None)
        else:
            self._active[key] = n

    def _drain(self, key: int, engine: "DeviceTextEngine") -> None:
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
            try:
                self.dispatches += 1
                self.batched_queries += len(batch)
                queries = [e.query for e in batch]
                need_total = any(e.need_total for e in batch)
                padded = 1 << (len(queries) - 1).bit_length()
                queries += [queries[0]] * (padded - len(queries))
                out = engine.search_batch(
                    queries, need_matched=False, need_total=need_total
                )
                for e, res in zip(batch, out):
                    e.result = res
            except BaseException as exc:
                for e in batch:
                    e.error = exc
                with self._lock:
                    for e in self._pending.pop(key, []):
                        e.error = exc
                        e.done.set()
                    self._release(key)
                for e in batch:
                    e.done.set()
                raise
            for e in batch:
                e.done.set()


# process-wide coalescer shared by every text/paragraph searcher
import os as _os

# in-flight dispatch slots per key: lower values force BIGGER
# coalesced batches under load; higher values pipeline better at low
# load. Tunable for benches/deployments.
coalescer = TextQueryCoalescer(
    concurrency=int(_os.environ.get("NDBTPU_COALESCER_CONCURRENCY", 4))
)
