"""Searcher service: segment sync + shard searcher cache.

Counterpart of ``nucliadb_tpu/services/searcher.py`` with an explicit torch
``device`` for every shard searcher it opens. The sync loop, the LRU with
single-flight loads and the refresh through ``prev`` are the JAX
package's. ``search_multi`` takes the concurrent per-shard path; the mesh
groups that run co-resident shards as one sharded program
(``parallel/group.py``, ``parallel/text_group.py`` there) are not ported
(ROADMAP.md, Queue 1 item 15), and a request that would take them raises.

Parity: nidx/src/searcher/ (SyncedSearcher, sync.rs:57-219,
index_cache.rs) — watches indexes' updated_at, diffs the desired segment
set against the local cache, downloads what's missing, and (re)opens shard
searchers over consolidated device arenas. The reference keeps an LRU of
per-index searchers with single-flight loads; here a shard's searchers
rebuild atomically on change (device arenas are consolidated per index
anyway) and the previous searcher serves until the swap.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import torch

from ..index.vector.config import VectorConfig
from ..metadata import MetadataStore
from ..shard import ShardConfig, ShardSearcher, ShardSearchRequest, ShardSearchResponse
from ..storage import Storage
from ..storage.storage import download_segment
from ..types import SegmentMetadata, SimpleOpenIndex
from ..utils.platform import resolve_device

# per-shard fan-out of search_multi. A DEDICATED pool (not the shard
# searcher's _INDEX_POOL): each task submits paragraph/document legs into
# that pool, and sharing one pool would let a full set of outer tasks
# starve the inner ones (nested-submit deadlock).
_SHARD_POOL = ThreadPoolExecutor(max_workers=16, thread_name_prefix="shardfan")


def mesh_serving_wanted(device: torch.device) -> bool:
    """True where the JAX package's ``mesh_serving_active()`` would be: more
    than one card visible and ``NDBTPU_MESH_SERVING`` not "0"."""
    if os.environ.get("NDBTPU_MESH_SERVING", "1") == "0":
        return False
    return device.type == "cuda" and torch.cuda.device_count() > 1


class SyncedSearcher:
    def __init__(
        self,
        metadata: MetadataStore,
        storage: Storage,
        cache_dir: str | None = None,
        *,
        selector=None,
        node_name: str | None = None,
        max_open_shards: int = 64,
        device: "str | torch.device" = "cuda",
    ):
        self.metadata = metadata
        self.storage = storage
        self.device = resolve_device(device)
        self.cache_dir = cache_dir or tempfile.mkdtemp(prefix="ndbtpu_searcher_")
        # LRU of open shard searchers + single-flight loads (parity:
        # nidx searcher IndexCache, index_cache.rs:145-260 — bounded open
        # searchers, one concurrent load per key, readers keep serving the
        # old searcher until the swap)
        self._shards: OrderedDict[str, ShardSearcher] = OrderedDict()
        self._mu = threading.Lock()
        self._loads: dict[str, threading.Lock] = {}
        self.max_open_shards = max_open_shards
        self._index_state: dict[int, float] = {}  # index id -> updated_at seen
        self._shard_indexes: dict[str, set[int]] = {}  # shard -> loaded index ids
        # multi-node deployments: only sync shards this node owns per the
        # rendezvous selector (parity: searcher syncs its assigned shards,
        # nidx/src/searcher/sync.rs + shard_selector)
        self.selector = selector
        self.node_name = node_name

    def _owns(self, shard_id: str) -> bool:
        if self.selector is None or self.node_name is None:
            return True
        return self.node_name in self.selector.nodes_for_shard(shard_id)

    # ------------------------------------------------------------------

    def sync(self) -> list[str]:
        """Refresh shard searchers whose indexes changed; returns shard ids."""
        from ..telemetry.metrics import sync_delay_gauge

        sync_start = time.time()
        dirty: set[str] = set()
        live: set[str] = set()
        prewarm: set[str] = set()
        for shard in self.metadata.list_shards():
            live.add(shard.id)
            if shard.config.get("prewarm_enabled"):
                prewarm.add(shard.id)
            if not self._owns(shard.id):
                with self._mu:
                    self._shards.pop(shard.id, None)  # dropped on topology change
                continue
            indexes = self.metadata.get_indexes(shard.id)
            for index in indexes:
                seen = self._index_state.get(index.id)
                if seen is None or index.updated_at > seen:
                    dirty.add(shard.id)
            # a DELETED index (e.g. delete_vectorset) leaves no live row to
            # report a newer updated_at — diff the live index-id set against
            # what the open searcher was built from, or it serves the
            # dropped vectorset forever
            loaded = self._shard_indexes.get(shard.id)
            if loaded is not None and {i.id for i in indexes} != loaded:
                dirty.add(shard.id)
        # evict deleted shards (parity: sync.rs processes deletions too —
        # a cached searcher for a deleted shard would serve stale data forever)
        with self._mu:
            for shard_id in list(self._shards):
                if shard_id not in live:
                    self._shards.pop(shard_id, None)
        # staleness being cleared this round (parity: searcher SYNC_DELAY
        # gauge, nidx/src/main.rs:147): seconds between the oldest dirty
        # index's update and this sync
        oldest = min(
            (
                index.updated_at
                for shard_id in dirty
                for index in self.metadata.get_indexes(shard_id)
                if self._index_state.get(index.id) is None
                or index.updated_at > self._index_state[index.id]
            ),
            default=None,
        )
        sync_delay_gauge.set(max(sync_start - oldest, 0.0) if oldest else 0.0)
        for shard_id in dirty:
            # only OPEN searchers reload eagerly; everything else loads
            # lazily on first search (parity: the reference's cache
            # invalidates on change, loads on demand). prewarm-enabled
            # shards (ConfigureShards, nidx.proto ShardConfig) load eagerly
            # even when closed — their device arenas must be hot before the
            # first query
            if shard_id in self._shards or shard_id in prewarm:
                with self._mu:
                    load = self._loads.setdefault(shard_id, threading.Lock())
                with load:  # same single-flight lock the lazy path takes
                    self._reload_shard(shard_id)
        return sorted(dirty)

    def _open_index_meta(self, index_id: int) -> SimpleOpenIndex:
        oi = SimpleOpenIndex(
            deletion_list=self.metadata.deletions_for_index(index_id)
        )
        ready = self.metadata.ready_segments(index_id)
        # prune merged-away/purged segments from the local cache (parity:
        # sync.rs diffs desired-vs-local and deletes the undesired)
        index_dir = os.path.join(self.cache_dir, str(index_id))
        desired = {str(seg.id) for seg in ready}
        if os.path.isdir(index_dir):
            for name in os.listdir(index_dir):
                if name not in desired:
                    shutil.rmtree(os.path.join(index_dir, name), ignore_errors=True)
        for seg in ready:
            local = os.path.join(index_dir, str(seg.id))
            download_segment(self.storage, seg.storage_key, local)
            oi.segment_list.append(
                (
                    SegmentMetadata(
                        path=local,
                        records=seg.records,
                        tags=frozenset(seg.tags),
                        index_metadata=seg.index_metadata,
                    ),
                    seg.seq,
                )
            )
        return oi

    def _reload_shard(self, shard_id: str) -> None:
        shard = self.metadata.get_shard(shard_id)
        if shard is None:
            with self._mu:
                self._shards.pop(shard_id, None)
            return
        vectorsets: dict[str, VectorConfig] = {}
        open_indexes: dict[str, SimpleOpenIndex] = {}
        loaded_ids: set[int] = set()
        for index in self.metadata.get_indexes(shard_id):
            if index.kind == "vector":
                vectorsets[index.name] = VectorConfig.from_dict(index.configuration)
            open_indexes[index.full_name] = self._open_index_meta(index.id)
            self._index_state[index.id] = index.updated_at
            loaded_ids.add(index.id)
        self._shard_indexes[shard_id] = loaded_ids
        config = ShardConfig(shard_id=shard_id, kbid=shard.kbid, vectorsets=vectorsets)
        with self._mu:
            prev = self._shards.get(shard_id)
        searcher = ShardSearcher(config, open_indexes, prev=prev, device=self.device)
        with self._mu:
            self._shards[shard_id] = searcher
            self._shards.move_to_end(shard_id)
            while len(self._shards) > self.max_open_shards:
                # the load lock is NOT popped: a thread may hold it
                # mid-reload, and a fresh lock would let a second reload
                # race the first on the same segment cache directory (the
                # dict only ever holds shards this node serves — bounded)
                self._shards.popitem(last=False)

    # ------------------------------------------------------------------

    def shard(self, shard_id: str) -> ShardSearcher:
        with self._mu:
            searcher = self._shards.get(shard_id)
            if searcher is not None:
                self._shards.move_to_end(shard_id)
                return searcher
            load = self._loads.setdefault(shard_id, threading.Lock())
        with load:  # single flight: one concurrent load per shard
            with self._mu:
                searcher = self._shards.get(shard_id)
                if searcher is not None:
                    return searcher
            self._reload_shard(shard_id)
            with self._mu:
                return self._shards[shard_id]

    def search(self, shard_id: str, request: ShardSearchRequest) -> ShardSearchResponse:
        return self.shard(shard_id).search(request)

    def search_multi(
        self, shard_ids: "list[str]", request: ShardSearchRequest
    ) -> "list[ShardSearchResponse]":
        """Search several shards concurrently, one task per shard. Parity:
        the reference runs shard queries concurrently
        (nidx/src/searcher/shards_query.rs:29-72)."""
        if len(shard_ids) > 1 and request.vector is not None and mesh_serving_wanted(self.device):
            raise NotImplementedError(
                "multi-shard search over more than one card runs the mesh groups, which are "
                "not ported yet (ROADMAP.md, Queue 1 item 15); set NDBTPU_MESH_SERVING=0 "
                "for the per-shard path"
            )
        if len(shard_ids) <= 1:
            return [self.search(s, request) for s in shard_ids]
        futures = [_SHARD_POOL.submit(self.search, s, request) for s in shard_ids]
        return [f.result() for f in futures]
