"""Searcher service: segment sync + shard searcher cache.

Counterpart of ``nucliadb_tpu/services/searcher.py`` with an explicit torch
``device`` for every shard searcher it opens. The sync loop, the LRU with
single-flight loads, the refresh through ``prev`` and ``search_multi``
are the JAX package's: when more than one card is visible
(``parallel.group.mesh_serving_active``), the vector and keyword legs of
co-resident shards each run as one mesh program (``parallel/group.py``,
``parallel/text_group.py``), with the same responses as the concurrent
per-shard path it otherwise takes.

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

import numpy as np
import torch

from ..index.vector.config import VectorConfig
from ..metadata import MetadataStore
from ..shard import ShardConfig, ShardSearcher, ShardSearchRequest, ShardSearchResponse
from ..storage import Storage
from ..storage.storage import download_segment
from ..types import SegmentMetadata, SimpleOpenIndex
from ..utils.platform import resolve_device

# per-shard fan-out of search_multi, and of the non-vector legs of its mesh
# path. A DEDICATED pool (not the shard searcher's _INDEX_POOL): each task
# submits paragraph/document legs into that pool, and sharing one pool
# would let a full set of outer tasks starve the inner ones (nested-submit
# deadlock).
_MESH_SHARD_POOL = ThreadPoolExecutor(max_workers=16, thread_name_prefix="meshshard")


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
        # mesh serving: cached MeshVectorGroups keyed by (shard ids,
        # vectorset); an entry is stale once a member shard reloads (the
        # stored identity tuple no longer matches the live searchers)
        self._mesh_groups: "OrderedDict[tuple, tuple[tuple, object]]" = OrderedDict()
        # its keyword half: MeshTextGroups keyed by shard ids, the same way
        self._mesh_text_groups: "OrderedDict[tuple, tuple[tuple, object]]" = OrderedDict()

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

    # ------------------------------------------------------------------
    # Mesh serving path (parity: the reference's in-process multi-shard
    # parallel query, nidx/src/searcher/shards_query.rs:29-72 — here the
    # co-resident shards' vector legs run as ONE mesh program, see
    # parallel/group.py)
    # ------------------------------------------------------------------

    def _mesh_group(self, shard_ids: tuple, vs_name: str, vsearchers: list):
        from ..parallel.group import MeshVectorGroup

        key = (shard_ids, vs_name)
        ident = tuple((id(v.index), v.index._seg_sig) for v in vsearchers)
        cached = self._mesh_groups.get(key)
        if cached is not None and cached[0] == ident:
            self._mesh_groups.move_to_end(key)
            return cached[1]
        if not MeshVectorGroup.eligible(vsearchers):
            return None
        group = MeshVectorGroup(vsearchers)
        self._mesh_groups[key] = (ident, group)
        self._mesh_groups.move_to_end(key)
        while len(self._mesh_groups) > 8:
            self._mesh_groups.popitem(last=False)
        return group

    def _search_many(
        self, shard_ids: "list[str]", request: ShardSearchRequest
    ) -> "list[ShardSearchResponse]":
        """Concurrent per-shard fan-out: the multi-shard path whenever the
        mesh group is not usable. Parity: the reference runs shard queries
        concurrently (nidx/src/searcher/shards_query.rs:29-72)."""
        if len(shard_ids) <= 1:
            return [self.search(s, request) for s in shard_ids]
        futures = [_MESH_SHARD_POOL.submit(self.search, s, request) for s in shard_ids]
        return [f.result() for f in futures]

    def search_multi(
        self, shard_ids: "list[str]", request: ShardSearchRequest
    ) -> "list[ShardSearchResponse]":
        """Search several shards; when more than one card is visible,
        co-resident shards' vector AND keyword legs each run as one mesh
        program (parallel/group.py, parallel/text_group.py): a hybrid /find
        over any number of co-resident shards runs at most 2 mesh programs.
        Each leg falls back to the concurrent per-shard path whenever its
        group is not eligible (mixed configs, ivf/hnsw/pallas flags, binary
        codes, paged arenas, a missing vectorset; phrase queries, cursors
        or mismatched engine layouts for the keyword leg). The responses
        are the same either way: the vector group selects int8 candidates
        through the same ``_int8_candidates`` as the per-shard path (the
        top-2 slot kernel on the card) and the text group runs the same
        BM25 program per shard (see both modules' parity contracts). No
        dispatching thread waits for the whole card: each fetch waits for
        its own thread's stream."""
        from ..parallel.group import mesh_serving_active

        if (
            len(shard_ids) <= 1
            or request.vector is None
            or not mesh_serving_active(self.device)
        ):
            return self._search_many(shard_ids, request)
        from ..index.vector import VectorSearchRequest
        from ..types import PrefilterResult

        searchers = [self.shard(s) for s in shard_ids]
        vs_name = request.vectorset or next(iter(searchers[0].vectors), "")
        vsearchers = [sh.vectors.get(vs_name) for sh in searchers]
        if any(v is None for v in vsearchers):
            return self._search_many(shard_ids, request)
        group = self._mesh_group(tuple(shard_ids), vs_name, vsearchers)
        if group is None:
            return self._search_many(shard_ids, request)

        # per-shard prefilters (host: text ∧ json engines), then the same
        # filter-to-mask pipeline VectorSearcher.search runs
        prefilters = [
            sh.compute_prefilter(request)
            if sh._needs_prefilter(request)
            else PrefilterResult.all()
            for sh in searchers
        ]
        q = np.asarray(request.vector, np.float32)
        # [D] -> [1, D]; a multivector query [M, D] -> [1, M, D] (the group
        # runs MaxSim per shard — parallel/group.py _group_search_multi)
        q = q.reshape(1, -1) if q.ndim == 1 else q[None]
        masks = []
        for vs, pf in zip(vsearchers, prefilters):
            combined = vs.index.base_mask()
            if pf.is_none:
                combined[:] = False
            else:
                vreq = VectorSearchRequest(
                    vectors=q,
                    top_k=request.top_k,
                    filter=request.filter,
                    field_filter=pf,
                    key_prefixes=list(request.key_filters) or None,
                    min_score=request.min_score_semantic,
                    include_hidden=request.include_hidden,
                    with_duplicates=request.with_duplicates,
                    filter_operator=request.leg_filter_operator,
                )
                m = vs._build_mask(vreq)
                if m is not None:
                    full = np.zeros(vs.index.p_pad, bool)
                    full[: m.shape[0]] = m[: vs.index.p_pad]
                    combined &= full
            masks.append(combined)

        scores, ids = group.search(
            q,
            request.top_k,
            masks,
            min_score=request.min_score_semantic,
            with_duplicates=request.with_duplicates,
        )

        # keyword legs: one mesh program for every co-resident shard (None
        # entries: that shard runs its paragraph leg per shard)
        para_results = self._mesh_paragraph_legs(
            tuple(shard_ids), searchers, request, prefilters
        )

        futures = []
        for i, (sh, vs, pf) in enumerate(zip(searchers, vsearchers, prefilters)):
            if pf.is_none:
                # parity with the per-shard path: an empty prefilter clears
                # every downstream leg of that shard
                futures.append(ShardSearchResponse(prefilter=pf))
                continue
            vhits = vs.index.hits(scores[i, 0], ids[i, 0])
            futures.append(
                _MESH_SHARD_POOL.submit(
                    sh.search, request, prefilter=pf, vector_hits=vhits,
                    paragraph_response=para_results[i],
                )
            )
        return [f if isinstance(f, ShardSearchResponse) else f.result() for f in futures]

    def _mesh_paragraph_legs(
        self, shard_ids: tuple, searchers: list, request: ShardSearchRequest,
        prefilters: list,
    ) -> "list":
        """Run every co-resident shard's paragraph (BM25) leg as ONE mesh
        program (parallel/text_group.py). Returns one ParagraphSearchResponse
        per shard, or all None where the group path does not apply —
        phrase queries, deep-pagination cursors and layout-mismatched
        engines run through the per-shard path with the same results
        (parity: nidx/src/searcher/shard_search.rs:211-273 runs every leg
        inside the per-shard fan-out)."""
        none: list = [None] * len(searchers)
        if not (request.paragraph and request.body.strip()):
            return none
        psearchers = [sh.paragraph for sh in searchers]
        if all(
            p is not None and p.engine.host_tier() is not None
            for p in psearchers
        ):
            # cost-model routing: with the host WAND tier active, each
            # shard's keyword leg runs on the host inside the per-shard
            # fan-out, beside the vector group program on the device (the
            # reference's own split: tantivy on the CPU, shard_search.rs)
            return none
        group = self._mesh_text_group(shard_ids, psearchers)
        if group is None:
            return none
        from ..index.paragraph import ParagraphSearchRequest

        preqs, queries, active = [], [], 0
        for p, pf in zip(psearchers, prefilters):
            if pf.is_none:
                preqs.append(None)
                queries.append(None)
                continue
            preq = ParagraphSearchRequest(
                query=request.body,
                top_k=request.top_k,
                filter=request.filter,
                field_filter=pf,
                key_prefixes=list(request.key_filters) or None,
                min_score=request.min_score_bm25,
                all_terms=request.all_terms,
                advanced_query=request.advanced_query,
                search_after=request.search_after,
                filter_operator=request.leg_filter_operator,
            )
            q = p.plan_kernel_query(preq)
            if q is None:
                return none  # a miss of the simple regime: per shard for all
            preqs.append(preq)
            queries.append(q)
            active += 1
        if active == 0:
            return none
        top_s, top_ic, counts = group.search(queries, request.top_k)
        return [
            None if q is None
            else p.finish_kernel(preq, q, top_s[i], top_ic[i], int(counts[i]))
            for i, (p, preq, q) in enumerate(zip(psearchers, preqs, queries))
        ]

    def _mesh_text_group(self, shard_ids: tuple, psearchers: list):
        from ..parallel.text_group import MeshTextGroup

        if any(p is None for p in psearchers):
            return None
        ident = tuple((id(p.engine), p.engine.n_docs) for p in psearchers)
        cached = self._mesh_text_groups.get(shard_ids)
        if cached is not None and cached[0] == ident:
            self._mesh_text_groups.move_to_end(shard_ids)
            return cached[1]
        if not MeshTextGroup.eligible(psearchers):
            return None
        group = MeshTextGroup(psearchers)
        self._mesh_text_groups[shard_ids] = (ident, group)
        self._mesh_text_groups.move_to_end(shard_ids)
        while len(self._mesh_text_groups) > 8:
            self._mesh_text_groups.popitem(last=False)
        return group
