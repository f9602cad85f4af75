"""Embedded node: all services in one process for standalone mode.

Counterpart of ``nucliadb_tpu/services/binding.py`` with an explicit torch
``device`` for the searchers (default ``"cuda"``; a CUDA node on a machine
without a card raises). Indexing, merging and the metadata store are host
work and the JAX package's, copied.

Parity: the reference's PyO3 binding (nidx/nidx_binding/src/lib.rs:53-199)
which embeds indexer+scheduler+worker+searcher with an atomic seq counter
replacing NATS and a watch channel for sync. Here the same composition is
plain Python; ``wait_for_sync`` runs the sync loop body inline (deterministic
for tests and standalone), and ``tick_background`` runs one scheduler +
worker round (the standalone runtime calls it periodically).
"""

from __future__ import annotations

import os
import tempfile
import uuid

import torch

from ..index.vector.config import VectorConfig
from ..metadata import MetadataStore
from ..models.internal import ResourceDoc
from ..shard import ShardSearchRequest, ShardSearchResponse
from ..storage import LocalStorage, Storage
from ..types import IndexKind, Seq
from ..utils.platform import resolve_device
from .indexer import IndexerService
from .scheduler import SchedulerService
from .searcher import SyncedSearcher
from .worker import WorkerService


class EmbeddedNode:
    def __init__(
        self,
        data_dir: str | None = None,
        storage: Storage | None = None,
        metadata: MetadataStore | None = None,
        selector=None,
        node_name: str | None = None,
        *,
        device: "str | torch.device" = "cuda",
    ):
        """``metadata``/``storage`` default to sqlite/file backends under
        ``data_dir``, which is also the node's local scratch (segment build
        dirs, searcher cache). ``device`` is where the searchers hold their
        arenas and run their programs."""
        self.device = resolve_device(device)
        self.data_dir = data_dir or tempfile.mkdtemp(prefix="ndbtpu_node_")
        os.makedirs(self.data_dir, exist_ok=True)
        self.metadata = (
            metadata
            if metadata is not None
            else MetadataStore(os.path.join(self.data_dir, "metadata.db"))
        )
        self.storage = storage if storage is not None else LocalStorage(
            os.path.join(self.data_dir, "blobs")
        )
        self.indexer = IndexerService(
            self.metadata, self.storage, os.path.join(self.data_dir, "indexer")
        )
        self.scheduler = SchedulerService(self.metadata, self.storage)
        self.worker = WorkerService(
            self.metadata, self.storage, os.path.join(self.data_dir, "worker")
        )
        self.searcher = SyncedSearcher(
            self.metadata, self.storage, os.path.join(self.data_dir, "segments"),
            selector=selector, node_name=node_name, device=self.device,
        )

    # ---- shard/index lifecycle (parity: NidxApi NewShard/vectorsets) ------

    def create_shard(
        self,
        kbid: str,
        vectorsets: dict[str, VectorConfig],
        shard_id: str | None = None,
    ) -> str:
        shard_id = shard_id or uuid.uuid4().hex
        self.metadata.create_shard(shard_id, kbid)
        for kind in (IndexKind.TEXT, IndexKind.PARAGRAPH, IndexKind.RELATION, IndexKind.JSON):
            self.metadata.create_index(shard_id, kind.value, kind.value)
        for name, config in vectorsets.items():
            self.metadata.create_index(shard_id, "vector", name, config.to_dict())
        return shard_id

    def add_vectorset(self, shard_id: str, name: str, config: VectorConfig) -> None:
        self.metadata.create_index(shard_id, "vector", name, config.to_dict())

    def delete_vectorset(self, shard_id: str, name: str) -> None:
        """Drop a vector index: metadata row soft-deletes, segments retire
        into the purge loop, searchers drop it at next sync."""
        for index in self.metadata.get_indexes(shard_id):
            if index.kind == "vector" and index.name == name:
                self.metadata.retire_index_segments(index.id)
                self.metadata.delete_index(index.id)

    def list_vectorsets(self, shard_id: str) -> list[str]:
        """Parity: NidxApi.ListVectorSets (nidx.proto:17)."""
        return sorted(
            index.name
            for index in self.metadata.get_indexes(shard_id)
            if index.kind == "vector"
        )

    def configure_shards(self, configs: list[dict]) -> None:
        """Parity: NidxApi.ConfigureShards (nidx.proto:13, ShardsConfig) —
        per-shard knobs; prewarm_enabled makes searchers load the shard's
        device arenas eagerly at sync instead of on first query."""
        for cfg in configs:
            self.metadata.update_shard_config(
                cfg["shard_id"],
                {"prewarm_enabled": bool(cfg.get("prewarm_enabled", False))},
            )

    def delete_shard(self, shard_id: str) -> None:
        self.metadata.delete_shard(shard_id)

    # ---- data plane ---------------------------------------------------------

    def index(self, shard_id: str, resource: ResourceDoc, *, hidden: bool = False) -> Seq:
        return self.indexer.index_resource(shard_id, resource, hidden=hidden)

    def delete_resource(self, shard_id: str, resource_id: str) -> Seq:
        return self.indexer.delete_resource(shard_id, resource_id)

    def wait_for_sync(self) -> list[str]:
        """Synchronize searchers with the latest committed state."""
        return self.searcher.sync()

    def search(self, shard_id: str, request: ShardSearchRequest) -> ShardSearchResponse:
        return self.searcher.search(shard_id, request)

    def search_multi(
        self, shard_ids: "list[str]", request: ShardSearchRequest
    ) -> "list[ShardSearchResponse]":
        """Search several shards (concurrently, one task per shard)."""
        return self.searcher.search_multi(shard_ids, request)

    def extracted_texts(
        self,
        shard_id: str,
        field_ids: "list[dict] | None" = None,
        paragraph_ids: "list[dict] | None" = None,
    ) -> dict[str, dict[str, str]]:
        """Parity: NidxSearcher.ExtractedTexts (nidx.proto:25) — extracted
        text served from the index's stored field text."""
        return self.searcher.shard(shard_id).extracted_texts(
            field_ids, paragraph_ids
        )

    # ---- background round ---------------------------------------------------

    def tick_background(self) -> dict:
        """One scheduler round + drain the merge queue (standalone cadence)."""
        jobs = self.scheduler.tick()
        merged = 0
        while self.worker.run_one():
            merged += 1
        return {"jobs_enqueued": jobs, "merged": merged}
