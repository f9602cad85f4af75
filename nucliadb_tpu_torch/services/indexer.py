"""Indexer service: one index operation -> segments + atomic metadata commit.

The port's copy of ``nucliadb_tpu/services/indexer.py`` (the port imports
nothing of the JAX package), with a ``device`` on which the graphs and
centroids of flagged vectorsets are built.

Parity: nidx/src/indexer.rs:254-419 — per-index fan-out, segment upload,
single metadata transaction marking segments ready + recording deletions +
bumping updated_at, then ack.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

from ..index.vector.config import VectorConfig
from ..metadata import MetadataStore
from ..models.internal import ResourceDoc
from ..shard import ShardConfig, ShardIndexer
from ..storage import Storage
from ..types import Seq


class IndexerService:
    def __init__(
        self,
        metadata: MetadataStore,
        storage: Storage,
        work_dir: str | None = None,
        *,
        device: "str | torch.device" = "cuda",
    ):
        self.metadata = metadata
        self.device = device
        self.storage = storage
        self.work_dir = work_dir or tempfile.mkdtemp(prefix="ndbtpu_indexer_")
        from ..telemetry.metrics import UtilizationTracker

        self.utilization = UtilizationTracker("indexer")

    def _shard_config(self, shard_id: str, index_rows=None) -> ShardConfig:
        shard = self.metadata.get_shard(shard_id)
        if shard is None:
            raise KeyError(f"unknown shard {shard_id}")
        vectorsets = {}
        if index_rows is None:
            index_rows = self.metadata.get_indexes(shard_id)
        for index in index_rows:
            if index.kind == "vector":
                vectorsets[index.name] = VectorConfig.from_dict(index.configuration)
        return ShardConfig(shard_id=shard_id, kbid=shard.kbid, vectorsets=vectorsets)

    def index_resource(
        self,
        shard_id: str,
        resource: ResourceDoc,
        *,
        seq: Optional[Seq] = None,
        hidden: bool = False,
    ) -> Seq:
        """Index one resource into a shard at the given (or next) seq."""
        from ..telemetry.tracing import span

        if seq is None:
            # next_seq + record fused: one txn/RPC (HA ships each mutating
            # RPC synchronously, so RPC count IS the replication cost)
            seq = self.metadata.open_index_request()
        else:
            self.metadata.record_index_request(seq)
        with self.utilization.work(), span(
            "indexer.index_resource", shard_id=shard_id, seq=int(seq)
        ):
            return self._index_resource(shard_id, resource, seq, hidden)

    def _index_resource(self, shard_id, resource, seq, hidden) -> Seq:
        from ..storage.storage import pack_segment

        op_dir = os.path.join(self.work_dir, f"op_{int(seq)}")
        try:
            index_rows = self.metadata.get_indexes(shard_id)
            config = self._shard_config(shard_id, index_rows)
            indexes = {i.full_name: i for i in index_rows}
            shard_indexer = ShardIndexer(config, device=self.device)
            ops = shard_indexer.index_resource(resource, op_dir, hidden=hidden)

            deletions: list[tuple[int, Seq, list[str]]] = []
            touched: list[int] = []
            specs: list[dict] = []
            blobs: list[bytes] = []
            for op in ops:
                index = indexes.get(op.index_name)
                if index is None:
                    continue
                touched.append(index.id)
                deletions.append((index.id, seq, op.deletions))
                if op.segment is None:
                    continue
                # pack FIRST so the batched create carries final sizes —
                # one metadata txn/RPC for all of the operation's segments
                data = pack_segment(op.segment.path)
                blobs.append(data)
                specs.append({
                    "index_id": index.id,
                    "seq": seq,
                    "records": op.segment.records,
                    "size_bytes": len(data),
                    "tags": sorted(op.segment.tags),
                    "index_metadata": op.segment.index_metadata,
                })
            rows = self.metadata.create_segments(specs) if specs else []
            ready: list[int] = []
            for row, data in zip(rows, blobs):
                self.storage.put(row.storage_key, data)
                ready.append(row.id)

            self.metadata.commit_operation(
                ready_segments=ready, deletions=deletions, touched_indexes=touched
            )
        finally:
            # the seq must leave the unacked set even on failure, or the
            # merge ack floor wedges forever (retries arrive under a NEW seq,
            # matching the bus's skip+ack poison semantics; the reference's
            # floor comes from NATS, which advances the same way)
            self.metadata.ack_index_request(seq)
            shutil.rmtree(op_dir, ignore_errors=True)
        return seq

    def delete_resource(self, shard_id: str, resource_id: str) -> Seq:
        """Record deletions for a whole resource across every index
        (parity: indexer.rs Deletion operation path)."""
        seq = self.metadata.open_index_request()
        try:
            prefix = resource_id + "/"
            deletions = []
            touched = []
            for index in self.metadata.get_indexes(shard_id):
                deletions.append((index.id, seq, [prefix]))
                touched.append(index.id)
            self.metadata.commit_operation(
                ready_segments=[], deletions=deletions, touched_indexes=touched
            )
        finally:
            self.metadata.ack_index_request(seq)
        return seq
