"""Index metadata store: shards, indexes, segments, deletions, merge jobs.

The port's copy of ``nucliadb_tpu/metadata/__init__.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity with the reference's nidx PG metadata
(nidx/src/metadata/*.rs, schema nidx/migrations/20241007163501_initial.sql):
same tables and lifecycle — segments are born with a ``delete_at`` grace
timestamp and become visible when marked ready in the same transaction that
records deletions and bumps the index's ``updated_at`` (the searcher's sync
signal); merge jobs are leased with heartbeats and retried.

Backend: sqlite (embedded; the image has no PostgreSQL). The store API is
narrow so a PG implementation can slot in for multi-node deployments.
"""

from .store import IndexMeta, MergeJob, MetadataStore, SegmentRow, ShardMeta

__all__ = ["MetadataStore", "ShardMeta", "IndexMeta", "SegmentRow", "MergeJob"]
