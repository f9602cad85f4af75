"""Shard: the unit of index partitioning.

The port's copy of ``nucliadb_tpu/shard/__init__.py``,
kept verbatim: the port imports nothing of the JAX package.

A shard holds one index per kind — text, paragraph, relation, json, plus one
vector index per vectorset (parity: nidx metadata ``indexes`` table rows per
shard, nidx/src/metadata/index.rs). The indexer writes one segment per
affected index per operation; the searcher opens all indexes of a shard and
executes planned searches across them (see planner.py / searcher.py).
"""

from .config import ShardConfig
from .indexer import ShardIndexer
from .searcher import ShardSearcher, ShardSearchRequest, ShardSearchResponse

__all__ = [
    "ShardConfig",
    "ShardIndexer",
    "ShardSearcher",
    "ShardSearchRequest",
    "ShardSearchResponse",
]
