"""Cross-node search plane: placement, scatter-gather, response merging.

Parity with the reference's distributed searcher
(nidx/src/searcher/{shard_selector,shards_query,shard_merge,grpc}.rs):
- rendezvous (highest-random-weight) hashing assigns each shard an ordered
  replica list over the live searcher nodes (shard_selector.rs:178-247),
- queries scatter per shard to the first replica and fail over to the next
  on error (grpc.rs:253-466), tolerating shards that are mid-handoff,
- per-shard responses merge by score/order into one (shard_merge.rs:54-332).

Node liveness here comes from an injectable topology (the reference watches
Kubernetes pods); tests simulate node loss and network partitions in-process
exactly like the reference's SearcherCluster fixtures
(nidx/tests/common/cluster.rs:27-76).

Within one process, co-resident shards are members of a mesh of cards
(parallel/mesh.py); this layer spans processes and hosts over gRPC.
"""

from .selector import ShardSelector
from .distributed import DistributedSearcher, merge_shard_responses
from .topology import TopologyWatcher

__all__ = [
    "ShardSelector",
    "DistributedSearcher",
    "merge_shard_responses",
    "TopologyWatcher",
]
