"""Multi-device (mesh) execution: sharded indexes and collective merges.

Counterpart of ``nucliadb_tpu/parallel/``, the replacement for the
reference's distributed search plane (nidx/src/searcher/{shard_selector,
shards_query,shard_merge,grpc}.rs): a knowledge box's co-resident shards
are members of a device mesh, a query runs on every member and the
per-member top-k cuts merge with an all-gather, in place of per-shard gRPC
fan-out and a host-side merge. The mesh is ``parallel/mesh.py``'s: one
process, a loop over the members in order, the all-gather a copy to the
mesh's first device. Host-level placement across machines (rendezvous
hashing) stays a host concern (the services layer).
"""

from .hybrid_mesh import MeshHybridIndex
from .mesh import Mesh, MeshShardedVectorIndex, make_mesh
from .text_mesh import MeshShardedTextEngine

__all__ = [
    "MeshShardedVectorIndex", "MeshShardedTextEngine", "MeshHybridIndex",
    "make_mesh", "Mesh",
]
