"""Rendezvous (HRW) hashing: shard -> ordered replica nodes."""

from __future__ import annotations

import hashlib
from typing import Sequence


def _score(node: str, shard_id: str) -> int:
    h = hashlib.blake2b(f"{node}\x00{shard_id}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


class ShardSelector:
    """Deterministic shard placement over a set of nodes.

    Every node computes the same ordering with no coordination; when a node
    joins/leaves only ~1/n of shards move (the rendezvous property the
    reference relies on for searcher elasticity, shard_selector.rs).
    """

    def __init__(self, nodes: Sequence[str], replication: int = 2):
        self.nodes = list(dict.fromkeys(nodes))
        self.replication = replication

    def set_nodes(self, nodes: Sequence[str]) -> bool:
        """Replace the node set in place (topology change); holders of this
        selector — searchers gating shard ownership, scatter routers — see
        the new placement on their next call. Returns True if it changed."""
        new = list(dict.fromkeys(nodes))
        if new == self.nodes:
            return False
        self.nodes = new
        return True

    def nodes_for_shard(self, shard_id: str) -> list[str]:
        ranked = sorted(self.nodes, key=lambda n: _score(n, shard_id), reverse=True)
        return ranked[: max(self.replication, 1)]

    def primary(self, shard_id: str) -> str:
        return self.nodes_for_shard(shard_id)[0]

    def with_nodes(self, nodes: Sequence[str]) -> "ShardSelector":
        return ShardSelector(nodes, self.replication)

    def owned_shards(self, node: str, shard_ids: Sequence[str]) -> list[str]:
        """Shards this node must keep synced (any replica slot)."""
        return [s for s in shard_ids if node in self.nodes_for_shard(s)]
