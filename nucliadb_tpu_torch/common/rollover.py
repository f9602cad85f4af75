"""Rollover and rebalance: reshape a KB's shards while serving.

The port's copy of ``nucliadb_tpu/common/rollover.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity: nucliadb/src/nucliadb/common/cluster/rollover.py:631
(rollover_kb_index: rebuild every index of a KB onto fresh shards, then
atomically swap) and rebalance.py:537 (move resources between shards to
even out sizes). Both are safe-by-construction here: the old shards keep
serving until the KB shard record swaps, and every resource reindex emits
prefix deletions so replays are idempotent.
"""

from __future__ import annotations

from ..ingest.brain import ResourceBrain
from ..ingest.processor import RESOURCE_META, Processor
from ..services import EmbeddedNode
from .kb import KBShards, KnowledgeBoxManager, vector_config_from_spec


def _move_resource(
    processor: Processor, node: EmbeddedNode, kbid: str, rid: str,
    target: str, *, delete_from: str | None = None,
) -> bool:
    """Reindex one resource into ``target`` and write its meta back, under
    the processor's per-resource lock: without it a concurrent delete (which
    holds the lock) could be resurrected as a ghost — delete removes the KV
    subtree, then the mover writes the stale meta back and the new shard
    keeps an index copy of a deleted resource forever."""
    with processor.resource_lock(kbid, rid):
        payload = processor.get_payload(kbid, rid)
        meta = processor.get_meta(kbid, rid)
        if payload is None or meta is None:
            return False
        doc = ResourceBrain(rid).build(payload, created=meta.created)
        node.index(target, doc, hidden=payload.hidden)
        if delete_from is not None and delete_from != target:
            node.delete_resource(delete_from, rid)
        meta.shard = target
        with processor.driver as txn:
            txn.set(RESOURCE_META.format(kbid=kbid, rid=rid), meta.to_json())
        return True


def rollover_kb(
    kbs: KnowledgeBoxManager,
    processor: Processor,
    node: EmbeddedNode,
    kbid: str,
    *,
    n_shards: int | None = None,
) -> list[str]:
    """Reindex the whole KB onto new shards and swap. Returns new shard ids."""
    old = kbs.get_shards(kbid)
    if old is None:
        raise KeyError(f"unknown kb {kbid}")
    config = kbs.get_config(kbid)
    vectorsets = {
        name: vector_config_from_spec(spec)
        for name, spec in (config.vectorsets if config else {}).items()
    }
    count = n_shards or len(old.shards)
    new_shards = [node.create_shard(kbid, vectorsets) for _ in range(count)]

    # distribute resources round-robin over the new shards
    rids = processor.list_resources(kbid)
    counts = {s: 0 for s in new_shards}
    for i, rid in enumerate(rids):
        target = new_shards[i % count]
        if _move_resource(processor, node, kbid, rid, target):
            counts[target] += 1

    # swap the shard record...
    kbs.swap_shards(kbid, KBShards(shards=new_shards, writable=0, counts=counts))

    # ...then repair stragglers BEFORE retiring the old shards: a resource
    # written during the reindex window landed in an old shard (it got
    # writable_shard from the pre-swap record) and was not in the snapshot
    # rid list — deleting its shard would silently lose its index data and
    # leave meta.shard dead. After the swap no NEW writes can target old
    # shards, so a bounded number of passes converges.
    repaired_any = False
    for _ in range(3):
        strays = 0
        for i, rid in enumerate(processor.list_resources(kbid)):
            meta = processor.get_meta(kbid, rid)
            if meta is None or meta.shard in new_shards:
                continue
            strays += 1
            repaired_any = True
            target = new_shards[i % count]
            if _move_resource(processor, node, kbid, rid, target):
                counts[target] += 1
        if not strays:
            break
    if repaired_any:
        # recompute counts from resource metas rather than trusting the
        # incremental tallies: writes racing the swap can slip between the
        # repair passes and leave the cached counters off by a few
        counts = {s: 0 for s in new_shards}
        for rid in processor.list_resources(kbid):
            meta = processor.get_meta(kbid, rid)
            if meta is not None and meta.shard in counts:
                counts[meta.shard] += 1
        kbs.swap_shards(kbid, KBShards(shards=new_shards, writable=0, counts=counts))

    for shard_id in old.shards:
        node.delete_shard(shard_id)
    return new_shards


def rebalance_kb(
    kbs: KnowledgeBoxManager,
    processor: Processor,
    node: EmbeddedNode,
    kbid: str,
) -> dict[str, int]:
    """Move resources from overfull shards to the emptiest ones until the
    spread is within 10% (parity intent: rebalance.py)."""
    shards = kbs.get_shards(kbid)
    if shards is None or len(shards.shards) < 2:
        return {}
    rid_by_shard: dict[str, list[str]] = {s: [] for s in shards.shards}
    for rid in processor.list_resources(kbid):
        meta = processor.get_meta(kbid, rid)
        if meta is not None and meta.shard in rid_by_shard:
            rid_by_shard[meta.shard].append(rid)
    total = sum(len(v) for v in rid_by_shard.values())
    target = total // len(shards.shards)
    moved = 0
    for src, rids in rid_by_shard.items():
        while len(rids) > target + max(1, target // 10):
            dst = min(rid_by_shard, key=lambda s: len(rid_by_shard[s]))
            if dst == src:
                break
            rid = rids.pop()
            if not _move_resource(
                processor, node, kbid, rid, dst, delete_from=src
            ):
                continue
            rid_by_shard[dst].append(rid)
            moved += 1
    counts = {s: len(v) for s, v in rid_by_shard.items()}
    shards.counts = counts
    kbs.swap_shards(kbid, shards)
    return counts
