"""Knowledge box + shard management.

The port's copy of ``nucliadb_tpu/common/kb.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity with the reference's cluster manager and KB datamanagers
(nucliadb/src/nucliadb/common/cluster/manager.py:51 KBShardManager,
common/datamanagers/kb.py): a KB owns N shards; writes go to the current
writable shard; searches fan out over all shards. Shard state lives in the
main KV under ``/kbs/{kbid}/shards``; resources record their shard so
updates and deletes route correctly.
"""

from __future__ import annotations

import json
import time
import uuid
from dataclasses import dataclass
from typing import Optional

from ..index.vector.config import Quantization, Similarity, VectorCardinality, VectorConfig
from ..maindb import Driver
from ..models.api import KnowledgeBoxConfig, VectorSetSpec
from ..services import EmbeddedNode

KB_CONFIG = "/kbs/{kbid}/config"
KB_SHARDS = "/kbs/{kbid}/shards"
KB_SLUG = "/kbslugs/{slug}"
KB_PREFIX = "/kbs/{kbid}/"
RESOURCE_PAYLOAD = "/kbs/{kbid}/r/{rid}/payload"
RESOURCE_META = "/kbs/{kbid}/r/{rid}/meta"
RESOURCE_SLUG = "/kbs/{kbid}/rslugs/{slug}"

# resources per shard before a new writable shard is created (the reference
# sizes shards by paragraph count; see common/cluster settings)
MAX_RESOURCES_PER_SHARD = 250_000


def vector_config_from_spec(spec: VectorSetSpec) -> VectorConfig:
    return VectorConfig(
        dimension=spec.dimension,
        similarity=Similarity(spec.similarity),
        cardinality=VectorCardinality.MULTI if spec.multivector else VectorCardinality.SINGLE,
        quantization=Quantization(spec.quantization),
    )


@dataclass
class KBShards:
    shards: list[str]
    writable: int
    counts: dict[str, int]


class KnowledgeBoxManager:
    def __init__(self, driver: Driver, node: EmbeddedNode):
        self.driver = driver
        self.node = node
        # serializes read-modify-write of the shard record: HTTP handlers run
        # on a thread pool, and a concurrent record_resource during rollover
        # would write stale (deleted) shard ids back (multi-process
        # deployments move this to a KV-level compare-and-swap)
        import threading

        self._shards_mutex = threading.Lock()
        self._external_indexes: dict = {}
        # kbid -> (inserted_at, config); see get_config
        self._config_cache: dict[str, tuple[float, object]] = {}

    def external_index(self, kbid: str):
        """The KB's ExternalIndexManager, or None (parity: the reference
        instantiates one manager per KB with an external provider config)."""
        if kbid in self._external_indexes:
            return self._external_indexes[kbid]
        config = self.get_config(kbid)
        manager = None
        if config is not None and config.external_index_provider:
            from .external_index import get_provider

            spec = dict(config.external_index_provider)
            provider = get_provider(spec.pop("type"))
            manager = provider(**spec)
        self._external_indexes[kbid] = manager
        return manager

    # ---- lifecycle -------------------------------------------------------

    def create(self, config: KnowledgeBoxConfig, kbid: str | None = None) -> str:
        kbid = kbid or uuid.uuid4().hex
        if config.slug and self.resolve_slug(config.slug) is not None:
            # check BEFORE creating shards: a rejected create must not leak
            # orphaned node shards
            raise KeyError(f"kb slug already exists: {config.slug}")
        vectorsets = {
            name: vector_config_from_spec(spec)
            for name, spec in config.vectorsets.items()
        }
        shard_ids = [
            self.node.create_shard(kbid, vectorsets) for _ in range(max(config.shards, 1))
        ]
        try:
            with self.driver as txn:
                if config.slug:
                    existing = txn.get(KB_SLUG.format(slug=config.slug))
                    if existing is not None:
                        raise KeyError(f"kb slug already exists: {config.slug}")
                    txn.set(KB_SLUG.format(slug=config.slug), kbid.encode())
                txn.set(
                    KB_CONFIG.format(kbid=kbid),
                    config.model_dump_json().encode(),
                )
                txn.set(
                    KB_SHARDS.format(kbid=kbid),
                    json.dumps(
                        {"shards": shard_ids, "writable": 0, "counts": {s: 0 for s in shard_ids}}
                    ).encode(),
                )
        except KeyError:
            # the pre-check raced another create with the same slug: the
            # node shards made above would otherwise leak forever
            for sid in shard_ids:
                self.node.delete_shard(sid)
            raise
        return kbid

    # every request re-parses the KB config (auth, vectorset resolution,
    # hidden-resources policy); a short-TTL memo cuts the per-query pydantic
    # parse. Local writes invalidate; multi-worker replicas see at most TTL
    # staleness (same bound as their searcher sync).
    CONFIG_TTL = 2.0

    def _config_invalidate(self, kbid: str) -> None:
        self._config_cache.pop(kbid, None)

    def get_config(self, kbid: str) -> Optional[KnowledgeBoxConfig]:
        import time as _time

        now = _time.time()
        hit = self._config_cache.get(kbid)
        if hit is not None and now - hit[0] < self.CONFIG_TTL:
            return hit[1]
        with self.driver as txn:
            raw = txn.get(KB_CONFIG.format(kbid=kbid))
        config = KnowledgeBoxConfig.model_validate_json(raw) if raw else None
        if len(self._config_cache) >= 256:
            self._config_cache.pop(next(iter(self._config_cache)), None)
        self._config_cache[kbid] = (now, config)
        return config

    def update_config(self, kbid: str, patch: dict) -> "KnowledgeBoxConfig":
        """Patch title/description/slug (parity: writer PATCH /kb/{kbid}).
        Vectorsets/shards/provider change through their dedicated APIs."""
        config = self.get_config(kbid)
        if config is None:
            raise KeyError(kbid)
        allowed = {k: v for k, v in patch.items()
                   if k in ("title", "description", "slug")}
        # validate BEFORE persisting: model_copy skips pydantic validation
        # and a bad value would poison every later get_config()
        updated = KnowledgeBoxConfig.model_validate(
            {**config.model_dump(), **allowed}
        )
        new_slug = updated.slug
        with self.driver as txn:
            if new_slug != config.slug:
                if new_slug:
                    existing = txn.get(KB_SLUG.format(slug=new_slug))
                    if existing is not None and existing.decode() != kbid:
                        raise KeyError(f"kb slug already exists: {new_slug}")
                    txn.set(KB_SLUG.format(slug=new_slug), kbid.encode())
                if config.slug:
                    txn.delete(KB_SLUG.format(slug=config.slug))
            txn.set(KB_CONFIG.format(kbid=kbid), updated.model_dump_json().encode())
        self._config_invalidate(kbid)
        return updated

    def resolve_slug(self, slug: str) -> Optional[str]:
        with self.driver as txn:
            raw = txn.get(KB_SLUG.format(slug=slug))
        return raw.decode() if raw else None

    def list_kbs(self) -> list[str]:
        with self.driver as txn:
            keys = list(txn.keys("/kbs/"))
        return sorted({k.split("/")[2] for k in keys})

    def delete(self, kbid: str) -> None:
        self._external_indexes.pop(kbid, None)
        shards = self.get_shards(kbid)
        config = self.get_config(kbid)
        with self.driver as txn:
            if config and config.slug:
                txn.delete(KB_SLUG.format(slug=config.slug))
            txn.delete_by_prefix(KB_PREFIX.format(kbid=kbid))
        self._config_invalidate(kbid)
        for key in list(self.node.storage.list(f"blobs/{kbid}/")):
            self.node.storage.delete(key)
        if shards:
            for shard_id in shards.shards:
                self.node.delete_shard(shard_id)

    def add_vectorset(self, kbid: str, name: str, spec: VectorSetSpec) -> None:
        config = self.get_config(kbid)
        if config is None:
            raise KeyError(kbid)
        config.vectorsets[name] = spec
        shards = self.get_shards(kbid)
        for shard_id in shards.shards:
            self.node.add_vectorset(shard_id, name, vector_config_from_spec(spec))
        with self.driver as txn:
            txn.set(KB_CONFIG.format(kbid=kbid), config.model_dump_json().encode())
        self._config_invalidate(kbid)

    def delete_vectorset(self, kbid: str, name: str) -> None:
        """Remove a vectorset and purge its per-shard indexes (parity:
        writer vectorsets DELETE + purge_kb_vectorsets)."""
        config = self.get_config(kbid)
        if config is None or name not in config.vectorsets:
            raise KeyError(f"unknown vectorset {name}")
        del config.vectorsets[name]
        shards = self.get_shards(kbid)
        for shard_id in shards.shards if shards else []:
            self.node.delete_vectorset(shard_id, name)
        with self.driver as txn:
            txn.set(KB_CONFIG.format(kbid=kbid), config.model_dump_json().encode())
        self._config_invalidate(kbid)

    # ---- shards ----------------------------------------------------------

    def get_shards(self, kbid: str) -> Optional[KBShards]:
        with self.driver as txn:
            raw = txn.get(KB_SHARDS.format(kbid=kbid))
        if raw is None:
            return None
        d = json.loads(raw)
        return KBShards(shards=d["shards"], writable=d["writable"], counts=d["counts"])

    def _save_shards(self, kbid: str, shards: KBShards) -> None:
        with self.driver as txn:
            txn.set(
                KB_SHARDS.format(kbid=kbid),
                json.dumps(
                    {
                        "shards": shards.shards,
                        "writable": shards.writable,
                        "counts": shards.counts,
                    }
                ).encode(),
            )

    def writable_shard(self, kbid: str) -> str:
        """The shard new resources go to; rolls over when full
        (parity: KBShardManager shard creation on overflow)."""
        with self._shards_mutex:
            shards = self.get_shards(kbid)
            if shards is None:
                raise KeyError(f"unknown kb {kbid}")
            current = shards.shards[shards.writable]
            if shards.counts.get(current, 0) >= MAX_RESOURCES_PER_SHARD:
                config = self.get_config(kbid)
                vectorsets = {
                    name: vector_config_from_spec(spec)
                    for name, spec in (config.vectorsets if config else {}).items()
                }
                new_shard = self.node.create_shard(kbid, vectorsets)
                shards.shards.append(new_shard)
                shards.writable = len(shards.shards) - 1
                shards.counts[new_shard] = 0
                self._save_shards(kbid, shards)
                current = new_shard
            return current

    def record_resource(self, kbid: str, shard_id: str, delta: int) -> None:
        with self._shards_mutex:
            shards = self.get_shards(kbid)
            if shards is None or shard_id not in shards.counts and shard_id not in shards.shards:
                return
            shards.counts[shard_id] = max(shards.counts.get(shard_id, 0) + delta, 0)
            self._save_shards(kbid, shards)

    def swap_shards(self, kbid: str, shards: KBShards) -> None:
        """Atomically replace the KB's shard record (rollover/rebalance)."""
        with self._shards_mutex:
            self._save_shards(kbid, shards)
