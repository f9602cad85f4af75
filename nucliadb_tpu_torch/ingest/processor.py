"""Processor: resource CRUD -> KV state + index operations.

The port's copy of ``nucliadb_tpu/ingest/processor.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity with the reference's Processor
(nucliadb/src/nucliadb/ingest/orm/processor/processor.py:138-300): persists
the resource, builds the brain, routes the index message to the node, and
keeps the catalog (resource listing) consistent. Sequencing: the node's seq
counter provides the total order the reference gets from NATS.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

from ..common.kb import (
    KnowledgeBoxManager,
    RESOURCE_META,
    RESOURCE_PAYLOAD,
    RESOURCE_SLUG,
)
from ..maindb import Driver
from ..models.api import CreateResourcePayload, UpdateResourcePayload
from ..models.internal import ResourceStatus
from ..services import EmbeddedNode
from .brain import ResourceBrain


@dataclass
class ResourceMeta:
    rid: str
    shard: str
    slug: str
    created: float
    modified: float
    status: str = "PROCESSED"

    def to_json(self) -> bytes:
        return json.dumps(self.__dict__).encode()

    @staticmethod
    def from_json(raw: bytes) -> "ResourceMeta":
        return ResourceMeta(**json.loads(raw))


class Processor:
    def __init__(self, driver: Driver, node: EmbeddedNode, kbs: KnowledgeBoxManager):
        self.driver = driver
        self.node = node
        self.kbs = kbs
        from ..common.locking import KeyedLock

        # per-resource exclusion for read-modify-write updates (parity:
        # the reference's distributed resource lock, processor.py:221-223 —
        # two concurrent PATCHes would otherwise lose one side's fields)
        self._resource_locks = KeyedLock()
        self._payload_cache_local = threading.local()
        # (kbid, rid) -> (inserted_at, payload); see get_payload
        self._payload_lru: dict[tuple[str, str], tuple[float, object]] = {}

    # ---- writes ------------------------------------------------------------

    def create_resource(
        self, kbid: str, payload: CreateResourcePayload, rid: str | None = None,
        *, created: float | None = None,
    ) -> tuple[str, int]:
        rid = rid or uuid.uuid4().hex
        with self._resource_locks.hold(f"{kbid}/{rid}"):
            return self._create_resource(kbid, payload, rid, created=created)

    def _create_resource(
        self, kbid: str, payload: CreateResourcePayload, rid: str,
        *, created: float | None = None,
    ) -> tuple[str, int]:
        # a meta row for this rid means a redelivered create (at-least-once
        # bus, commit stamps the rid): idempotent replay must reuse the
        # original shard (a rollover in between would otherwise strand an
        # un-deletable copy in the old shard), keep the original creation
        # time, and not inflate the shard's resource count
        prev = self.get_meta(kbid, rid)
        shard_id = prev.shard if prev is not None else self.kbs.writable_shard(kbid)
        now = time.time()
        # imports/restores carry the original creation time — stamping
        # import time would break date-range filters and ordering
        if prev is not None:
            created_at = prev.created
        elif created is not None:
            created_at = created
        else:
            created_at = now
        meta = ResourceMeta(
            rid=rid, shard=shard_id, slug=payload.slug,
            created=created_at, modified=now,
        )
        with self.driver as txn:
            if payload.slug:
                existing = txn.get(RESOURCE_SLUG.format(kbid=kbid, slug=payload.slug))
                # a slug mapping to the SAME rid is a redelivered create
                # (at-least-once bus): overwrite instead of poisoning
                if existing is not None and existing.decode() != rid:
                    raise KeyError(f"resource slug exists: {payload.slug}")
                txn.set(RESOURCE_SLUG.format(kbid=kbid, slug=payload.slug), rid.encode())
            txn.set(
                RESOURCE_PAYLOAD.format(kbid=kbid, rid=rid),
                payload.model_dump_json().encode(),
            )
            txn.set(RESOURCE_META.format(kbid=kbid, rid=rid), meta.to_json())
        self._payload_invalidate(kbid, rid)
        doc = ResourceBrain(rid).build(payload, created=meta.created)
        self._route_external_index(kbid, doc)
        seq = self.node.index(shard_id, doc, hidden=payload.hidden)
        if prev is None:
            self.kbs.record_resource(kbid, shard_id, +1)
        return rid, int(seq)

    def _route_external_index(self, kbid: str, doc) -> None:
        """When the KB has an external index provider, ship its vectors
        there and strip them from the node doc (parity: the external-index
        route in Processor.txn + IndexMessageBuilder skipping vectors,
        external_index_providers/base.py:126)."""
        manager = self.kbs.external_index(kbid)
        if manager is None:
            return
        # updates must drop removed paragraphs' vectors first (the node path
        # gets this from prefix deletions; providers expose the same contract
        # via delete_resource)
        manager.delete_resource(doc.resource_id)
        vectorsets = {
            name
            for paragraphs in doc.paragraphs.values()
            for para in paragraphs.values()
            for name in para.vectorsets_sentences
        }
        for name in vectorsets:
            manager.index_resource(doc, name)
        for paragraphs in doc.paragraphs.values():
            for para in paragraphs.values():
                para.vectorsets_sentences = {}

    def resource_lock(self, kbid: str, rid: str):
        """Per-resource exclusion context — shared with rollover/rebalance
        so a concurrent delete can't be resurrected by a meta write-back."""
        return self._resource_locks.hold(f"{kbid}/{rid}")

    def update_resource(
        self, kbid: str, rid: str, payload: UpdateResourcePayload
    ) -> int:
        with self._resource_locks.hold(f"{kbid}/{rid}"):
            return self._update_resource(kbid, rid, payload)

    def _update_resource(
        self, kbid: str, rid: str, payload: UpdateResourcePayload
    ) -> int:
        meta = self.get_meta(kbid, rid)
        if meta is None:
            raise KeyError(f"unknown resource {rid}")
        current = self.get_payload(kbid, rid)
        merged = CreateResourcePayload.model_validate(
            {**current.model_dump(), **payload.model_dump(exclude_unset=True)}
        )
        meta.modified = time.time()
        with self.driver as txn:
            if merged.slug != meta.slug:
                if merged.slug:
                    existing = txn.get(RESOURCE_SLUG.format(kbid=kbid, slug=merged.slug))
                    if existing is not None and existing.decode() != rid:
                        raise KeyError(f"resource slug exists: {merged.slug}")
                    txn.set(RESOURCE_SLUG.format(kbid=kbid, slug=merged.slug), rid.encode())
                if meta.slug:
                    txn.delete(RESOURCE_SLUG.format(kbid=kbid, slug=meta.slug))
                meta.slug = merged.slug
            txn.set(
                RESOURCE_PAYLOAD.format(kbid=kbid, rid=rid),
                merged.model_dump_json().encode(),
            )
            txn.set(RESOURCE_META.format(kbid=kbid, rid=rid), meta.to_json())
        self._payload_invalidate(kbid, rid)
        doc = ResourceBrain(rid).build(merged, created=meta.created)
        self._route_external_index(kbid, doc)
        seq = self.node.index(meta.shard, doc, hidden=merged.hidden)
        return int(seq)

    def delete_resource(self, kbid: str, rid: str) -> Optional[int]:
        with self._resource_locks.hold(f"{kbid}/{rid}"):
            return self._delete_resource(kbid, rid)

    def _delete_resource(self, kbid: str, rid: str) -> Optional[int]:
        meta = self.get_meta(kbid, rid)
        if meta is None:
            return None
        payload = self.get_payload(kbid, rid)
        with self.driver as txn:
            if meta.slug:
                txn.delete(RESOURCE_SLUG.format(kbid=kbid, slug=meta.slug))
            elif payload is not None and payload.slug:
                txn.delete(RESOURCE_SLUG.format(kbid=kbid, slug=payload.slug))
            # the whole subtree: payload, meta, file-field entries
            txn.delete_by_prefix(f"/kbs/{kbid}/r/{rid}/")
        self._payload_invalidate(kbid, rid)
        # uploaded blobs go with the resource
        for key in list(self.node.storage.list(f"blobs/{kbid}/{rid}/")):
            self.node.storage.delete(key)
        manager = self.kbs.external_index(kbid)
        if manager is not None:
            manager.delete_resource(rid)
        seq = self.node.delete_resource(meta.shard, rid)
        self.kbs.record_resource(kbid, meta.shard, -1)
        return int(seq)

    # ---- reads ---------------------------------------------------------------

    @contextmanager
    def payload_cache(self):
        """Request-scoped payload memoization (thread-local): hydration
        parses the SAME multi-MB resource payload dozens of times per /find
        (one per result block + per rerank passage) without it. Reentrant —
        nested scopes share the outermost cache; writes are outside any
        scope (ingest) so staleness is bounded to one request."""
        local = self._payload_cache_local
        outer = getattr(local, "cache", None)
        if outer is None:
            local.cache = {}
        try:
            yield
        finally:
            if outer is None:
                local.cache = None

    # cross-request payload LRU: hydration parses ~top_k distinct multi-MB
    # resource payloads per /find (measured ~0.25 ms/query of pure pydantic
    # parse on hot corpora). Entries live PAYLOAD_TTL seconds — local writes
    # invalidate immediately (read-your-writes in-process); multi-worker
    # replicas see at most TTL staleness, matching their searcher sync lag.
    PAYLOAD_TTL = 2.0
    _PAYLOAD_LRU_MAX = 512

    def _payload_invalidate(self, kbid: str, rid: str) -> None:
        self._payload_lru.pop((kbid, rid), None)

    def get_payload(self, kbid: str, rid: str) -> Optional[CreateResourcePayload]:
        cache = getattr(self._payload_cache_local, "cache", None)
        key = (kbid, rid)
        if cache is not None and key in cache:
            return cache[key]
        now = time.time()
        hit = self._payload_lru.get(key)
        if hit is not None and now - hit[0] < self.PAYLOAD_TTL:
            payload = hit[1]
            if cache is not None:
                cache[key] = payload
            return payload
        with self.driver as txn:
            raw = txn.get(RESOURCE_PAYLOAD.format(kbid=kbid, rid=rid))
        payload = CreateResourcePayload.model_validate_json(raw) if raw else None
        if len(self._payload_lru) >= self._PAYLOAD_LRU_MAX:
            # drop the oldest insertion (plain dict keeps insertion order)
            self._payload_lru.pop(next(iter(self._payload_lru)), None)
        self._payload_lru[key] = (now, payload)
        if cache is not None:
            cache[key] = payload
        return payload

    def get_meta(self, kbid: str, rid: str) -> Optional[ResourceMeta]:
        with self.driver as txn:
            raw = txn.get(RESOURCE_META.format(kbid=kbid, rid=rid))
        return ResourceMeta.from_json(raw) if raw else None

    def resolve_slug(self, kbid: str, slug: str) -> Optional[str]:
        with self.driver as txn:
            raw = txn.get(RESOURCE_SLUG.format(kbid=kbid, slug=slug))
        return raw.decode() if raw else None

    def list_resources(self, kbid: str) -> list[str]:
        prefix = f"/kbs/{kbid}/r/"
        with self.driver as txn:
            keys = list(txn.keys(prefix))
        return sorted({k.split("/")[4] for k in keys})

    def field_text(self, kbid: str, rid: str, field_id: str) -> Optional[str]:
        """Extracted text of one field (the hydration source for /find).

        Parity: search/search/paragraphs.py get_paragraph_text — the
        reference reads extracted text from blob storage; here field text
        lives in the resource payload in KV.
        """
        payload = self.get_payload(kbid, rid)
        if payload is None:
            return None
        if field_id == "a/title":
            return payload.title
        if field_id == "a/summary":
            return payload.summary
        if field_id.startswith("t/"):
            tf = payload.texts.get(field_id[2:])
            return tf.body if tf else None
        if field_id.startswith("u/"):
            lf = payload.links.get(field_id[2:])
            if lf is None:
                return None
            return "\n".join(p for p in (lf.title, lf.description, lf.uri) if p)
        if field_id.startswith("c/"):
            conv = payload.conversations.get(field_id[2:])
            # transcript() is the same join the brain builder computed
            # paragraph offsets over
            return conv.transcript() if conv is not None else None
        return None
