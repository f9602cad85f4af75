"""KB export / import / backups.

The port's copy of ``nucliadb_tpu/common/export_import.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity: nucliadb/src/nucliadb/export_import/ (KB export to a stream of
records: resources + binaries + labels/entities; import consumer) and the
backup create/restore flows (backups/, ingest/service/writer.py:344-378).
Format: a msgpack record stream — [kind, *data] — written to bytes or to
object storage for backups.
"""

from __future__ import annotations

import io
import time
import uuid
from typing import Iterator, Optional

import msgpack

from ..ingest.processor import Processor
from ..models.api import CreateResourcePayload, KnowledgeBoxConfig
from ..storage import Storage
from .kb import KnowledgeBoxManager

FORMAT_VERSION = 2

# KV subkeys (under /kbs/{kbid}/) NOT exported as raw records: config has
# its own typed record; shards belong to the source deployment; resource
# payload/meta/rslug rows are re-created by import's create_resource.
_KV_SKIP_EXACT = ("config", "shards")
_KV_SKIP_RE = None  # compiled lazily


def _kv_skip(subkey: str) -> bool:
    global _KV_SKIP_RE
    if subkey in _KV_SKIP_EXACT or subkey.startswith("rslugs/"):
        return True
    if _KV_SKIP_RE is None:
        import re

        _KV_SKIP_RE = re.compile(r"^r/[^/]+/(payload|meta)$")
    return _KV_SKIP_RE.match(subkey) is not None


def export_kb(
    kbs: KnowledgeBoxManager,
    processor: Processor,
    kbid: str,
    storage: Optional[Storage] = None,
) -> bytes:
    """Serialize a whole KB to one blob: config, resources, every other
    KV record under the KB namespace (labelsets, entity groups, synonyms,
    learning config/strategies, file-field entries), and — when ``storage``
    is given — the KB's binary blobs. Parity: the reference exports
    BIN/FILE/labels/entities records (export_import/exporter.py)."""
    config = kbs.get_config(kbid)
    if config is None:
        raise KeyError(f"unknown kb {kbid}")
    buf = io.BytesIO()
    packer = msgpack.Packer()
    buf.write(packer.pack(["version", FORMAT_VERSION]))
    buf.write(packer.pack(["kbid", kbid]))
    buf.write(packer.pack(["config", config.model_dump()]))
    for rid in processor.list_resources(kbid):
        payload = processor.get_payload(kbid, rid)
        meta = processor.get_meta(kbid, rid)
        if payload is None:
            continue
        buf.write(
            packer.pack(
                [
                    "resource",
                    rid,
                    payload.model_dump(),
                    {"created": meta.created if meta else 0.0},
                ]
            )
        )
    # auxiliary KV under the KB namespace, kbid prefix stripped
    prefix = f"/kbs/{kbid}/"
    with processor.driver as txn:
        aux = [
            (key[len(prefix):], txn.get(key))
            for key in txn.keys(prefix)
            if not _kv_skip(key[len(prefix):])
        ]
    for subkey, value in aux:
        if value is not None:
            buf.write(packer.pack(["kv", subkey, value]))
    if storage is not None:
        blob_prefix = f"blobs/{kbid}/"
        for key in storage.list(blob_prefix):
            buf.write(
                packer.pack(["blob", key[len(blob_prefix):], storage.get(key)])
            )
    buf.write(packer.pack(["end"]))
    return buf.getvalue()


def iter_records(data: bytes) -> Iterator[list]:
    unpacker = msgpack.Unpacker(io.BytesIO(data))
    for record in unpacker:
        yield record


def import_kb(
    kbs: KnowledgeBoxManager,
    processor: Processor,
    data: bytes,
    *,
    kbid: Optional[str] = None,
    slug: Optional[str] = None,
    storage: Optional[Storage] = None,
) -> str:
    """Import an exported KB; creates a new KB unless ``kbid`` is given.

    Blob keys embedded in payloads and KV values carry the SOURCE kbid
    (``blobs/{old}/...``) — they are rewritten to the target KB."""
    import json as _json

    records = iter_records(data)
    head = next(records)
    if head[0] != "version" or head[1] > FORMAT_VERSION:
        raise ValueError(f"unsupported export format: {head}")
    target_kbid = kbid
    source_kbid: Optional[str] = None

    def _rewrite_str(text: str) -> str:
        if source_kbid and target_kbid:
            return text.replace(
                f"blobs/{source_kbid}/", f"blobs/{target_kbid}/"
            )
        return text

    for record in records:
        kind = record[0]
        if kind == "kbid":
            source_kbid = record[1]
        elif kind == "config":
            if target_kbid is None:
                config = KnowledgeBoxConfig.model_validate(record[1])
                if slug is not None:
                    config.slug = slug
                target_kbid = kbs.create(config)
        elif kind == "resource":
            if target_kbid is None:
                raise ValueError("resource record before config")
            _, rid, payload_dict, meta_dict = record
            payload = CreateResourcePayload.model_validate(
                _json.loads(_rewrite_str(_json.dumps(payload_dict)))
            )
            processor.create_resource(
                target_kbid, payload, rid=rid,
                created=(meta_dict or {}).get("created"),
            )
        elif kind == "kv":
            if target_kbid is None:
                raise ValueError("kv record before config")
            _, subkey, value = record
            try:
                value = _rewrite_str(bytes(value).decode()).encode()
            except UnicodeDecodeError:
                value = bytes(value)  # binary value: store verbatim
            with processor.driver as txn:
                txn.set(f"/kbs/{target_kbid}/{subkey}", value)
        elif kind == "blob":
            if target_kbid is None:
                raise ValueError("blob record before config")
            if storage is not None:
                _, subkey, blob = record
                storage.put(f"blobs/{target_kbid}/{subkey}", bytes(blob))
        elif kind == "end":
            break
    if target_kbid is None:
        raise ValueError("export contained no config record")
    return target_kbid


# ---- backups (object-store persisted exports) ------------------------------


def backup_key(backup_id: str) -> str:
    return f"backups/{backup_id}.export"


def create_backup(
    kbs: KnowledgeBoxManager,
    processor: Processor,
    storage: Storage,
    kbid: str,
    backup_id: str | None = None,
) -> str:
    backup_id = backup_id or f"{kbid}-{uuid.uuid4().hex[:8]}-{int(time.time())}"
    storage.put(backup_key(backup_id), export_kb(kbs, processor, kbid, storage))
    return backup_id


def restore_backup(
    kbs: KnowledgeBoxManager,
    processor: Processor,
    storage: Storage,
    backup_id: str,
    *,
    slug: Optional[str] = None,
) -> str:
    data = storage.get(backup_key(backup_id))
    return import_kb(kbs, processor, data, slug=slug, storage=storage)


def list_backups(storage: Storage) -> list[str]:
    return [
        key[len("backups/"):-len(".export")]
        for key in storage.list("backups/")
        if key.endswith(".export")
    ]


def delete_backup(storage: Storage, backup_id: str) -> None:
    storage.delete(backup_key(backup_id))
