"""Built-in data migrations.

The port's copy of ``nucliadb_tpu/migrator/migrations.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity: nucliadb/src/migrations/ — the reference ships versioned migration
modules (slug/key backfills, rollover-based whole-KB reindexes when an index
format changes). These are this build's real equivalents; importing the
module registers them, so deployments that boot through
``standalone.app.StandaloneApp`` or the migrator CLI pick them up.
"""

from __future__ import annotations

from . import Migration, MigrationContext, register


def _backfill_slug_keys(ctx: MigrationContext, kbid: str) -> None:
    """Write missing slug->rid twin keys for resources created before the
    slug-twin routes existed (parity pattern: the reference's key backfill
    migrations over the maindb KV)."""
    from ..common.kb import RESOURCE_SLUG

    processor = ctx.processor
    for rid in processor.list_resources(kbid):
        meta = processor.get_meta(kbid, rid)
        if meta is None or not meta.slug:
            continue
        key = RESOURCE_SLUG.format(kbid=kbid, slug=meta.slug)
        with ctx.driver as txn:
            if txn.get(key) is None:
                txn.set(key, rid.encode())


def _reindex_stale_vector_formats(ctx: MigrationContext, kbid: str) -> None:
    """Rollover-reindex KBs whose vector segments predate the current
    segment format (parity pattern: the reference's repeated rollover-based
    reindex migrations, SURVEY P12)."""
    from ..common.rollover import rollover_kb
    from ..index.vector.segment import FORMAT_VERSION

    shards = ctx.kbs.get_shards(kbid)
    if shards is None:
        return
    for shard_id in shards.shards:
        for idx in ctx.node.metadata.get_indexes(shard_id):
            if idx.kind != "vector":
                continue
            for seg in ctx.node.metadata.ready_segments(idx.id):
                # unversioned (pre-versioning) segments are exactly the
                # stale population — default must be 0, not current
                fmt = seg.index_metadata.get("format_version", 0)
                if fmt < FORMAT_VERSION:
                    rollover_kb(ctx.kbs, ctx.processor, ctx.node, kbid)
                    return


def _reindex_stale_text_formats(ctx: MigrationContext, kbid: str) -> None:
    """Rollover-reindex KBs whose text/paragraph segments predate
    TEXT_FORMAT_VERSION (v2 added the /f/{field_type} facets that power
    field-type filters and catalog title matching)."""
    from ..common.rollover import rollover_kb
    from ..index.text_engine.builder import TEXT_FORMAT_VERSION

    shards = ctx.kbs.get_shards(kbid)
    if shards is None:
        return
    for shard_id in shards.shards:
        for idx in ctx.node.metadata.get_indexes(shard_id):
            if idx.kind not in ("text", "paragraph"):
                continue
            for seg in ctx.node.metadata.ready_segments(idx.id):
                fmt = seg.index_metadata.get("format_version", 1)
                if fmt < TEXT_FORMAT_VERSION:
                    rollover_kb(ctx.kbs, ctx.processor, ctx.node, kbid)
                    return


register(Migration(version=1, name="backfill-resource-slug-keys", kb_fn=_backfill_slug_keys))
register(
    Migration(
        version=2,
        name="reindex-stale-vector-segment-formats",
        kb_fn=_reindex_stale_vector_formats,
    )
)
register(
    Migration(
        version=3,
        name="reindex-stale-text-segment-formats",
        kb_fn=_reindex_stale_text_formats,
    )
)
