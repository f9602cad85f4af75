"""Ops tool: ``python -m nucliadb_tpu_torch.tool <command>``.

Counterpart of ``nucliadb_tpu/tool.py``: the same subcommands and output
plus ``--device`` (default ``cuda``; ``cpu`` for tests), where the node's
searchers run. ``--device cuda`` on a machine without a card raises before
any file is opened.

Parity: the reference's ``nidx tool`` / import-export utilities
(nidx/src/tool.rs:20-58 import_shard, import_export.rs) plus the product
export/import surface — offline KB export/import, backup management and
shard stats against a data directory, without booting the server.
"""

from __future__ import annotations

import argparse
import os
import sys


def _stack(data_dir: str, device: str = "cuda"):
    from .common.kb import KnowledgeBoxManager
    from .ingest.processor import Processor
    from .maindb import Driver
    from .services import EmbeddedNode
    from .utils.platform import resolve_device

    # fail fast: a cuda tool on a machine without a card raises here
    device = resolve_device(device)
    os.makedirs(data_dir, exist_ok=True)
    driver = Driver(os.path.join(data_dir, "maindb.db"))
    node = EmbeddedNode(data_dir=os.path.join(data_dir, "node"), device=device)
    kbs = KnowledgeBoxManager(driver, node)
    processor = Processor(driver, node, kbs)
    return node, kbs, processor


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="nucliadb_tpu_torch.tool")
    parser.add_argument("--data-dir", default="./data")
    # the port's own option: where the node's searchers run
    parser.add_argument(
        "--device", default="cuda",
        help="torch device of the index node's searchers (cuda or cpu)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("export-kb", help="export one KB to a file")
    p.add_argument("kbid")
    p.add_argument("out")

    p = sub.add_parser("import-kb", help="import a KB export file")
    p.add_argument("path")
    p.add_argument("--slug", default="")

    sub.add_parser("list-kbs", help="list knowledge boxes")
    sub.add_parser("list-backups", help="list backups in the node storage")

    p = sub.add_parser("backup", help="create a backup of one KB")
    p.add_argument("kbid")

    p = sub.add_parser("restore", help="restore a backup into a new KB")
    p.add_argument("backup_id")
    p.add_argument("--slug", default="")

    p = sub.add_parser("shards", help="shard/segment stats for one KB")
    p.add_argument("kbid")

    args = parser.parse_args(argv)
    node, kbs, processor = _stack(args.data_dir, args.device)

    if args.command == "export-kb":
        from .common.export_import import export_kb

        blob = export_kb(kbs, processor, args.kbid, node.storage)
        with open(args.out, "wb") as f:
            f.write(blob)
        print(f"exported {args.kbid}: {len(blob)} bytes -> {args.out}")
    elif args.command == "import-kb":
        from .common.export_import import import_kb

        with open(args.path, "rb") as f:
            blob = f.read()
        kbid = import_kb(kbs, processor, blob, slug=args.slug, storage=node.storage)
        node.wait_for_sync()
        print(f"imported -> {kbid}")
    elif args.command == "list-kbs":
        for kbid in kbs.list_kbs():
            config = kbs.get_config(kbid)
            print(f"{kbid}  slug={config.slug if config else '?'}")
    elif args.command == "list-backups":
        from .common.export_import import list_backups

        for backup_id in list_backups(node.storage):
            print(backup_id)
    elif args.command == "backup":
        from .common.export_import import create_backup

        backup_id = create_backup(kbs, processor, node.storage, args.kbid)
        print(backup_id)
    elif args.command == "restore":
        from .common.export_import import restore_backup

        kbid = restore_backup(kbs, processor, node.storage, args.backup_id, slug=args.slug)
        node.wait_for_sync()
        print(f"restored -> {kbid}")
    elif args.command == "shards":
        shards = kbs.get_shards(args.kbid)
        if shards is None:
            print(f"unknown kb {args.kbid}", file=sys.stderr)
            return 1
        for shard_id in shards.shards:
            marker = " (writable)" if shard_id == shards.shards[shards.writable] else ""
            print(f"shard {shard_id}{marker}")
            for index in node.metadata.get_indexes(shard_id):
                segs = node.metadata.ready_segments(index.id)
                print(
                    f"  {index.full_name}: {len(segs)} segments, "
                    f"{sum(s.records for s in segs)} records, "
                    f"{sum(s.size_bytes for s in segs)} bytes"
                )
    return 0


if __name__ == "__main__":
    sys.exit(main())
