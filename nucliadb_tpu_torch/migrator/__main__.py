"""Migrator CLI: ``python -m nucliadb_tpu_torch.migrator --data-dir ./data``.

Counterpart of ``nucliadb_tpu/migrator/__main__.py``: the same options and
output plus ``--device`` (default ``cuda``; ``cpu`` for tests), where the
node that applies the migrations runs. It is resolved right after parsing,
so ``--device cuda`` without a card raises, a dry run included.

Parity: the reference runs its migrator as a dedicated deployment
(nucliadb/src/nucliadb/migrator/command.py); embedded deployments also run
it at standalone boot. ``--dry-run`` lists pending migrations without
applying them.
"""

from __future__ import annotations

import argparse
import os

from . import (
    MigrationContext,
    current_version,
    migrations as _builtin,  # noqa: F401 — import registers them
    registered,
    run_migrations,
)


def main() -> None:
    parser = argparse.ArgumentParser(description="nucliadb_tpu migrator")
    parser.add_argument("--data-dir", default="./data")
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--lock-timeout", type=float, default=30.0)
    # the port's own option: where the migrating node's searchers run
    parser.add_argument(
        "--device", default="cuda",
        help="torch device of the index node's searchers (cuda or cpu)",
    )
    args = parser.parse_args()

    from ..utils.platform import resolve_device

    # fail fast, before the main KV is opened
    device = resolve_device(args.device)

    from ..common.kb import KnowledgeBoxManager
    from ..ingest.processor import Processor
    from ..maindb import Driver
    from ..services import EmbeddedNode

    os.makedirs(args.data_dir, exist_ok=True)
    driver = Driver(os.path.join(args.data_dir, "maindb.db"))
    version = current_version(driver)
    pending = [m for m in registered() if m.version > version]
    print(f"current version: {version}; pending: {[m.name for m in pending]}")
    if args.dry_run or not pending:
        return

    node = EmbeddedNode(data_dir=os.path.join(args.data_dir, "node"), device=device)
    kbs = KnowledgeBoxManager(driver, node)
    processor = Processor(driver, node, kbs)
    applied = run_migrations(
        MigrationContext(driver=driver, node=node, kbs=kbs, processor=processor),
        lock_timeout=args.lock_timeout,
    )
    print(f"applied: {applied}")


if __name__ == "__main__":
    main()
