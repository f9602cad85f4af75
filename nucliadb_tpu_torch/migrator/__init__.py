"""Versioned data migrations.

The port's copy of ``nucliadb_tpu/migrator/__init__.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity: nucliadb/src/migrations/ + the migrator framework
(nucliadb/src/nucliadb/migrator/, proposal 003-migration-strategy): global
and per-KB migration functions run in version order under a lock; the
current version persists in the main KV so restarts resume where they left
off. Rollover-based reindex migrations reuse common/rollover.py.
"""

from __future__ import annotations

import json
import time
import uuid
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Optional

from ..common.kb import KnowledgeBoxManager
from ..ingest.processor import Processor
from ..maindb import Driver
from ..services import EmbeddedNode

VERSION_KEY = "/migration/version"
KB_VERSION_KEY = "/kbs/{kbid}/migration/version"


@dataclass
class Migration:
    version: int
    name: str
    global_fn: Optional[Callable] = None  # fn(context)
    kb_fn: Optional[Callable] = None  # fn(context, kbid)


@dataclass
class MigrationContext:
    driver: Driver
    node: EmbeddedNode
    kbs: KnowledgeBoxManager
    processor: Processor


LOCK_KEY = "/migration/lock"
LOCK_TTL = 120.0

_REGISTRY: list[Migration] = []


def register(migration: Migration) -> None:
    _REGISTRY.append(migration)
    _REGISTRY.sort(key=lambda m: m.version)


def registered() -> list[Migration]:
    return list(_REGISTRY)


def current_version(driver: Driver) -> int:
    with driver as txn:
        raw = txn.get(VERSION_KEY)
    return int(raw) if raw else 0


@contextmanager
def migration_lock(driver: Driver, *, timeout: float = 30.0):
    """KV lease lock so only one process runs migrations (parity: the
    reference's PG advisory lock around migrations, metadata.rs:36,75-82,
    and the Python migrator's distributed lock).

    Acquisition is a single-statement compare-and-swap (cross-process
    atomic); a renewal thread heartbeats the lease while held, so long
    migrations (rollover reindexes) cannot be stolen mid-run; expired
    leases (a crashed migrator) are taken over after LOCK_TTL."""
    import threading

    owner = uuid.uuid4().hex

    def lease(expires: float) -> bytes:
        return json.dumps({"owner": owner, "expires": expires}).encode()

    deadline = time.time() + timeout
    while True:
        # the lease expiry must be stamped at ACQUISITION time — stamping it
        # once before a contended wait would install an already-(nearly-)
        # expired lease that a third process could immediately steal
        current = lease(time.time() + LOCK_TTL)
        with driver as txn:
            raw = txn.get(LOCK_KEY)
        if raw is None:
            if driver.compare_and_swap(LOCK_KEY, None, current):
                break
        else:
            holder = json.loads(raw)
            if holder["expires"] < time.time() and driver.compare_and_swap(
                LOCK_KEY, raw, current
            ):
                break
        if time.time() >= deadline:
            raise TimeoutError("migration lock held by another process")
        time.sleep(0.05)

    stop = threading.Event()

    def renew():
        nonlocal current
        while not stop.wait(LOCK_TTL / 3):
            fresh = lease(time.time() + LOCK_TTL)
            if driver.compare_and_swap(LOCK_KEY, current, fresh):
                current = fresh
            else:
                return  # lost the lease (should not happen while renewing)

    renewer = threading.Thread(target=renew, daemon=True)
    renewer.start()
    try:
        yield
    finally:
        stop.set()
        renewer.join(timeout=1)
        driver.delete_if(LOCK_KEY, current)


def latest_version() -> int:
    return _REGISTRY[-1].version if _REGISTRY else 0


def bootstrap_version(driver: Driver) -> None:
    """Fresh deployments start at the latest version without replaying
    history (parity: the reference initializes new installs at HEAD)."""
    with driver as txn:
        if txn.get(VERSION_KEY) is None:
            txn.set(VERSION_KEY, str(latest_version()).encode())


def run_migrations(context: MigrationContext, *, lock_timeout: float = 30.0) -> list[str]:
    """Apply every pending migration in order under the migration lock;
    returns the applied names."""
    applied = []
    with migration_lock(context.driver, timeout=lock_timeout):
        start = current_version(context.driver)
        for migration in _REGISTRY:
            if migration.version <= start:
                continue
            if migration.global_fn is not None:
                migration.global_fn(context)
            if migration.kb_fn is not None:
                for kbid in context.kbs.list_kbs():
                    kb_done = _kb_version(context.driver, kbid)
                    if migration.version <= kb_done:
                        continue
                    migration.kb_fn(context, kbid)
                    _set_kb_version(context.driver, kbid, migration.version)
            with context.driver as txn:
                txn.set(VERSION_KEY, str(migration.version).encode())
            applied.append(migration.name)
    return applied


def _kb_version(driver: Driver, kbid: str) -> int:
    with driver as txn:
        raw = txn.get(KB_VERSION_KEY.format(kbid=kbid))
    return int(raw) if raw else 0


def _set_kb_version(driver: Driver, kbid: str, version: int) -> None:
    with driver as txn:
        txn.set(KB_VERSION_KEY.format(kbid=kbid), str(version).encode())
