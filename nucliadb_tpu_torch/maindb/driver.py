"""sqlite KV driver with transactions and prefix scans.

The port's copy of ``nucliadb_tpu/maindb/driver.py``,
kept verbatim: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Iterator, Optional


class Transaction:
    """A read-write transaction over the KV table.

    Parity surface: common/maindb/driver.py Transaction (get/set/delete/
    batch_get/keys/count) — synchronous here; the HTTP layer runs them in a
    thread pool.
    """

    def __init__(self, driver: "Driver", savepoint: Optional[str] = None):
        self._driver = driver
        self._open = True
        # nested `with driver` blocks become SAVEPOINTs: their commit
        # releases the savepoint (still inside the outer transaction), so
        # an outer abort rolls EVERYTHING back — a plain conn.commit() from
        # the inner block would have committed the outer writes too
        self._savepoint = savepoint
        if savepoint is not None:
            driver._conn.execute(f"SAVEPOINT {savepoint}")

    def get(self, key: str) -> Optional[bytes]:
        row = self._driver._conn.execute(
            "SELECT value FROM resources WHERE key=?", (key,)
        ).fetchone()
        return row[0] if row else None

    def batch_get(self, keys: list[str]) -> list[Optional[bytes]]:
        if not keys:
            return []
        found: dict[str, bytes] = {}
        # one IN query per chunk (sqlite caps bound parameters at ~32k;
        # hydration batches are far smaller but stay safe)
        for lo in range(0, len(keys), 512):
            chunk = keys[lo : lo + 512]
            rows = self._driver._conn.execute(
                "SELECT key, value FROM resources WHERE key IN (%s)"
                % ",".join("?" * len(chunk)),
                chunk,
            )
            found.update(rows)
        return [found.get(k) for k in keys]

    def set(self, key: str, value: bytes) -> None:
        self._driver._conn.execute(
            "INSERT INTO resources(key, value) VALUES(?,?)"
            " ON CONFLICT(key) DO UPDATE SET value=excluded.value",
            (key, value),
        )

    def delete(self, key: str) -> None:
        self._driver._conn.execute("DELETE FROM resources WHERE key=?", (key,))

    def delete_by_prefix(self, prefix: str) -> None:
        self._driver._conn.execute(
            "DELETE FROM resources WHERE key GLOB ?", (prefix + "*",)
        )

    def keys(self, prefix: str, count: int = -1) -> Iterator[str]:
        q = "SELECT key FROM resources WHERE key GLOB ? ORDER BY key"
        if count >= 0:
            q += f" LIMIT {int(count)}"
        for (key,) in self._driver._conn.execute(q, (prefix + "*",)):
            yield key

    def count(self, prefix: str) -> int:
        return self._driver._conn.execute(
            "SELECT COUNT(*) FROM resources WHERE key GLOB ?", (prefix + "*",)
        ).fetchone()[0]

    def commit(self) -> None:
        if self._savepoint is not None:
            try:
                self._driver._conn.execute(
                    f"RELEASE SAVEPOINT {self._savepoint}"
                )
            finally:
                self._driver._lock.release()
                self._open = False
            return
        try:
            self._driver._conn.commit()
        except BaseException:
            # roll back AND release — a raising commit must not leak the
            # held driver lock (every later transaction would block forever)
            try:
                self._driver._conn.rollback()
            finally:
                self._driver._lock.release()
                self._open = False
            raise
        self._driver._lock.release()
        self._open = False

    def abort(self) -> None:
        if not self._open:
            return
        if self._savepoint is not None:
            try:
                self._driver._conn.execute(
                    f"ROLLBACK TO SAVEPOINT {self._savepoint}"
                )
                self._driver._conn.execute(
                    f"RELEASE SAVEPOINT {self._savepoint}"
                )
            finally:
                self._driver._lock.release()
                self._open = False
            return
        try:
            self._driver._conn.rollback()
        finally:
            self._driver._lock.release()
            self._open = False


class Driver:
    """sqlite-backed KV. ``compare_and_swap``/``delete_if`` are single-
    statement (hence cross-process atomic) primitives for lease locks —
    the plain Transaction read-modify-write is NOT atomic across processes.
    """

    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        # NORMAL in WAL mode: commits do not fsync the WAL on every txn
        # (process-crash safe, consistent after OS crash; only a power loss
        # can drop the last instants of acked writes). FULL measured as the
        # top ingest cost (~10 txns/doc); this is the standard WAL serving
        # config and matches the durability most deployments run PG with.
        self._conn.execute("PRAGMA synchronous=NORMAL")
        # multi-worker standalone shares these files across processes; a
        # briefly-locked writer must queue, not error (sqlite default is 0)
        self._conn.execute("PRAGMA busy_timeout=10000")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS resources (key TEXT PRIMARY KEY, value BLOB)"
        )
        self._conn.commit()
        self._lock = threading.RLock()
        self._local = threading.local()  # per-thread txn stack for `with`

    def backup(self, dest_path: str) -> None:
        """Consistent online snapshot (sqlite backup API)."""
        import sqlite3 as _sq

        dst = _sq.connect(dest_path)
        try:
            with self._lock:
                self._conn.backup(dst)
        finally:
            dst.close()

    def compare_and_swap(self, key: str, expected: Optional[bytes], new: bytes) -> bool:
        """Atomically set ``key`` to ``new`` iff its current value is
        ``expected`` (None = key absent). Returns True on success."""
        with self._lock:
            if expected is None:
                cur = self._conn.execute(
                    "INSERT OR IGNORE INTO resources(key, value) VALUES(?,?)",
                    (key, new),
                )
            else:
                cur = self._conn.execute(
                    "UPDATE resources SET value=? WHERE key=? AND value=?",
                    (new, key, expected),
                )
            self._conn.commit()
            return cur.rowcount > 0

    def delete_if(self, key: str, expected: bytes) -> bool:
        with self._lock:
            cur = self._conn.execute(
                "DELETE FROM resources WHERE key=? AND value=?", (key, expected)
            )
            self._conn.commit()
            return cur.rowcount > 0

    def transaction(self) -> Transaction:
        self._lock.acquire()
        # explicit BEGIN: pysqlite only auto-begins on DML, so a read-only
        # outer block would otherwise leave a nested SAVEPOINT outermost
        # (its RELEASE would commit instead of nest)
        if not self._conn.in_transaction:
            self._conn.execute("BEGIN")
        return Transaction(self)

    def __enter__(self) -> Transaction:
        # per-thread STACK (mirrors substrate.RemoteDriver): a shared
        # attribute let a reentrant or cross-thread `with` commit another
        # block's transaction and leak the outer lock acquisition
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        if stack:
            # nested on the same thread: reentrant lock + savepoint
            self._lock.acquire()
            txn = Transaction(self, savepoint=f"ndb_nest_{len(stack)}")
        else:
            txn = self.transaction()
        stack.append(txn)
        return txn

    def __exit__(self, exc_type, exc, tb) -> None:
        txn = self._local.stack.pop()
        if exc_type is None:
            txn.commit()
        else:
            txn.abort()
