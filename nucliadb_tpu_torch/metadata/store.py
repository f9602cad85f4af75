"""sqlite-backed metadata store (see package docstring for schema parity).

The port's copy of ``nucliadb_tpu/metadata/store.py``,
kept verbatim: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional

from ..types import Seq

SEGMENT_GRACE_S = 300.0  # new segments are purgeable until marked ready
MERGE_JOB_STALE_S = 60.0  # requeue jobs without heartbeat for this long
MERGE_JOB_MAX_RETRIES = 4
MERGE_JOB_POISON_RETRY_S = 3600.0  # poisoned-job cooldown between attempts

_SCHEMA = """
CREATE TABLE IF NOT EXISTS shards (
    id TEXT PRIMARY KEY,
    kbid TEXT NOT NULL,
    config TEXT NOT NULL DEFAULT '{}',
    deleted_at REAL
);
CREATE TABLE IF NOT EXISTS indexes (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    shard_id TEXT NOT NULL REFERENCES shards(id),
    kind TEXT NOT NULL,
    name TEXT NOT NULL,
    configuration TEXT NOT NULL DEFAULT '{}',
    updated_at REAL NOT NULL,
    deleted_at REAL,
    UNIQUE(shard_id, kind, name)
);
CREATE TABLE IF NOT EXISTS segments (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    index_id INTEGER NOT NULL REFERENCES indexes(id),
    seq INTEGER NOT NULL,
    records INTEGER NOT NULL,
    size_bytes INTEGER NOT NULL DEFAULT 0,
    tags TEXT NOT NULL DEFAULT '[]',
    index_metadata TEXT NOT NULL DEFAULT '{}',
    ready INTEGER NOT NULL DEFAULT 0,
    merge_job_id INTEGER,
    delete_at REAL
);
CREATE TABLE IF NOT EXISTS deletions (
    index_id INTEGER NOT NULL REFERENCES indexes(id),
    seq INTEGER NOT NULL,
    keys TEXT NOT NULL,
    PRIMARY KEY (index_id, seq)
);
CREATE TABLE IF NOT EXISTS merge_jobs (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    index_id INTEGER NOT NULL REFERENCES indexes(id),
    seq INTEGER NOT NULL,
    retries INTEGER NOT NULL DEFAULT 0,
    enqueued_at REAL NOT NULL,
    started_at REAL,
    running_at REAL
);
CREATE TABLE IF NOT EXISTS index_requests (
    seq INTEGER PRIMARY KEY,
    acked INTEGER NOT NULL DEFAULT 0,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS counters (
    name TEXT PRIMARY KEY,
    value INTEGER NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_segments_index ON segments(index_id, ready);
CREATE INDEX IF NOT EXISTS idx_indexes_shard ON indexes(shard_id);
"""


@dataclass
class ShardMeta:
    id: str
    kbid: str
    config: dict


@dataclass
class IndexMeta:
    id: int
    shard_id: str
    kind: str
    name: str
    configuration: dict
    updated_at: float

    @property
    def full_name(self) -> str:
        return self.kind if self.kind != "vector" else f"vector/{self.name}"


@dataclass
class SegmentRow:
    id: int
    index_id: int
    seq: Seq
    records: int
    size_bytes: int
    tags: list[str]
    index_metadata: dict
    ready: bool
    merge_job_id: Optional[int]
    delete_at: Optional[float]

    @property
    def storage_key(self) -> str:
        return f"segments/{self.index_id}/{self.id}.tar"


@dataclass
class MergeJob:
    id: int
    index_id: int
    seq: Seq
    retries: int


class MetadataStore:
    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        # NORMAL in WAL mode: commits do not fsync the WAL on every txn
        # (process-crash safe, consistent after OS crash; only a power loss
        # can drop the last instants of acked writes). FULL measured as the
        # top ingest cost (~10 txns/doc); this is the standard WAL serving
        # config and matches the durability most deployments run PG with.
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute("PRAGMA busy_timeout=10000")
        self._conn.execute("PRAGMA foreign_keys=ON")
        self._lock = threading.RLock()
        with self._lock, self._conn:
            self._conn.executescript(_SCHEMA)

    # ---- seq source (nidx_binding-style atomic counter) ------------------

    def backup(self, dest_path: str) -> None:
        """Consistent online snapshot to ``dest_path`` (sqlite backup API —
        safe while writers run; the substrate snapshot hook uses this)."""
        import sqlite3 as _sq

        dst = _sq.connect(dest_path)
        try:
            with self._lock:
                self._conn.backup(dst)
        finally:
            dst.close()

    def next_seq(self) -> Seq:
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO counters(name, value) VALUES('seq', 0) "
                "ON CONFLICT(name) DO UPDATE SET value = value + 1"
            )
            row = self._conn.execute(
                "SELECT value FROM counters WHERE name='seq'"
            ).fetchone()
        return Seq(row[0])

    def open_index_request(self) -> Seq:
        """next_seq + record_index_request fused into one transaction — the
        indexer opens every operation with this pair, and in component/HA
        mode each metadata RPC is a network round trip shipped
        synchronously to the standby."""
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO counters(name, value) VALUES('seq', 0) "
                "ON CONFLICT(name) DO UPDATE SET value = value + 1"
            )
            row = self._conn.execute(
                "SELECT value FROM counters WHERE name='seq'"
            ).fetchone()
            self._conn.execute(
                "INSERT OR IGNORE INTO index_requests(seq, acked, created_at)"
                " VALUES(?,0,?)",
                (row[0], time.time()),
            )
        return Seq(row[0])

    def last_seq(self) -> Seq:
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM counters WHERE name='seq'"
            ).fetchone()
        return Seq(row[0] if row else 0)

    # ---- shards -----------------------------------------------------------

    def create_shard(self, shard_id: str, kbid: str, config: dict | None = None) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO shards(id, kbid, config) VALUES(?,?,?)",
                (shard_id, kbid, json.dumps(config or {})),
            )

    def get_shard(self, shard_id: str) -> Optional[ShardMeta]:
        with self._lock:
            row = self._conn.execute(
                "SELECT id, kbid, config FROM shards WHERE id=? AND deleted_at IS NULL",
                (shard_id,),
            ).fetchone()
        return ShardMeta(row[0], row[1], json.loads(row[2])) if row else None

    def list_shards(self, kbid: str | None = None) -> list[ShardMeta]:
        q = "SELECT id, kbid, config FROM shards WHERE deleted_at IS NULL"
        args: tuple = ()
        if kbid is not None:
            q += " AND kbid=?"
            args = (kbid,)
        with self._lock:
            rows = self._conn.execute(q, args).fetchall()
        return [ShardMeta(r[0], r[1], json.loads(r[2])) for r in rows]

    def update_shard_config(self, shard_id: str, updates: dict) -> None:
        """Merge keys into the shard's config JSON (parity: NidxApi
        ConfigureShards — per-shard knobs like prewarm_enabled)."""
        with self._lock, self._conn:
            row = self._conn.execute(
                "SELECT config FROM shards WHERE id=? AND deleted_at IS NULL",
                (shard_id,),
            ).fetchone()
            if row is None:
                raise KeyError(shard_id)
            config = json.loads(row[0])
            config.update(updates)
            self._conn.execute(
                "UPDATE shards SET config=? WHERE id=?",
                (json.dumps(config), shard_id),
            )

    def delete_shard(self, shard_id: str) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE shards SET deleted_at=? WHERE id=?", (time.time(), shard_id)
            )
            # retire the shard's segments (blobs + rows purge later) — a
            # deleted shard's segments otherwise leaked forever, doubling
            # storage on every rollover
            self._conn.execute(
                "UPDATE segments SET delete_at=? WHERE index_id IN"
                " (SELECT id FROM indexes WHERE shard_id=?)",
                (time.time(), shard_id),
            )
            self._conn.execute(
                "UPDATE indexes SET deleted_at=? WHERE shard_id=?",
                (time.time(), shard_id),
            )

    # ---- indexes ----------------------------------------------------------

    def create_index(
        self, shard_id: str, kind: str, name: str, configuration: dict | None = None
    ) -> IndexMeta:
        now = time.time()
        with self._lock, self._conn:
            cur = self._conn.execute(
                "INSERT INTO indexes(shard_id, kind, name, configuration, updated_at)"
                " VALUES(?,?,?,?,?)",
                (shard_id, kind, name, json.dumps(configuration or {}), now),
            )
            return IndexMeta(cur.lastrowid, shard_id, kind, name, configuration or {}, now)

    def get_indexes(self, shard_id: str) -> list[IndexMeta]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT id, shard_id, kind, name, configuration, updated_at"
                " FROM indexes WHERE shard_id=? AND deleted_at IS NULL",
                (shard_id,),
            ).fetchall()
        return [
            IndexMeta(r[0], r[1], r[2], r[3], json.loads(r[4]), r[5]) for r in rows
        ]

    def get_index(self, index_id: int) -> "IndexMeta | None":
        """Primary-key lookup (merge workers resolve one index per job — a
        scan over every shard's indexes was O(shards) SQL round-trips)."""
        with self._lock:
            r = self._conn.execute(
                "SELECT id, shard_id, kind, name, configuration, updated_at"
                " FROM indexes WHERE id=? AND deleted_at IS NULL",
                (index_id,),
            ).fetchone()
        if r is None:
            return None
        return IndexMeta(r[0], r[1], r[2], r[3], json.loads(r[4]), r[5])

    def delete_index(self, index_id: int) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE indexes SET deleted_at=? WHERE id=?", (time.time(), index_id)
            )

    def retire_index_segments(self, index_id: int) -> None:
        """Schedule all of an index's segments for purge (vectorset delete:
        parity with the reference's purge_kb_vectorsets, purge/__init__.py)."""
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE segments SET delete_at=? WHERE index_id=?",
                (time.time(), index_id),
            )

    def touch_index(self, index_id: int) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE indexes SET updated_at=? WHERE id=?", (time.time(), index_id)
            )

    def indexes_updated_since(self, since: float) -> list[int]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT id FROM indexes WHERE updated_at > ? AND deleted_at IS NULL",
                (since,),
            ).fetchall()
        return [r[0] for r in rows]

    # ---- segments + deletions (the indexer's commit) ----------------------

    def create_segment(
        self,
        index_id: int,
        seq: Seq,
        records: int,
        *,
        size_bytes: int = 0,
        tags: list[str] | None = None,
        index_metadata: dict | None = None,
    ) -> SegmentRow:
        """A new segment, not yet visible (delete_at set; parity:
        migrations initial.sql delete_at = now + 5min)."""
        with self._lock, self._conn:
            cur = self._conn.execute(
                "INSERT INTO segments(index_id, seq, records, size_bytes, tags,"
                " index_metadata, ready, delete_at) VALUES(?,?,?,?,?,?,0,?)",
                (
                    index_id,
                    int(seq),
                    records,
                    size_bytes,
                    json.dumps(tags or []),
                    json.dumps(index_metadata or {}),
                    time.time() + SEGMENT_GRACE_S,
                ),
            )
            sid = cur.lastrowid
        return SegmentRow(
            sid, index_id, seq, records, size_bytes, tags or [],
            index_metadata or {}, False, None, None,
        )

    def create_segments(self, items: list[dict]) -> list[SegmentRow]:
        """Batched create_segment: ONE transaction (and, in component/HA
        mode, one RPC + one synchronous standby ship) for all of an
        operation's segments. Each item: {index_id, seq, records,
        size_bytes?, tags?, index_metadata?}."""
        rows: list[SegmentRow] = []
        with self._lock, self._conn:
            for it in items:
                tags = list(it.get("tags") or [])
                meta = dict(it.get("index_metadata") or {})
                cur = self._conn.execute(
                    "INSERT INTO segments(index_id, seq, records, size_bytes,"
                    " tags, index_metadata, ready, delete_at)"
                    " VALUES(?,?,?,?,?,?,0,?)",
                    (
                        int(it["index_id"]),
                        int(it["seq"]),
                        int(it["records"]),
                        int(it.get("size_bytes", 0)),
                        json.dumps(tags),
                        json.dumps(meta),
                        time.time() + SEGMENT_GRACE_S,
                    ),
                )
                rows.append(
                    SegmentRow(
                        cur.lastrowid, int(it["index_id"]), Seq(int(it["seq"])),
                        int(it["records"]), int(it.get("size_bytes", 0)),
                        tags, meta, False, None, None,
                    )
                )
        return rows

    def commit_operation(
        self,
        *,
        ready_segments: list[int],
        deletions: list[tuple[int, Seq, list[str]]],
        touched_indexes: list[int],
        replaced_segments: list[int] | None = None,
    ) -> None:
        """One transaction: segments visible + deletions recorded + updated_at
        bumped (+ merged-away segments scheduled for deletion).

        Parity: nidx/src/indexer.rs:355-374 (single PG txn).
        """
        now = time.time()
        with self._lock, self._conn:
            for sid in ready_segments:
                self._conn.execute(
                    "UPDATE segments SET ready=1, delete_at=NULL WHERE id=?", (sid,)
                )
            for index_id, seq, keys in deletions:
                if keys:
                    self._conn.execute(
                        "INSERT OR REPLACE INTO deletions(index_id, seq, keys)"
                        " VALUES(?,?,?)",
                        (index_id, int(seq), json.dumps(keys)),
                    )
            for index_id in touched_indexes:
                self._conn.execute(
                    "UPDATE indexes SET updated_at=? WHERE id=?", (now, index_id)
                )
            for sid in replaced_segments or []:
                self._conn.execute(
                    "UPDATE segments SET ready=0, delete_at=? WHERE id=?",
                    (now + SEGMENT_GRACE_S, sid),
                )

    def set_segment_size(self, segment_id: int, size_bytes: int) -> None:
        """Record the packed size after upload (create happens before the
        upload because the storage key embeds the row id)."""
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE segments SET size_bytes=? WHERE id=?",
                (int(size_bytes), segment_id),
            )

    def count_ready_segments(self) -> int:
        """Total READY segments across every index (the back-pressure
        merge-debt signal: each open segment costs searcher memmaps)."""
        with self._lock:
            return self._conn.execute(
                "SELECT COUNT(*) FROM segments WHERE ready=1"
            ).fetchone()[0]

    def ready_segments(self, index_id: int) -> list[SegmentRow]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT id, index_id, seq, records, size_bytes, tags,"
                " index_metadata, ready, merge_job_id, delete_at FROM segments"
                " WHERE index_id=? AND ready=1 ORDER BY seq",
                (index_id,),
            ).fetchall()
        return [self._segment_row(r) for r in rows]

    @staticmethod
    def _segment_row(r) -> SegmentRow:
        return SegmentRow(
            r[0], r[1], Seq(r[2]), r[3], r[4], json.loads(r[5]), json.loads(r[6]),
            bool(r[7]), r[8], r[9],
        )

    def deletions_for_index(self, index_id: int) -> list[tuple[str, Seq]]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT seq, keys FROM deletions WHERE index_id=? ORDER BY seq",
                (index_id,),
            ).fetchall()
        out = []
        for seq, keys in rows:
            for key in json.loads(keys):
                out.append((key, Seq(seq)))
        return out

    def purgeable_segments(self) -> list[SegmentRow]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT id, index_id, seq, records, size_bytes, tags,"
                " index_metadata, ready, merge_job_id, delete_at FROM segments"
                " WHERE delete_at IS NOT NULL AND delete_at < ?",
                (time.time(),),
            ).fetchall()
        return [self._segment_row(r) for r in rows]

    def drop_segment(self, segment_id: int) -> None:
        with self._lock, self._conn:
            self._conn.execute("DELETE FROM segments WHERE id=?", (segment_id,))

    def purge_deletions_below(self, index_id: int, seq: Seq) -> None:
        """Deletions at or below the oldest segment seq can never apply."""
        with self._lock, self._conn:
            self._conn.execute(
                "DELETE FROM deletions WHERE index_id=? AND seq<=?",
                (index_id, int(seq)),
            )

    # ---- merge jobs --------------------------------------------------------

    def enqueue_merge(self, index_id: int, seq: Seq, segment_ids: list[int]) -> Optional[int]:
        with self._lock, self._conn:
            taken = self._conn.execute(
                "SELECT COUNT(*) FROM segments WHERE id IN (%s) AND merge_job_id IS NOT NULL"
                % ",".join("?" * len(segment_ids)),
                segment_ids,
            ).fetchone()[0]
            if taken:
                return None
            cur = self._conn.execute(
                "INSERT INTO merge_jobs(index_id, seq, enqueued_at) VALUES(?,?,?)",
                (index_id, int(seq), time.time()),
            )
            job_id = cur.lastrowid
            self._conn.execute(
                "UPDATE segments SET merge_job_id=? WHERE id IN (%s)"
                % ",".join("?" * len(segment_ids)),
                [job_id] + segment_ids,
            )
        return job_id

    def take_merge_job(self) -> Optional[MergeJob]:
        """Lease the oldest runnable job (parity: MergeJob::take SKIP LOCKED).

        Jobs past MERGE_JOB_MAX_RETRIES are POISONED, not deleted: deleting
        released the operant segments back to the planner, which re-planned
        the identical merge with retries=0 — a deterministic failure looped
        forever at full speed. A poisoned job keeps its segments pinned
        (enqueue_merge skips segments with a merge_job_id) and only becomes
        runnable again after a long cooldown, so a transient cause can still
        recover while a deterministic one burns one attempt per cooldown."""
        now = time.time()
        with self._lock, self._conn:
            row = self._conn.execute(
                "SELECT id, index_id, seq, retries FROM merge_jobs"
                " WHERE (running_at IS NULL OR running_at < ?)"
                " AND (retries < ? OR COALESCE(running_at, 0) < ?)"
                " ORDER BY enqueued_at LIMIT 1",
                (
                    now - MERGE_JOB_STALE_S,
                    MERGE_JOB_MAX_RETRIES,
                    now - MERGE_JOB_POISON_RETRY_S,
                ),
            ).fetchone()
            if row is None:
                return None
            job_id, index_id, seq, retries = row
            self._conn.execute(
                "UPDATE merge_jobs SET running_at=?, started_at=COALESCE(started_at,?),"
                " retries=retries+1 WHERE id=?",
                (now, now, job_id),
            )
        return MergeJob(job_id, index_id, Seq(seq), retries)

    def heartbeat_merge_job(self, job_id: int) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE merge_jobs SET running_at=? WHERE id=?", (time.time(), job_id)
            )

    def merge_job_segments(self, job_id: int) -> list[SegmentRow]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT id, index_id, seq, records, size_bytes, tags,"
                " index_metadata, ready, merge_job_id, delete_at FROM segments"
                " WHERE merge_job_id=? ORDER BY seq",
                (job_id,),
            ).fetchall()
        return [self._segment_row(r) for r in rows]

    def _release_job(self, job_id: int) -> None:
        self._conn.execute(
            "UPDATE segments SET merge_job_id=NULL WHERE merge_job_id=?", (job_id,)
        )

    def finish_merge_job(self, job_id: int) -> None:
        with self._lock, self._conn:
            self._release_job(job_id)
            self._conn.execute("DELETE FROM merge_jobs WHERE id=?", (job_id,))

    def pending_merge_jobs(self) -> int:
        """Runnable jobs only — poisoned jobs (in cooldown) are not pending
        work for drains/back-pressure purposes."""
        now = time.time()
        with self._lock:
            return self._conn.execute(
                "SELECT COUNT(*) FROM merge_jobs"
                " WHERE retries < ? OR COALESCE(running_at, 0) < ?",
                (MERGE_JOB_MAX_RETRIES, now - MERGE_JOB_POISON_RETRY_S),
            ).fetchone()[0]

    # ---- ack floor (merge scheduling safety) -------------------------------

    def record_index_request(self, seq: Seq) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT OR IGNORE INTO index_requests(seq, acked, created_at)"
                " VALUES(?,0,?)",
                (int(seq), time.time()),
            )

    def ack_index_request(self, seq: Seq) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE index_requests SET acked=1 WHERE seq=?", (int(seq),)
            )

    def ack_floor(self) -> Seq:
        """Highest seq below which every request is acked (parity:
        scheduler.rs:66-96 ack-floor from PG index_requests)."""
        with self._lock:
            row = self._conn.execute(
                "SELECT MIN(seq) FROM index_requests WHERE acked=0"
            ).fetchone()
            if row[0] is not None:
                return Seq(row[0] - 1)
            row = self._conn.execute(
                "SELECT MAX(seq) FROM index_requests"
            ).fetchone()
            return Seq(row[0] if row[0] is not None else 0)

    def prune_acked_requests(self, below: Seq) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "DELETE FROM index_requests WHERE acked=1 AND seq<?", (int(below),)
            )

    def expire_stale_requests(self, ttl_s: float = 300.0) -> int:
        """Drop unacked index requests older than ttl (a crash between
        record_index_request and the ack would otherwise pin the ack floor
        forever, halting merges and eventually rejecting every write via
        back-pressure). Safe: a request that old either committed its
        op transactionally or left nothing behind — skipping it cannot
        merge past in-flight work."""
        import time as _time

        with self._lock, self._conn:
            cur = self._conn.execute(
                "DELETE FROM index_requests WHERE acked=0 AND created_at<?",
                (_time.time() - ttl_s,),
            )
            return cur.rowcount
