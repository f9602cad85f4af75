"""sqlite-backed ordered streams with durable consumers.

The port's copy of ``nucliadb_tpu/bus/stream.py``,
kept verbatim: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import sqlite3
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

MAX_DELIVERIES = 5  # parity: nidx/src/indexer.rs:170-174
DEFAULT_ACK_WAIT = 60.0

_SCHEMA = """
CREATE TABLE IF NOT EXISTS messages (
    stream TEXT NOT NULL,
    seq INTEGER NOT NULL,
    subject TEXT NOT NULL,
    payload BLOB NOT NULL,
    created_at REAL NOT NULL,
    PRIMARY KEY (stream, seq)
);
CREATE TABLE IF NOT EXISTS stream_counters (
    stream TEXT PRIMARY KEY,
    last_seq INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS consumers (
    stream TEXT NOT NULL,
    name TEXT NOT NULL,
    seq INTEGER NOT NULL,
    deliveries INTEGER NOT NULL DEFAULT 0,
    leased_until REAL,
    acked INTEGER NOT NULL DEFAULT 0,
    PRIMARY KEY (stream, name, seq)
);
"""


@dataclass
class BusMessage:
    stream: str
    seq: int
    subject: str
    payload: bytes
    deliveries: int


def _subject_clause(subject: str, subject_prefix: str) -> tuple[str, str]:
    """(SQL clause, bind value) — exact match when ``subject`` is given,
    else the prefix GLOB (empty prefix = everything)."""
    if subject:
        return "subject = ?", subject
    return "subject GLOB ?", subject_prefix + "*"


class EmbeddedBus:
    def __init__(self, path: str = ":memory:", ack_wait: float = DEFAULT_ACK_WAIT):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        # multi-worker standalone: replicas write audit events to the same
        # file; queue on contention instead of erroring
        self._conn.execute("PRAGMA busy_timeout=10000")
        self._lock = threading.RLock()
        self.ack_wait = ack_wait
        with self._lock, self._conn:
            self._conn.executescript(_SCHEMA)
        self._watchers: dict[str, list[Callable[[BusMessage], None]]] = {}

    # ---- publish ---------------------------------------------------------

    def backup(self, dest_path: str) -> None:
        """Consistent online snapshot (sqlite backup API)."""
        import sqlite3 as _sq

        dst = _sq.connect(dest_path)
        try:
            with self._lock:
                self._conn.backup(dst)
        finally:
            dst.close()

    def publish_many(self, stream: str, items: "list[tuple[str, bytes]]") -> int:
        """Publish a batch of (subject, payload) in ONE transaction (the
        buffered audit path); returns the last assigned seq."""
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO stream_counters(stream, last_seq) VALUES(?, ?)"
                " ON CONFLICT(stream) DO UPDATE SET last_seq = last_seq + ?",
                (stream, len(items), len(items)),
            )
            last = self._conn.execute(
                "SELECT last_seq FROM stream_counters WHERE stream=?", (stream,)
            ).fetchone()[0]
            now = time.time()
            self._conn.executemany(
                "INSERT INTO messages(stream, seq, subject, payload, created_at)"
                " VALUES(?,?,?,?,?)",
                [
                    (stream, last - len(items) + 1 + i, subject, payload, now)
                    for i, (subject, payload) in enumerate(items)
                ],
            )
        for cb in self._watchers.get(stream, []):
            for i, (subject, payload) in enumerate(items):
                cb(BusMessage(stream, last - len(items) + 1 + i, subject, payload, 0))
        return last

    def publish(self, stream: str, subject: str, payload: bytes) -> int:
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO stream_counters(stream, last_seq) VALUES(?, 1)"
                " ON CONFLICT(stream) DO UPDATE SET last_seq = last_seq + 1",
                (stream,),
            )
            seq = self._conn.execute(
                "SELECT last_seq FROM stream_counters WHERE stream=?", (stream,)
            ).fetchone()[0]
            self._conn.execute(
                "INSERT INTO messages(stream, seq, subject, payload, created_at)"
                " VALUES(?,?,?,?,?)",
                (stream, seq, subject, payload, time.time()),
            )
        for cb in self._watchers.get(stream, []):
            cb(BusMessage(stream, seq, subject, payload, 0))
        return seq

    def watch(self, stream: str, callback: Callable[[BusMessage], None]) -> None:
        """Push notification on publish (parity: NATS pubsub notify.{kbid})."""
        self._watchers.setdefault(stream, []).append(callback)

    def scan(
        self,
        stream: str,
        *,
        subject_prefix: str = "",
        subject: str = "",
        after_seq: int = 0,
        limit: int = 100,
    ) -> list[BusMessage]:
        """Read-only cursor scan: no consumer state, repeatable (parity:
        JetStream DeliverByStartSequence ephemeral consumers). Used by the
        notifications API so repeated polls with the same cursor re-deliver.

        ``subject`` matches exactly (a prefix GLOB would cross-match
        'task.export' onto 'task.export-kb' subjects)."""
        clause, pat = _subject_clause(subject, subject_prefix)
        with self._lock, self._conn:
            rows = self._conn.execute(
                "SELECT seq, subject, payload FROM messages"
                f" WHERE stream = ? AND {clause} AND seq > ?"
                " ORDER BY seq LIMIT ?",
                (stream, pat, after_seq, limit),
            ).fetchall()
        return [BusMessage(stream, seq, subject, payload, 0) for seq, subject, payload in rows]

    # ---- consume ---------------------------------------------------------

    def next(
        self, stream: str, consumer: str, *, subject_prefix: str = "",
        subject: str = "",
    ) -> Optional[BusMessage]:
        """Lease the next deliverable message (strictly ordered; at-least-once).

        Ordering is strict per consumer: if the earliest unacked matching
        message is still leased (e.g. a crashed consumer's in-flight write),
        nothing newer is delivered until the lease expires — skipping ahead
        would apply writes out of order.
        """
        now = time.time()
        clause, pat = _subject_clause(subject, subject_prefix)
        with self._lock, self._conn:
            row = self._conn.execute(
                "SELECT m.seq, m.subject, m.payload,"
                " COALESCE(c.deliveries, 0), c.leased_until, COALESCE(c.acked, 0)"
                " FROM messages m LEFT JOIN consumers c"
                "   ON c.stream = m.stream AND c.seq = m.seq AND c.name = ?"
                f" WHERE m.stream = ? AND {clause}"
                "   AND COALESCE(c.acked, 0) = 0"
                " ORDER BY m.seq LIMIT 1",
                (consumer, stream, pat),
            ).fetchone()
            if row is None:
                return None
            seq, msg_subject, payload, deliveries, leased_until, _ = row
            if leased_until is not None and leased_until >= now:
                return None  # earliest message in flight: hold ordering
            if deliveries >= MAX_DELIVERIES:
                # poison message: skip + ack (parity: indexer.rs redelivery cap)
                self._conn.execute(
                    "INSERT INTO consumers(stream, name, seq, deliveries, acked)"
                    " VALUES(?,?,?,?,1) ON CONFLICT(stream, name, seq)"
                    " DO UPDATE SET acked=1",
                    (stream, consumer, seq, deliveries),
                )
                # re-enter with the ORIGINAL filters — dropping the exact
                # subject here handed a subject-filtered consumer the next
                # unacked message of ANY subject on the stream
                return self.next(
                    stream, consumer,
                    subject_prefix=subject_prefix, subject=subject,
                )
            self._conn.execute(
                "INSERT INTO consumers(stream, name, seq, deliveries, leased_until)"
                " VALUES(?,?,?,?,?) ON CONFLICT(stream, name, seq)"
                " DO UPDATE SET deliveries = deliveries + 1, leased_until = excluded.leased_until",
                (stream, consumer, seq, deliveries + 1, now + self.ack_wait),
            )
            return BusMessage(stream, seq, msg_subject, payload, deliveries + 1)

    def ack(self, stream: str, consumer: str, seq: int) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO consumers(stream, name, seq, deliveries, acked)"
                " VALUES(?,?,?,1,1) ON CONFLICT(stream, name, seq)"
                " DO UPDATE SET acked=1, leased_until=NULL",
                (stream, consumer, seq),
            )

    def nak(
        self, stream: str, consumer: str, seq: int, delay: float | None = None
    ) -> None:
        """Release the lease for redelivery after ``delay`` seconds
        (default: the stream's ack_wait — immediate redelivery would let a
        ~1s transient outage burn all MAX_DELIVERIES and silently
        poison-skip real messages; parity: NATS redelivers after ack_wait)."""
        until = time.time() + (self.ack_wait if delay is None else delay)
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE consumers SET leased_until=? WHERE stream=? AND name=? AND seq=?",
                (until, stream, consumer, seq),
            )

    def in_progress(self, stream: str, consumer: str, seq: int) -> None:
        """Extend the lease (parity: ack keepalive at 80% of ack_wait)."""
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE consumers SET leased_until=? WHERE stream=? AND name=? AND seq=?",
                (time.time() + self.ack_wait, stream, consumer, seq),
            )

    # ---- introspection -----------------------------------------------------

    def last_seq(self, stream: str) -> int:
        with self._lock:
            row = self._conn.execute(
                "SELECT last_seq FROM stream_counters WHERE stream=?", (stream,)
            ).fetchone()
        return row[0] if row else 0

    def ack_floor(self, stream: str, consumer: str, *, subject_prefix: str = "") -> int:
        """Highest seq below which every message THIS CONSUMER SEES is acked.

        The subject filter must match the consumer's, or foreign-subject
        messages pin the floor forever (multi-partition streams).
        """
        with self._lock:
            row = self._conn.execute(
                "SELECT MIN(m.seq) FROM messages m LEFT JOIN consumers c"
                " ON c.stream=m.stream AND c.seq=m.seq AND c.name=?"
                " WHERE m.stream=? AND m.subject GLOB ? AND COALESCE(c.acked, 0)=0",
                (consumer, stream, subject_prefix + "*"),
            ).fetchone()
            if row[0] is not None:
                return row[0] - 1
            return self.last_seq(stream)

    def pending(self, stream: str, consumer: str, *, subject_prefix: str = "") -> int:
        """Unacked depth — the back-pressure signal
        (common/back_pressure/materializer.py)."""
        with self._lock:
            row = self._conn.execute(
                "SELECT COUNT(*) FROM messages m LEFT JOIN consumers c"
                " ON c.stream=m.stream AND c.seq=m.seq AND c.name=?"
                " WHERE m.stream=? AND m.subject GLOB ? AND COALESCE(c.acked, 0)=0",
                (consumer, stream, subject_prefix + "*"),
            ).fetchone()
        return row[0]

    def purge_older_than(self, stream: str, age_s: float) -> int:
        """Retention purge for scan-consumed streams (notify, audit):
        nothing acks them, so age is the only bound on growth."""
        cutoff = time.time() - age_s
        with self._lock, self._conn:
            cur = self._conn.execute(
                "DELETE FROM messages WHERE stream=? AND created_at<?",
                (stream, cutoff),
            )
            self._conn.execute(
                "DELETE FROM consumers WHERE stream=? AND seq NOT IN"
                " (SELECT seq FROM messages WHERE stream=?)",
                (stream, stream),
            )
            return cur.rowcount

    def purge_acked(
        self, stream: str, consumers: list[tuple[str, str]] | list[str]
    ) -> int:
        """Drop messages acked by every listed consumer. Entries may be plain
        consumer names or (name, subject_prefix) pairs."""
        floors = []
        for entry in consumers:
            if isinstance(entry, tuple):
                name, prefix = entry
            else:
                name, prefix = entry, ""
            floors.append(self.ack_floor(stream, name, subject_prefix=prefix))
        floor = min(floors) if floors else 0
        with self._lock, self._conn:
            cur = self._conn.execute(
                "DELETE FROM messages WHERE stream=? AND seq<=?", (stream, floor)
            )
            # matching consumer rows must go too or the table grows without
            # bound on long-running components
            self._conn.execute(
                "DELETE FROM consumers WHERE stream=? AND seq<=?", (stream, floor)
            )
        return cur.rowcount
