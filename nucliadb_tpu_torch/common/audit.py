"""Audit reporting: search/modify/delete events to an audit stream.

The port's copy of ``nucliadb_tpu/common/audit.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity: nucliadb_utils/src/nucliadb_utils/audit/stream.py:66-163 — audit
events are fire-and-forget messages on a dedicated stream; consumers ship
them to billing/analytics. Here they ride the embedded bus.
"""

from __future__ import annotations

import json
import time
from enum import Enum
from typing import Optional

from ..bus import EmbeddedBus

AUDIT_STREAM = "ndb_audit"


class AuditType(str, Enum):
    VISITED = "visited"
    MODIFIED = "modified"
    DELETED = "deleted"
    NEW = "new"
    SEARCH = "search"
    SUGGEST = "suggest"
    CHAT = "chat"
    STORAGE = "storage"


class AuditStream:
    def __init__(self, bus: Optional[EmbeddedBus] = None, *, buffered: bool = False):
        """``buffered`` batches events off the request path (a daemon thread
        flushes every ~0.2 s; one bus txn per batch instead of one per
        event, which cost ~0.5 ms of the /find hot path). Fire-and-forget
        semantics match the reference (audit rides async NATS publishes,
        nucliadb_utils/audit/stream.py); ``flush()`` forces delivery."""
        self.bus = bus
        self._buffer: list[tuple[str, bytes]] = []
        self._buffered = buffered and bus is not None
        if self._buffered:
            import threading

            self._lock = threading.Lock()
            self._stop = threading.Event()
            self._thread = threading.Thread(target=self._flush_loop, daemon=True)
            self._thread.start()

    def _flush_loop(self) -> None:
        while not self._stop.wait(0.2):
            self.flush()

    def flush(self) -> None:
        if not self._buffered or not self._buffer:
            return
        with self._lock:
            batch, self._buffer = self._buffer, []
        if batch:
            self.bus.publish_many(AUDIT_STREAM, batch)

    def close(self) -> None:
        if self._buffered:
            self._stop.set()
            self.flush()

    def report(
        self,
        *,
        kbid: str,
        audit_type: AuditType,
        rid: str = "",
        user: str = "",
        client_type: str = "",
        duration_ms: Optional[float] = None,
        detail: Optional[dict] = None,
    ) -> None:
        if self.bus is None:
            return
        event = {
            "kbid": kbid,
            "type": audit_type.value,
            "rid": rid,
            "user": user,
            "client_type": client_type,
            "when": time.time(),
            "detail": detail or {},
        }
        if duration_ms is not None:
            event["duration_ms"] = round(duration_ms, 3)
        subject, payload = f"audit.{kbid}", json.dumps(event).encode()
        if self._buffered:
            with self._lock:
                self._buffer.append((subject, payload))
            return
        self.bus.publish(AUDIT_STREAM, subject, payload)

    def search(
        self,
        kbid: str,
        query: str,
        results: int,
        user: str = "",
        client_type: str = "",
        duration_ms: Optional[float] = None,
    ) -> None:
        self.report(
            kbid=kbid,
            audit_type=AuditType.SEARCH,
            user=user,
            client_type=client_type,
            duration_ms=duration_ms,
            detail={"query": query, "results": results},
        )

    def suggest(
        self, kbid: str, query: str, user: str = "", client_type: str = "",
        duration_ms: Optional[float] = None,
    ) -> None:
        self.report(
            kbid=kbid, audit_type=AuditType.SUGGEST, user=user,
            client_type=client_type, duration_ms=duration_ms,
            detail={"query": query},
        )

    def chat(
        self,
        kbid: str,
        question: str,
        answer: str,
        *,
        rephrased_question: str = "",
        status: str = "",
        user: str = "",
        client_type: str = "",
        duration_ms: Optional[float] = None,
    ) -> None:
        """RAG interaction report (parity: audit stream ChatAudit — question,
        rephrased question, answer, status code)."""
        self.report(
            kbid=kbid,
            audit_type=AuditType.CHAT,
            user=user,
            client_type=client_type,
            duration_ms=duration_ms,
            detail={
                "question": question,
                "rephrased_question": rephrased_question,
                "answer": answer[:2048],
                "status": status,
            },
        )
