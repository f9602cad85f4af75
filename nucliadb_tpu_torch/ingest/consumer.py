"""Ingest consumer: ordered resource writes from the bus (component mode).

The port's copy of ``nucliadb_tpu/ingest/consumer.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity with the reference's ingest consumer
(nucliadb/src/nucliadb/ingest/consumer/consumer.py:69-271): the writer
publishes BrokerMessage-equivalents to the ingest stream; a consumer per
partition processes them strictly in order (seq monotonicity checked —
SequenceOrderViolation parity), applies them through the Processor, and
publishes an "indexed" notification for writers waiting on commit
(notify.{kbid} parity).
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass
from typing import Optional

import msgpack

from ..bus import EmbeddedBus
from ..common.kb import KnowledgeBoxManager
from ..models.api import CreateResourcePayload, UpdateResourcePayload
from .processor import Processor

INGEST_STREAM = "ndb_ingest"
NOTIFY_STREAM = "ndb_notify"
CONSUMER = "ingest"


class SequenceOrderViolation(Exception):
    pass


@dataclass
class BrokerMessage:
    """A write operation in transit (parity: writer.proto BrokerMessage).
    ``headers`` carries the trace context across the process boundary
    (parity: NATS-header trace propagation, telemetry.rs + indexer.rs:180)."""

    kbid: str
    rid: Optional[str]
    op: str  # create | update | delete
    payload: Optional[dict] = None
    headers: Optional[dict] = None

    def pack(self) -> bytes:
        return msgpack.packb(
            {"kbid": self.kbid, "rid": self.rid, "op": self.op,
             "payload": self.payload, "headers": self.headers}
        )

    @staticmethod
    def unpack(data: bytes) -> "BrokerMessage":
        return BrokerMessage(**msgpack.unpackb(data))


class TransactionUtility:
    """Writer-side commit: publish a BrokerMessage (transaction.py:95 parity)."""

    def __init__(self, bus: EmbeddedBus, partitions: int = 1):
        self.bus = bus
        self.partitions = partitions

    def _partition(self, kbid: str) -> int:
        import zlib

        # stable across processes (builtin hash() is salted per process and
        # would route one KB to different partitions after a restart,
        # breaking per-partition ordering)
        return zlib.crc32(kbid.encode()) % self.partitions

    def commit(self, message: BrokerMessage) -> int:
        if message.op == "create" and not message.rid:
            # stamp the rid at PUBLISH time: a redelivered create must reuse
            # the same rid (at-least-once would otherwise mint a duplicate
            # resource per delivery)
            import uuid

            message.rid = uuid.uuid4().hex
        from ..telemetry.tracing import inject_context

        message.headers = inject_context(dict(message.headers or {}))
        # trailing '.' delimiter: the consumer filter is a GLOB prefix, and
        # 'ingest.1' would also match partitions 10..19
        subject = f"ingest.{self._partition(message.kbid)}."
        return self.bus.publish(INGEST_STREAM, subject, message.pack())


class IngestConsumer:
    def __init__(self, bus: EmbeddedBus, processor: Processor, partition: int = 0):
        self.bus = bus
        self.processor = processor
        self.partition = partition
        self.consumer = f"{CONSUMER}_{partition}"
        self._last_seq = 0

    def work_once(self) -> bool:
        msg = self.bus.next(
            INGEST_STREAM, self.consumer, subject_prefix=f"ingest.{self.partition}."
        )
        if msg is None:
            return False
        if msg.seq <= self._last_seq and msg.deliveries == 1:
            raise SequenceOrderViolation(f"seq {msg.seq} <= {self._last_seq}")
        from ..telemetry.tracing import extract_context, span

        bm = None
        try:
            # unpack INSIDE the containment: an undecodable payload must
            # nak like any other per-message failure, not kill the process
            bm = BrokerMessage.unpack(msg.payload)
            with span(
                "ingest.process",
                context=extract_context(bm.headers or {}),
                kbid=bm.kbid, op=bm.op,
            ):
                if bm.op == "create":
                    payload = CreateResourcePayload.model_validate(bm.payload)
                    rid, seq = self.processor.create_resource(bm.kbid, payload, rid=bm.rid)
                elif bm.op == "update":
                    payload = UpdateResourcePayload.model_validate(bm.payload)
                    seq = self.processor.update_resource(bm.kbid, bm.rid, payload)
                    rid = bm.rid
                elif bm.op == "delete":
                    seq = self.processor.delete_resource(bm.kbid, bm.rid)
                    rid = bm.rid
                else:
                    raise ValueError(f"unknown op {bm.op!r}")
        except Exception:
            # per-message failure: nak for redelivery (<= MAX_DELIVERIES,
            # then the bus poison-skips it) and KEEP CONSUMING — raising
            # here killed the whole component process and crash-looped it
            # on every redelivery of one malformed message (parity: the
            # reference indexer naks and continues, indexer.rs:170-174)
            logging.getLogger(__name__).exception(
                "ingest message seq=%s kbid=%s op=%s failed; nak'd",
                msg.seq,
                bm.kbid if bm is not None else "?",
                bm.op if bm is not None else "?",
            )
            # redelivery is paced by the bus ack_wait (nak default), so a
            # transient outage does not burn all MAX_DELIVERIES instantly
            self.bus.nak(INGEST_STREAM, self.consumer, msg.seq)
            # False ends this drain so the component loop moves on
            return False
        self.bus.ack(INGEST_STREAM, self.consumer, msg.seq)
        self._last_seq = msg.seq
        # "indexed" notification (parity: notify.{kbid}, indexer.rs:239-248)
        self.bus.publish(
            NOTIFY_STREAM,
            f"notify.{bm.kbid}",
            json.dumps(
                {"kbid": bm.kbid, "rid": rid, "op": bm.op,
                 "seq": int(seq) if seq is not None else None}
            ).encode(),
        )
        return True

    def drain(self) -> int:
        n = 0
        while self.work_once():
            n += 1
        return n
