"""Generic task framework over the bus.

The port's copy of ``nucliadb_tpu/tasks/__init__.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity: nucliadb/src/nucliadb/tasks/ — registered producer/consumer pairs on
dedicated NATS streams (tasks/producer.py create_producer, tasks/consumer.py
:40-111 NatsTaskConsumer): producers validate a typed message before
publishing; consumers invoke the registered callback with at-least-once
semantics, bounded retries and poison-message skipping (the bus enforces the
reference's <=5 redeliveries); messages that exhaust their deliveries are
recorded on a dead-letter subject for operator inspection instead of being
silently dropped.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass
from typing import Callable, Optional, Type

from ..bus import EmbeddedBus
from ..bus.stream import MAX_DELIVERIES

logger = logging.getLogger(__name__)

TASK_STREAM = "ndb_tasks"
DLQ_PREFIX = "dlq."


@dataclass
class TaskMessage:
    kbid: str
    payload: dict

    def validate(self) -> None:
        if not self.kbid:
            raise ValueError("task message requires kbid")


class TaskProducer:
    """Publishes typed task messages to the task stream.

    ``message_type`` may be any class with ``kbid``/``payload`` attributes
    and an optional ``validate()`` — the reference validates its pydantic
    task models the same way before the NATS publish.
    """

    def __init__(self, bus: EmbeddedBus, name: str,
                 message_type: Type = TaskMessage):
        self.bus = bus
        self.name = name
        self.message_type = message_type

    def send(self, kbid: str, **payload) -> int:
        msg = self.message_type(kbid=kbid, payload=payload)
        if hasattr(msg, "validate"):
            msg.validate()
        return self.bus.publish(
            TASK_STREAM,
            f"task.{self.name}",
            json.dumps({"kbid": msg.kbid, "payload": msg.payload}).encode(),
        )


class TaskConsumer:
    """Consumes one task type; bounded retries, then dead-letter.

    A failing callback naks the message for redelivery; once the bus-side
    delivery cap is reached the message is copied to ``dlq.{name}`` and
    acked so the stream keeps moving (parity: indexer.rs skip-after-5 with
    the added DLQ record for visibility).
    """

    def __init__(self, bus: EmbeddedBus, name: str,
                 callback: Callable[[TaskMessage], None],
                 message_type: Type = TaskMessage):
        self.bus = bus
        self.name = name
        self.callback = callback
        self.message_type = message_type
        self.consumer = f"task_consumer_{name}"

    def work_once(self) -> bool:
        # exact subject: a prefix GLOB would leak task 'export-kb' messages
        # into the 'export' consumer (wrong handler, silently acked)
        msg = self.bus.next(TASK_STREAM, self.consumer, subject=f"task.{self.name}")
        if msg is None:
            return False
        try:
            data = json.loads(msg.payload)
            self.callback(self.message_type(kbid=data["kbid"], payload=data["payload"]))
        except Exception:
            logger.exception(
                "task %s seq=%d failed (delivery %d/%d)",
                self.name, msg.seq, msg.deliveries, MAX_DELIVERIES,
            )
            if msg.deliveries >= MAX_DELIVERIES:
                # final attempt: dead-letter + ack so the queue keeps moving
                self.bus.publish(
                    TASK_STREAM, f"{DLQ_PREFIX}{self.name}", msg.payload
                )
                self.bus.ack(TASK_STREAM, self.consumer, msg.seq)
            else:
                self.bus.nak(TASK_STREAM, self.consumer, msg.seq)
            return True
        self.bus.ack(TASK_STREAM, self.consumer, msg.seq)
        return True

    def drain(self) -> int:
        n = 0
        while self.work_once():
            n += 1
        return n

    def dead_letters(self) -> list[TaskMessage]:
        """Read this task's dead-letter records (newest last)."""
        out = []
        for m in self.bus.scan(TASK_STREAM, subject=f"{DLQ_PREFIX}{self.name}"):
            data = json.loads(m.payload)
            out.append(self.message_type(kbid=data["kbid"], payload=data["payload"]))
        return out


# ---- registry (parity: tasks/registry.py create_producer/create_consumer) --

_PRODUCERS: dict[str, TaskProducer] = {}


def create_producer(bus: EmbeddedBus, name: str,
                    message_type: Type = TaskMessage) -> TaskProducer:
    if name not in _PRODUCERS or _PRODUCERS[name].bus is not bus:
        _PRODUCERS[name] = TaskProducer(bus, name, message_type)
    return _PRODUCERS[name]


def create_consumer(bus: EmbeddedBus, name: str,
                    callback: Callable[[TaskMessage], None],
                    message_type: Type = TaskMessage) -> TaskConsumer:
    return TaskConsumer(bus, name, callback, message_type)
