"""Embedded ordered message bus (the NATS JetStream role).

The port's copy of ``nucliadb_tpu/bus/__init__.py``,
kept verbatim: the port imports nothing of the JAX package.

The reference's ingestion plane rides NATS JetStream: ordered, persistent,
at-least-once streams with consumer ack floors driving merge scheduling and
back-pressure (nucliadb_utils/const.py streams, nidx/src/indexer.rs:121
run_nats, scheduler.rs ack floor). This embedded bus reproduces those
semantics on sqlite so single-host/component deployments need no external
broker; a NATS-backed implementation can slot behind the same interface for
multi-host clusters.

Semantics:
- streams are append-only sequences of (seq, subject, payload),
- consumers are durable cursors with in-flight leases: messages are
  redelivered after ack_wait expires, up to max_deliveries, then skipped
  (parity: indexer.rs <=5 redeliveries then skip+ack),
- per-subject ordering follows from per-stream total order,
- ``pending()`` exposes queue depth for back-pressure
  (common/back_pressure/materializer.py).
"""

from .stream import BusMessage, EmbeddedBus

__all__ = ["EmbeddedBus", "BusMessage"]
