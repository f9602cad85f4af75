"""Ingest: resource writes -> KV state + index messages.

The port's copy of ``nucliadb_tpu/ingest/__init__.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity with the reference's ingest ORM
(nucliadb/src/nucliadb/ingest/orm/): the Processor persists resource state
to the main KV and builds the "brain" (the per-resource index message,
brain_v2.py) that the index node consumes. The embedded deployment has no
NATS hop — the processor calls the node directly; the component deployment
routes the same ResourceDoc through the bus.
"""

from .brain import ResourceBrain
from .processor import Processor

__all__ = ["ResourceBrain", "Processor"]
