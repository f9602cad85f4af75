"""Keyed locks (parity: reference common/locking.py distributed resource
locks, used by the ingest processor at processor.py:221-223).

The port's copy of ``nucliadb_tpu/common/locking.py``,
kept verbatim: the port imports nothing of the JAX package.

Embedded deployments run one process, so a keyed threading.Lock gives the
same exclusion the reference gets from its distributed lock; multi-process
deployments route writes through the single bus consumer per partition,
which serializes per-resource operations the same way the reference's
NATS-partition ordering does.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class KeyedLock:
    """One lock per key, created on demand; idle entries are pruned so the
    map does not grow with every resource ever touched."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._locks: dict[str, threading.Lock] = {}
        self._waiters: dict[str, int] = {}

    @contextmanager
    def hold(self, key: str):
        with self._mu:
            lock = self._locks.setdefault(key, threading.Lock())
            self._waiters[key] = self._waiters.get(key, 0) + 1
        lock.acquire()
        try:
            yield
        finally:
            lock.release()
            with self._mu:
                self._waiters[key] -= 1
                if self._waiters[key] == 0:
                    self._waiters.pop(key, None)
                    self._locks.pop(key, None)
