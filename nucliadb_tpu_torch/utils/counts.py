"""Launch and dispatch counters that threads can share.

A ``Counter``'s ``c[key] += 1`` is a read and a write, and two threads can
interleave between them and lose a count. The node runs a request's vector
and keyword legs on two threads, and the coalescers let several dispatchers
drain at once, so the counters that show which kernel or program served a
request count under a lock.

A CUDA graph's capture puts nothing on the card, its replays do: inside
``recording()`` a thread's ``add``s are collected instead of counted, and
``count`` adds them again at each replay.
"""

from __future__ import annotations

import threading
from collections import Counter
from contextlib import contextmanager

_RECORDING = threading.local()


class LaunchCounter(Counter):
    """A ``Counter`` whose ``add`` is atomic across threads."""

    def __init__(self) -> None:
        super().__init__()
        self._lock = threading.Lock()

    def add(self, key: str) -> None:
        adds = getattr(_RECORDING, "adds", None)
        if adds is not None:
            adds.append((self, key))
            return
        with self._lock:
            self[key] += 1


@contextmanager
def recording():
    """Collect this thread's ``add``s as ``(counter, key)`` pairs in the
    yielded list, counting none of them."""
    adds = _RECORDING.adds = []
    try:
        yield adds
    finally:
        _RECORDING.adds = None


def count(adds) -> None:
    """Count the ``(counter, key)`` pairs of a ``recording()``."""
    for counter, key in adds:
        counter.add(key)
