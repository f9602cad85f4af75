"""Launch and dispatch counters that threads can share.

A ``Counter``'s ``c[key] += 1`` is a read and a write, and two threads can
interleave between them and lose a count. The node runs a request's vector
and keyword legs on two threads, and the coalescers let several dispatchers
drain at once, so the counters that show which kernel or program served a
request count under a lock.
"""

from __future__ import annotations

import threading
from collections import Counter


class LaunchCounter(Counter):
    """A ``Counter`` whose ``add`` is atomic across threads."""

    def __init__(self) -> None:
        super().__init__()
        self._lock = threading.Lock()

    def add(self, key: str) -> None:
        with self._lock:
            self[key] += 1
