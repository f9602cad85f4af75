"""Back-pressure: reject writes when the ingest pipeline lags.

The port's copy of ``nucliadb_tpu/common/back_pressure.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity: nucliadb/src/nucliadb/common/back_pressure/materializer.py:48-210 —
the writer consults queue depths (NATS consumer pending counts there; bus
pending / unsynced index requests here) and returns 429 with a
``try_after`` estimate when thresholds are exceeded.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

from ..bus import EmbeddedBus
from ..metadata import MetadataStore


@dataclass
class BackPressureSettings:
    max_indexing_pending: int = 1000
    max_ingest_pending: int = 1000
    estimated_rate_per_s: float = 50.0
    # unmerged-segment throttle: every READY segment costs open searcher
    # memmaps (several file descriptors each), so sustained ingest that
    # outpaces the merge scheduler must back off before the process
    # exhausts its fd budget (caught live by a 15-minute mixed soak:
    # 33k single-resource ingests at ~37/s starved the 1-core merge loop
    # and hit EMFILE at ~20k fds). The reference carries the same
    # merge-debt failure mode; its mitigation is merge workers keeping up.
    max_ready_segments: int = 2000
    estimated_merge_segments_per_s: float = 40.0


class TryAfterError(Exception):
    def __init__(self, try_after: float, reason: str):
        self.try_after = try_after
        self.reason = reason
        super().__init__(f"back pressure: {reason}; retry after {try_after:.1f}s")


class BackPressureMaterializer:
    def __init__(
        self,
        metadata: MetadataStore,
        bus: Optional[EmbeddedBus] = None,
        settings: Optional[BackPressureSettings] = None,
    ):
        self.metadata = metadata
        self.bus = bus
        self.settings = settings or BackPressureSettings()

    def indexing_pending(self) -> int:
        # unacked index requests = operations committed but not fully indexed
        floor = self.metadata.ack_floor()
        last = self.metadata.last_seq()
        return max(int(last) - int(floor), 0)

    def ingest_pending(self, stream: str = "ndb_ingest", consumer: str = "ingest_0") -> int:
        if self.bus is None:
            return 0
        return self.bus.pending(stream, consumer)

    _SEG_COUNT_TTL = 2.0  # COUNT query cached; the threshold is coarse

    def ready_segments_total(self) -> int:
        now = time.monotonic()
        cached = getattr(self, "_seg_count_cache", None)
        if cached is not None and now - cached[0] < self._SEG_COUNT_TTL:
            return cached[1]
        n = self.metadata.count_ready_segments()
        self._seg_count_cache = (now, n)
        return n

    def check_indexing(self) -> None:
        pending = self.indexing_pending()
        if pending > self.settings.max_indexing_pending:
            raise TryAfterError(
                pending / self.settings.estimated_rate_per_s, "indexing behind"
            )
        segs = self.ready_segments_total()
        if segs > self.settings.max_ready_segments:
            excess = segs - self.settings.max_ready_segments
            raise TryAfterError(
                max(excess / self.settings.estimated_merge_segments_per_s, 1.0),
                "merge backlog: too many unmerged segments",
            )

    def check_ingest(self) -> None:
        pending = self.ingest_pending()
        if pending > self.settings.max_ingest_pending:
            raise TryAfterError(
                pending / self.settings.estimated_rate_per_s, "ingest behind"
            )
