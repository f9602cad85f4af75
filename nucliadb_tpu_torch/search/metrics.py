"""Per-request phase timing for the search pipeline.

The port's copy of ``nucliadb_tpu/search/metrics.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity: reference `search/search/metrics.py` (`Metrics` spans passed down
the find pipeline, recorded into histograms, and surfaced via slow-query
logs at `find.py:180-196`). Phases here: embed (query vector via predict),
retrieval (shard fan-out), fusion (RRF/weighted), hydration (KV text fetch).
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager

from ..telemetry.metrics import Histogram

logger = logging.getLogger("nucliadb_tpu.search.slow")

# slow-query thresholds (reference: slow_find_log_threshold /
# slow_nidx_log_threshold in search/settings.py)
SLOW_FIND_S = 0.5
SLOW_PHASE_S = 0.3

_phase_histogram = Histogram(
    "ndbtpu_find_phase_seconds",
    "find pipeline phase duration",
    labelnames=("phase",),
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0),
)


class Metrics:
    """Collects named phase durations for one request."""

    def __init__(self, request_id: str = ""):
        self.request_id = request_id
        self.phases: dict[str, float] = {}
        self._start = time.monotonic()

    @contextmanager
    def time(self, phase: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            self.phases[phase] = self.phases.get(phase, 0.0) + dt
            _phase_histogram.labels(phase=phase).observe(dt)

    def elapsed(self) -> float:
        return time.monotonic() - self._start

    def to_dict(self) -> dict[str, float]:
        return dict(self.phases, total=self.elapsed())

    def log_if_slow(self, kind: str, detail: str = "") -> None:
        """Structured slow-query log (parity: find.py slow-query logging)."""
        total = self.elapsed()
        if total < SLOW_FIND_S and not any(
            v >= SLOW_PHASE_S for v in self.phases.values()
        ):
            return
        logger.warning(
            "slow %s query: total=%.3fs phases=%s %s",
            kind,
            total,
            {k: round(v, 3) for k, v in self.phases.items()},
            detail,
        )
