"""Prometheus metrics + the Observer timing decorator.

The port's copy of ``nucliadb_tpu/telemetry/metrics.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity: nucliadb_telemetry/src/nucliadb_telemetry/metrics.py (Observer,
Counter, Gauge, Histogram wrappers) and the nidx per-component metric
families (nidx/src/metrics.rs — indexing counters/time per index kind,
merge counters, sync delay).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from functools import wraps
from typing import Optional

import prometheus_client
from prometheus_client import CollectorRegistry, generate_latest

REGISTRY = CollectorRegistry()


def Counter(name: str, documentation: str = "", labelnames: tuple = ()):
    return prometheus_client.Counter(
        name, documentation or name, labelnames=labelnames, registry=REGISTRY
    )


def Gauge(name: str, documentation: str = "", labelnames: tuple = ()):
    return prometheus_client.Gauge(
        name, documentation or name, labelnames=labelnames, registry=REGISTRY
    )


def Histogram(name: str, documentation: str = "", labelnames: tuple = (), buckets=None):
    kwargs = {"registry": REGISTRY, "labelnames": labelnames}
    if buckets is not None:
        kwargs["buckets"] = buckets
    return prometheus_client.Histogram(name, documentation or name, **kwargs)


class Observer:
    """Timed+counted operation metric (decorator or context manager).

    Usage parity with nucliadb_telemetry.metrics.Observer:

        obs = Observer("indexer", labels={"kind": ""})
        with obs({"kind": "vector"}): ...
        @obs.wrap({"kind": "text"})
        def fn(): ...
    """

    def __init__(self, name: str, labels: Optional[dict[str, str]] = None):
        labelnames = tuple(labels) if labels else ()
        self.histogram = Histogram(f"{name}_duration_seconds", labelnames=labelnames)
        self.counter = Counter(
            f"{name}_total", labelnames=labelnames + ("status",)
        )

    @contextmanager
    def __call__(self, labels: Optional[dict[str, str]] = None):
        labels = labels or {}
        start = time.monotonic()
        status = "ok"
        try:
            yield
        except Exception:
            status = "error"
            raise
        finally:
            elapsed = time.monotonic() - start
            if labels:
                self.histogram.labels(**labels).observe(elapsed)
                self.counter.labels(**labels, status=status).inc()
            else:
                self.histogram.observe(elapsed)
                self.counter.labels(status=status).inc()

    def wrap(self, labels: Optional[dict[str, str]] = None):
        def decorator(fn):
            @wraps(fn)
            def inner(*args, **kwargs):
                with self(labels):
                    return fn(*args, **kwargs)

            return inner

        return decorator


def render_prometheus() -> bytes:
    return generate_latest(REGISTRY)


class UtilizationTracker:
    """Busy/idle seconds per component (parity: nidx
    utilization_tracker.rs:20-57 — two monotonically increasing counters a
    dashboard turns into a utilization ratio)."""

    _instances: dict[str, "UtilizationTracker"] = {}

    def __new__(cls, component: str):
        # one tracker per component name: service instances come and go
        # (tests, component restarts) but prometheus counters must not
        if component in cls._instances:
            return cls._instances[component]
        self = super().__new__(cls)
        cls._instances[component] = self
        return self

    def __init__(self, component: str):
        if hasattr(self, "busy"):
            return
        self.busy = Counter(
            f"ndbtpu_{component}_busy_seconds", f"{component} busy time"
        )
        self.idle = Counter(
            f"ndbtpu_{component}_idle_seconds", f"{component} idle time"
        )
        self._lock = __import__("threading").Lock()
        self._last = time.monotonic()
        self._active = 0
        self._busy_total = 0.0
        self._idle_total = 0.0

    @contextmanager
    def work(self):
        # WALL-CLOCK accounting on interval transitions: idle accrues only
        # while NO worker is active, busy accrues the union of active
        # intervals (summing each worker's own duration counted N
        # overlapping workers N times, pushing utilization past 1.0)
        start = time.monotonic()
        with self._lock:
            if self._active == 0:
                gap = max(start - self._last, 0.0)
                self.idle.inc(gap)
                self._idle_total += gap
                self._busy_start = start
            self._active += 1
        try:
            yield
        finally:
            end = time.monotonic()
            with self._lock:
                self._active -= 1
                if self._active == 0:
                    span = max(end - self._busy_start, 0.0)
                    self.busy.inc(span)
                    self._busy_total += span
                    self._last = max(self._last, end)

    def totals(self) -> tuple[float, float]:
        return self._busy_total, self._idle_total


# core metric families (parity: nidx/src/metrics.rs)
indexing_observer = Observer("ndbtpu_indexing", labels={"kind": ""})
merge_observer = Observer("ndbtpu_merge", labels={"kind": ""})
search_observer = Observer("ndbtpu_search", labels={"endpoint": ""})
sync_delay_gauge = Gauge("ndbtpu_sync_delay_seconds")
