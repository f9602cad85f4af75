"""Telemetry: metrics, structured logs, tracing hooks.

The port's copy of ``nucliadb_tpu/telemetry/__init__.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity with the reference's nucliadb_telemetry package (Prometheus metric
helpers, OTel tracing wrappers) and nidx's metrics registry
(nidx/src/metrics.rs). Prometheus metrics use the bundled
``prometheus_client``; the Observer pattern mirrors
nucliadb_telemetry/metrics.py.
"""

from .metrics import Counter, Gauge, Histogram, Observer, render_prometheus

__all__ = ["Counter", "Gauge", "Histogram", "Observer", "render_prometheus"]
