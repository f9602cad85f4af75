"""Tracing: spans over the ingest and search paths with cross-process
context propagation.

The port's copy of ``nucliadb_tpu/telemetry/tracing.py``, verbatim but for
the built-in tracer's OTLP/HTTP exporter (``telemetry/otlp.py`` there,
which needs the proto plane): it is not ported, and asking for it raises.

Parity: nucliadb_telemetry's OTel wrappers and nidx's #[instrument] spans +
NATS/gRPC context propagation (nidx/src/telemetry.rs:30-140,
indexer.rs:180-183). Two backends behind one API:

- **OpenTelemetry SDK** when installed (OTLP endpoint via
  ``NDBTPU_TELEMETRY__OTLP`` or console via
  ``NDBTPU_TELEMETRY__CONSOLE_TRACES``).
- **Built-in mini-tracer** otherwise (this image ships only
  opentelemetry-api): W3C ``traceparent`` inject/extract, contextvar-scoped
  parenting, a bounded ring buffer of finished spans (``recent_spans()``)
  and optional console lines — enough for debugging, tests and the audit
  trail without any dependency.

Context propagates through bus message headers (the NATS-headers analogue)
via ``inject_context`` / ``extract_context``.
"""

from __future__ import annotations

import contextvars
import os
import random
import re
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

try:  # full OTel only when the SDK is present
    from opentelemetry import trace as _otel_trace
    from opentelemetry.sdk.resources import Resource
    from opentelemetry.sdk.trace import TracerProvider
    from opentelemetry.sdk.trace.export import (
        BatchSpanProcessor,
        ConsoleSpanExporter,
    )

    _OTEL = True
except ImportError:
    _OTEL = False

_tracer = None  # OTel tracer when _OTEL, else _MiniTracer


# ---- built-in mini tracer ---------------------------------------------------


@dataclass
class SpanRecord:
    name: str
    trace_id: str  # 32 hex chars
    span_id: str  # 16 hex chars
    parent_id: str  # 16 hex chars or ""
    start: float = 0.0
    end: float = 0.0
    attributes: dict = field(default_factory=dict)

    def set_attribute(self, key, value) -> None:
        self.attributes[key] = value

    @property
    def duration_ms(self) -> float:
        return (self.end - self.start) * 1e3


@dataclass
class _SpanContext:
    trace_id: str
    span_id: str


_HEX32 = re.compile(r"[0-9a-fA-F]{32}")
_HEX16 = re.compile(r"[0-9a-fA-F]{16}")


_current: contextvars.ContextVar[Optional[_SpanContext]] = contextvars.ContextVar(
    "ndbtpu_span", default=None
)


class _MiniTracer:
    """W3C-traceparent tracer: records spans to a bounded ring buffer and,
    when an exporter is attached, ships them OTLP/HTTP (not ported)."""

    def __init__(
        self, service_name: str, console: bool = False, keep: int = 2048,
        exporter=None,
    ):
        self.service_name = service_name
        self.console = console
        self.spans: deque[SpanRecord] = deque(maxlen=keep)
        self._lock = threading.Lock()
        self._rng = random.Random()
        self.exporter = exporter

    def _id(self, nbytes: int) -> str:
        return self._rng.getrandbits(nbytes * 8).to_bytes(nbytes, "big").hex()

    @contextmanager
    def start_span(self, name: str, parent: Optional[_SpanContext], attributes: dict):
        if parent is None:
            parent = _current.get()
        trace_id = parent.trace_id if parent else self._id(16)
        rec = SpanRecord(
            name=name,
            trace_id=trace_id,
            span_id=self._id(8),
            parent_id=parent.span_id if parent else "",
            start=time.time(),
            attributes=dict(attributes),
        )
        token = _current.set(_SpanContext(trace_id=rec.trace_id, span_id=rec.span_id))
        try:
            yield rec
        finally:
            _current.reset(token)
            rec.end = time.time()
            with self._lock:
                self.spans.append(rec)
            if self.exporter is not None:
                try:
                    self.exporter.on_span_end(rec)
                except Exception:
                    pass
            if self.console:
                print(
                    f"[trace {rec.trace_id[:8]}] {self.service_name} {rec.name}"
                    f" {rec.duration_ms:.2f}ms {rec.attributes}"
                )


def setup_tracing(service_name: str = "nucliadb_tpu") -> None:
    global _tracer
    console = bool(os.environ.get("NDBTPU_TELEMETRY__CONSOLE_TRACES"))
    if not _OTEL:
        exporter = None
        endpoint = os.environ.get("NDBTPU_TELEMETRY__OTLP")
        if endpoint:
            raise NotImplementedError(
                "the built-in tracer's OTLP/HTTP exporter is not ported yet "
                "(ROADMAP.md, Queue 1 item 10b); install the OpenTelemetry SDK"
            )
        _tracer = _MiniTracer(service_name, console=console, exporter=exporter)
        return
    provider = TracerProvider(resource=Resource.create({"service.name": service_name}))
    if console:
        provider.add_span_processor(BatchSpanProcessor(ConsoleSpanExporter()))
    endpoint = os.environ.get("NDBTPU_TELEMETRY__OTLP")
    if endpoint:
        try:
            from opentelemetry.exporter.otlp.proto.grpc.trace_exporter import (
                OTLPSpanExporter,
            )

            provider.add_span_processor(
                BatchSpanProcessor(OTLPSpanExporter(endpoint=endpoint))
            )
        except ImportError:
            pass
    _otel_trace.set_tracer_provider(provider)
    _tracer = _otel_trace.get_tracer(service_name)


def teardown_tracing() -> None:
    """Reset to no-op (tests); flushes and stops any attached exporter."""
    global _tracer
    if isinstance(_tracer, _MiniTracer) and _tracer.exporter is not None:
        try:
            _tracer.exporter.shutdown()
        except Exception:
            pass
    _tracer = None


def recent_spans() -> list[SpanRecord]:
    """Finished spans from the built-in tracer (newest last); empty under
    OTel (use your OTel exporter there)."""
    if isinstance(_tracer, _MiniTracer):
        with _tracer._lock:
            return list(_tracer.spans)
    return []


@contextmanager
def span(name: str, *, context=None, **attributes):
    """Span context manager; no-op when tracing is not set up. Pass
    ``context=extract_context(headers)`` to parent the span on a remote
    trace carried in message headers (the NATS set_trace_from_nats analogue,
    nidx/src/indexer.rs:180-183)."""
    if _tracer is None:
        yield None
        return
    if isinstance(_tracer, _MiniTracer):
        with _tracer.start_span(name, context, attributes) as rec:
            yield rec
        return
    with _tracer.start_as_current_span(name, context=context) as s:
        for key, value in attributes.items():
            s.set_attribute(key, value)
        yield s


def inject_context(headers: dict) -> dict:
    """Serialize current trace context into message headers
    (the NATS-header propagation analogue)."""
    if isinstance(_tracer, _MiniTracer):
        ctx = _current.get()
        if ctx is not None:
            headers["traceparent"] = f"00-{ctx.trace_id}-{ctx.span_id}-01"
        return headers
    if _OTEL and _tracer is not None:
        from opentelemetry.propagate import inject

        inject(headers)
    return headers


def extract_context(headers: dict):
    """Parse a remote parent from message headers; None when absent."""
    raw = (headers or {}).get("traceparent", "")
    if isinstance(_tracer, _MiniTracer):
        parts = raw.split("-")
        if len(parts) == 4 and _HEX32.fullmatch(parts[1]) and _HEX16.fullmatch(parts[2]):
            # hex-validated: a malformed id would otherwise poison the OTLP
            # exporter (bytes.fromhex at flush time drops the whole batch)
            return _SpanContext(trace_id=parts[1].lower(), span_id=parts[2].lower())
        return None
    if _OTEL and _tracer is not None:
        from opentelemetry.propagate import extract

        return extract(headers or {})
    return None
