"""Tracing: spans over the ingest and search paths with cross-process
context propagation.

The port's counterpart of ``nucliadb_tpu/telemetry/tracing.py`` (the port
imports nothing of the JAX package). It departs from that copy where the
semantic leg's hot path needs it:

- **One clock.** The built-in tracer times spans with
  ``time.perf_counter_ns()`` (``SpanRecord.start_ns``/``end_ns``), the
  monotonic clock a ``torch.profiler`` trace can be tied to; the epoch
  ``start``/``end`` the OTLP export sends are derived from it through one
  wall-minus-monotonic offset taken when the tracer is made. A record also
  carries ``child_ns``, the time its direct children on the same thread
  covered, so a layer's self time is its duration less that.
- **Explicit intervals.** ``record_span`` records a span whose start and
  end the caller took with ``stamp()``: the coalescer's queue wait and
  hand-off begin on one thread and end on another.
- **An exporter argument.** ``setup_tracing(exporter=...)`` takes any object
  with ``OTLPHttpExporter``'s interface (``on_span_end``, ``shutdown``) and
  then uses the built-in tracer whatever OpenTelemetry package is
  installed, so a caller can take every span, past the ring buffer's 2,048.
- **Collections.** While the built-in tracer is set up it records each
  garbage collection as a span ``gc.collect`` (attribute ``generation``),
  a child of the span open on the collecting thread. Those go to the
  exporter and the console only: collections come hundreds a second, and
  would push every other span out of the ring buffer.
- **The off path.** With tracing off ``span()`` returns one shared no-op
  context, and ``stamp()`` returns 0: no generator, no record, no clock
  read and no lock. A caller on the hot path takes its stamps with
  ``stamp()`` and records an interval only where its start is non-zero.

Parity: nucliadb_telemetry's OTel wrappers and nidx's #[instrument] spans +
NATS/gRPC context propagation (nidx/src/telemetry.rs:30-140,
indexer.rs:180-183). Two backends behind one API:

- **OpenTelemetry SDK** when installed and no exporter is passed (OTLP
  endpoint via ``NDBTPU_TELEMETRY__OTLP`` or console via
  ``NDBTPU_TELEMETRY__CONSOLE_TRACES``); it records no collections.
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
import gc
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

_tracer = None  # OTel tracer when _OTEL, else _MiniTracer; None while off


# ---- built-in mini tracer ---------------------------------------------------


@dataclass
class SpanRecord:
    name: str
    trace_id: str  # 32 hex chars
    span_id: str  # 16 hex chars
    parent_id: str  # 16 hex chars or ""
    start: float = 0.0  # epoch seconds
    end: float = 0.0
    attributes: dict = field(default_factory=dict)
    start_ns: int = 0  # time.perf_counter_ns()
    end_ns: int = 0
    child_ns: int = 0  # covered by direct children on the same thread
    thread: int = 0  # threading.get_ident() of the thread that recorded it

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


# the open span (a SpanRecord), or a remote parent (a _SpanContext)
_current: contextvars.ContextVar[Optional[object]] = contextvars.ContextVar(
    "ndbtpu_span", default=None
)


class _Off:
    """What ``span()`` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    """One open span of the built-in tracer."""

    __slots__ = ("tracer", "rec", "parent", "token")

    def __init__(self, tracer: "_MiniTracer", rec: SpanRecord, parent):
        self.tracer, self.rec, self.parent = tracer, rec, parent

    def __enter__(self) -> SpanRecord:
        self.token = _current.set(self.rec)
        self.rec.start_ns = time.perf_counter_ns()
        return self.rec

    def __exit__(self, *exc) -> bool:
        self.rec.end_ns = time.perf_counter_ns()
        _current.reset(self.token)
        self.tracer.finish(self.rec, self.parent)
        return False


class _MiniTracer:
    """W3C-traceparent tracer: records spans to a bounded ring buffer and,
    when an exporter is attached, ships them OTLP/HTTP (telemetry/otlp.py)."""

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
        self.epoch_ns = time.time_ns() - time.perf_counter_ns()
        # collections wait here for the next span to end: a gc callback may
        # run while this thread holds the ring's or the exporter's lock
        self._collections: deque[SpanRecord] = deque()
        self._gc_start_ns = 0

    def _id(self, nbytes: int) -> str:
        return self._rng.getrandbits(nbytes * 8).to_bytes(nbytes, "big").hex()

    def _record(self, name: str, parent, attributes: dict) -> SpanRecord:
        return SpanRecord(
            name=name,
            trace_id=parent.trace_id if parent else self._id(16),
            span_id=self._id(8),
            parent_id=parent.span_id if parent else "",
            attributes=attributes,
            thread=threading.get_ident(),
        )

    def start_span(self, name: str, parent, attributes: dict) -> _Span:
        if parent is None:
            parent = _current.get()
        return _Span(self, self._record(name, parent, attributes), parent)

    def record(self, name: str, start_ns: int, end_ns: int, attributes: dict) -> None:
        """A finished span the caller timed, a child of the open span."""
        parent = _current.get()
        rec = self._record(name, parent, attributes)
        rec.start_ns, rec.end_ns = start_ns, end_ns
        self.finish(rec, parent)

    def finish(self, rec: SpanRecord, parent) -> None:
        self._close(rec, parent)
        with self._lock:
            self.spans.append(rec)
        self._export(rec)
        self.flush_collections()

    def _close(self, rec: SpanRecord, parent) -> None:
        rec.start = (rec.start_ns + self.epoch_ns) / 1e9
        rec.end = (rec.end_ns + self.epoch_ns) / 1e9
        if isinstance(parent, SpanRecord) and parent.thread == rec.thread:
            parent.child_ns += rec.end_ns - rec.start_ns

    def _export(self, rec: SpanRecord) -> None:
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

    def on_gc(self, phase: str, info: dict) -> None:
        """``gc.callbacks`` entry: a ``gc.collect`` span a collection."""
        if phase == "start":
            self._gc_start_ns = time.perf_counter_ns()
            return
        end_ns = time.perf_counter_ns()
        parent = _current.get()
        rec = self._record("gc.collect", parent, {"generation": info["generation"]})
        rec.start_ns, rec.end_ns = self._gc_start_ns, end_ns
        self._close(rec, parent)
        self._collections.append(rec)

    def flush_collections(self) -> None:
        while self._collections:
            try:
                rec = self._collections.popleft()
            except IndexError:  # another thread took the last one
                return
            self._export(rec)


def setup_tracing(service_name: str = "nucliadb_tpu", exporter=None) -> None:
    """Turn tracing on (a tracer already set up is torn down first).
    ``exporter``: an object with ``on_span_end(rec)`` and ``shutdown()``
    that receives every span of the built-in tracer, which is then used
    whatever OpenTelemetry package is installed."""
    global _tracer
    teardown_tracing()
    console = bool(os.environ.get("NDBTPU_TELEMETRY__CONSOLE_TRACES"))
    if exporter is not None or not _OTEL:
        endpoint = os.environ.get("NDBTPU_TELEMETRY__OTLP")
        if exporter is None and endpoint:
            from .otlp import OTLPHttpExporter

            exporter = OTLPHttpExporter(endpoint, service_name)
        tracer = _MiniTracer(service_name, console=console, exporter=exporter)
        gc.callbacks.append(tracer.on_gc)
        _tracer = tracer
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
    tracer, _tracer = _tracer, None
    if not isinstance(tracer, _MiniTracer):
        return
    if tracer.on_gc in gc.callbacks:
        gc.callbacks.remove(tracer.on_gc)
    tracer.flush_collections()
    if tracer.exporter is not None:
        try:
            tracer.exporter.shutdown()
        except Exception:
            pass


def recent_spans() -> list[SpanRecord]:
    """Finished spans from the built-in tracer (newest last); empty under
    OTel (use your OTel exporter there). Collections are not kept here."""
    if isinstance(_tracer, _MiniTracer):
        with _tracer._lock:
            return list(_tracer.spans)
    return []


def stamp() -> int:
    """``time.perf_counter_ns()`` while tracing is on, else 0 (no clock
    read): the start or end of an interval for ``record_span``."""
    return 0 if _tracer is None else time.perf_counter_ns()


def span(name: str, *, context=None, **attributes):
    """Span context manager; no-op when tracing is not set up. Pass
    ``context=extract_context(headers)`` to parent the span on a remote
    trace carried in message headers (the NATS set_trace_from_nats analogue,
    nidx/src/indexer.rs:180-183)."""
    if _tracer is None:
        return _OFF
    if isinstance(_tracer, _MiniTracer):
        return _tracer.start_span(name, context, attributes)
    return _otel_span(name, context, attributes)


@contextmanager
def _otel_span(name: str, context, attributes: dict):
    with _tracer.start_as_current_span(name, context=context) as s:
        for key, value in attributes.items():
            s.set_attribute(key, value)
        yield s


def record_span(name: str, start_ns: int, end_ns: int, **attributes) -> None:
    """Record a span from ``start_ns`` to ``end_ns`` (``stamp()``s, possibly
    taken on other threads), a child of the span open on this thread;
    nothing while tracing is off."""
    tracer = _tracer
    if tracer is None:
        return
    if isinstance(tracer, _MiniTracer):
        tracer.record(name, start_ns, end_ns, attributes)
        return
    epoch_ns = time.time_ns() - time.perf_counter_ns()
    s = tracer.start_span(name, start_time=start_ns + epoch_ns, attributes=attributes)
    s.end(end_time=end_ns + epoch_ns)


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
