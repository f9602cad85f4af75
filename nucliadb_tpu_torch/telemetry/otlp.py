"""OTLP/HTTP trace export for the built-in mini-tracer.

The port's copy of ``nucliadb_tpu/telemetry/otlp.py``,
kept verbatim: the port imports nothing of the JAX package.

The OTel SDK is optional in this deployment; when it is absent the
mini-tracer (tracing.py) still needs a way to ship spans to a collector.
This module encodes finished ``SpanRecord``s as a protobuf
``ExportTraceServiceRequest`` (opentelemetry/proto/collector/trace/v1/
trace_service.proto) with the repo's hand-rolled wire codec
(grpc_plane/protowire.py) and POSTs it to ``{endpoint}/v1/traces`` with
``Content-Type: application/x-protobuf`` — the standard OTLP/HTTP binary
protocol any collector (otel-collector, Jaeger, Tempo, ...) accepts.

Parity: the reference exports spans via the OTel SDK's OTLP exporter
(nucliadb_telemetry; nidx/src/telemetry.rs:30-140). Schemas below mirror
opentelemetry-proto v1 field numbers exactly; tests validate byte-for-byte
against golden vectors and the google.protobuf runtime.
"""

from __future__ import annotations

import threading
import time
import urllib.request
from typing import TYPE_CHECKING, Iterable, Optional

from ..grpc_plane.protowire import encode

if TYPE_CHECKING:  # pragma: no cover
    from .tracing import SpanRecord

# opentelemetry/proto/common/v1/common.proto
ANY_VALUE = {
    "string_value": (1, "string"),
    "bool_value": (2, "bool"),
    "int_value": (3, "int64"),
    "double_value": (4, "double"),
}
KEY_VALUE = {
    "key": (1, "string"),
    "value": (2, ("msg", ANY_VALUE)),
}
INSTRUMENTATION_SCOPE = {
    "name": (1, "string"),
    "version": (2, "string"),
}

# opentelemetry/proto/resource/v1/resource.proto
RESOURCE = {
    "attributes": (1, ("rep", ("msg", KEY_VALUE))),
}

# opentelemetry/proto/trace/v1/trace.proto
STATUS = {
    "message": (2, "string"),
    "code": (3, "enum"),  # 0 unset, 1 ok, 2 error
}
SPAN = {
    "trace_id": (1, "bytes"),
    "span_id": (2, "bytes"),
    "trace_state": (3, "string"),
    "parent_span_id": (4, "bytes"),
    "name": (5, "string"),
    "kind": (6, "enum"),  # 1 = SPAN_KIND_INTERNAL
    "start_time_unix_nano": (7, "fixed64"),
    "end_time_unix_nano": (8, "fixed64"),
    "attributes": (9, ("rep", ("msg", KEY_VALUE))),
    "status": (15, ("msg", STATUS)),
}
SCOPE_SPANS = {
    "scope": (1, ("msg", INSTRUMENTATION_SCOPE)),
    "spans": (2, ("rep", ("msg", SPAN))),
}
RESOURCE_SPANS = {
    "resource": (1, ("msg", RESOURCE)),
    "scope_spans": (2, ("rep", ("msg", SCOPE_SPANS))),
}

# opentelemetry/proto/collector/trace/v1/trace_service.proto
EXPORT_TRACE_SERVICE_REQUEST = {
    "resource_spans": (1, ("rep", ("msg", RESOURCE_SPANS))),
}

SPAN_KIND_INTERNAL = 1


def _any_value(value) -> dict:
    if isinstance(value, bool):
        return {"bool_value": value}
    if isinstance(value, int):
        return {"int_value": value}
    if isinstance(value, float):
        return {"double_value": value}
    return {"string_value": str(value)}


def span_to_proto(rec: "SpanRecord") -> dict:
    out = {
        "trace_id": bytes.fromhex(rec.trace_id),
        "span_id": bytes.fromhex(rec.span_id),
        "name": rec.name,
        "kind": SPAN_KIND_INTERNAL,
        "start_time_unix_nano": int(rec.start * 1e9),
        "end_time_unix_nano": int(rec.end * 1e9),
        "attributes": [
            {"key": k, "value": _any_value(v)} for k, v in rec.attributes.items()
        ],
    }
    # protowire presence is dict-key presence: leave absent fields OUT so
    # the canonical (implicit-presence) OTLP bytes stay minimal
    if rec.parent_id:
        out["parent_span_id"] = bytes.fromhex(rec.parent_id)
    return out


def _maybe_span_proto(rec: "SpanRecord") -> Optional[dict]:
    try:
        return span_to_proto(rec)
    except (ValueError, TypeError):
        return None


def encode_export_request(
    service_name: str, spans: Iterable["SpanRecord"]
) -> bytes:
    """One ExportTraceServiceRequest for a batch of finished spans."""
    msg = {
        "resource_spans": [
            {
                "resource": {
                    "attributes": [
                        {
                            "key": "service.name",
                            "value": {"string_value": service_name},
                        }
                    ]
                },
                "scope_spans": [
                    {
                        "scope": {"name": "nucliadb_tpu.telemetry"},
                        # one malformed span (bad hex id from a hostile
                        # traceparent) must not drop the whole batch
                        "spans": [p for p in map(_maybe_span_proto, spans) if p],
                    }
                ],
            }
        ]
    }
    return encode(EXPORT_TRACE_SERVICE_REQUEST, msg)


class OTLPHttpExporter:
    """Batching OTLP/HTTP exporter: spans queue as they finish and flush on
    a background timer or when the batch fills (the BatchSpanProcessor
    role). Failures drop the batch after ``max_retries`` — telemetry must
    never back-pressure the serving path."""

    def __init__(
        self,
        endpoint: str,
        service_name: str = "nucliadb_tpu",
        *,
        flush_interval_s: float = 5.0,
        max_batch: int = 256,
        timeout_s: float = 10.0,
        max_retries: int = 2,
    ):
        self.endpoint = endpoint.rstrip("/")
        self.service_name = service_name
        self.max_batch = max_batch
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self._pending: list["SpanRecord"] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._kick = threading.Event()  # batch-full signal to the flusher
        self._thread = threading.Thread(
            target=self._loop, args=(flush_interval_s,), daemon=True
        )
        self._thread.start()

    def on_span_end(self, rec: "SpanRecord") -> None:
        with self._lock:
            self._pending.append(rec)
            full = len(self._pending) >= self.max_batch
        if full:
            # wake the background flusher — flushing INLINE here would block
            # the serving thread for up to retries x timeout when the
            # collector is down (the 'never back-pressure serving' contract)
            self._kick.set()

    def _loop(self, interval: float) -> None:
        while True:
            self._kick.wait(interval)
            self._kick.clear()
            if self._stop.is_set():
                return
            try:
                self.flush()
            except Exception:
                pass

    def flush(self) -> None:
        with self._lock:
            batch, self._pending = self._pending, []
        if not batch:
            return
        body = encode_export_request(self.service_name, batch)
        req = urllib.request.Request(
            f"{self.endpoint}/v1/traces",
            data=body,
            headers={"Content-Type": "application/x-protobuf"},
            method="POST",
        )
        for attempt in range(self.max_retries + 1):
            try:
                with urllib.request.urlopen(req, timeout=self.timeout_s):
                    return
            except Exception:
                if attempt == self.max_retries:
                    return  # drop the batch; never block serving
                time.sleep(0.2 * (attempt + 1))

    def shutdown(self) -> None:
        self._stop.set()
        self._kick.set()  # wake the flusher so it observes stop promptly
        self.flush()
