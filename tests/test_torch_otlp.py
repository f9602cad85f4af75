"""The scenarios of ``tests/test_otlp.py`` on the port: the port's copies of
``telemetry/otlp.py`` and ``telemetry/tracing.py``.

The reference file's own docstring:

OTLP/HTTP trace export: golden bytes + google.protobuf differential +
HTTP sink end-to-end.

Parity target: the reference ships spans through the OTel SDK's OTLP
exporter (nucliadb_telemetry, nidx/src/telemetry.rs:30-140). The repo's
mini-tracer exports the same OTLP/HTTP binary protocol without the SDK
(telemetry/otlp.py); these tests pin the wire format against hand-computed
golden vectors and the real protobuf runtime, then drive the full path
through a live HTTP collector sink.
"""

import http.server
import threading
import time

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

from nucliadb_tpu_torch.telemetry import otlp
from nucliadb_tpu_torch.telemetry.tracing import SpanRecord

T = descriptor_pb2.FieldDescriptorProto


def make_record(**kw):
    defaults = dict(
        name="find",
        trace_id="0af7651916cd43dd8448eb211c80319c",
        span_id="b7ad6b7169203331",
        parent_id="",
        start=1.0,
        end=2.5,
        attributes={},
    )
    defaults.update(kw)
    return SpanRecord(**defaults)


def test_golden_minimal_span():
    """Byte-for-byte golden for a minimal span (field numbers and wire
    types per opentelemetry-proto v1 trace.proto)."""
    rec = make_record()
    body = otlp.encode(otlp.SPAN, otlp.span_to_proto(rec))
    expected = (
        # 1: trace_id, LEN 16
        bytes([0x0A, 0x10]) + bytes.fromhex(rec.trace_id)
        # 2: span_id, LEN 8
        + bytes([0x12, 0x08]) + bytes.fromhex(rec.span_id)
        # 5: name "find"
        + bytes([0x2A, 0x04]) + b"find"
        # 6: kind = 1 (INTERNAL)
        + bytes([0x30, 0x01])
        # 7: start fixed64 1e9 ns
        + bytes([0x39]) + (10**9).to_bytes(8, "little")
        # 8: end fixed64 2.5e9 ns
        + bytes([0x41]) + (25 * 10**8).to_bytes(8, "little")
    )
    assert body == expected


def test_golden_attributes_and_parent():
    rec = make_record(parent_id="00f067aa0ba902b7", attributes={"top_k": 5})
    body = otlp.encode(otlp.SPAN, otlp.span_to_proto(rec))
    # 4: parent_span_id
    assert bytes([0x22, 0x08]) + bytes.fromhex("00f067aa0ba902b7") in body
    # 9: attributes -> KeyValue{key="top_k", value=AnyValue{int_value=5}}
    kv = bytes([0x0A, 0x05]) + b"top_k" + bytes([0x12, 0x02, 0x18, 0x05])
    assert bytes([0x4A, len(kv)]) + kv in body


def _build_otlp_descriptors():
    """Dynamic descriptors mirroring opentelemetry-proto v1 field numbers —
    an independent decoder for the differential check."""
    fdp = descriptor_pb2.FileDescriptorProto()
    fdp.name = "otlp_test.proto"
    fdp.package = "ot"
    fdp.syntax = "proto3"

    def msg(name):
        m = fdp.message_type.add()
        m.name = name
        return m

    def field(m, name, num, kind=None, *, repeated=False, type_name=None):
        f = m.field.add()
        f.name = name
        f.number = num
        f.label = T.LABEL_REPEATED if repeated else T.LABEL_OPTIONAL
        if type_name:
            f.type = T.TYPE_MESSAGE
            f.type_name = f".ot.{type_name}"
        else:
            f.type = kind

    m = msg("AnyValue")
    field(m, "string_value", 1, T.TYPE_STRING)
    field(m, "bool_value", 2, T.TYPE_BOOL)
    field(m, "int_value", 3, T.TYPE_INT64)
    field(m, "double_value", 4, T.TYPE_DOUBLE)
    m = msg("KeyValue")
    field(m, "key", 1, T.TYPE_STRING)
    field(m, "value", 2, type_name="AnyValue")
    m = msg("InstrumentationScope")
    field(m, "name", 1, T.TYPE_STRING)
    field(m, "version", 2, T.TYPE_STRING)
    m = msg("Resource")
    field(m, "attributes", 1, type_name="KeyValue", repeated=True)
    m = msg("Status")
    field(m, "message", 2, T.TYPE_STRING)
    field(m, "code", 3, T.TYPE_INT32)
    m = msg("Span")
    field(m, "trace_id", 1, T.TYPE_BYTES)
    field(m, "span_id", 2, T.TYPE_BYTES)
    field(m, "trace_state", 3, T.TYPE_STRING)
    field(m, "parent_span_id", 4, T.TYPE_BYTES)
    field(m, "name", 5, T.TYPE_STRING)
    field(m, "kind", 6, T.TYPE_INT32)
    field(m, "start_time_unix_nano", 7, T.TYPE_FIXED64)
    field(m, "end_time_unix_nano", 8, T.TYPE_FIXED64)
    field(m, "attributes", 9, type_name="KeyValue", repeated=True)
    field(m, "status", 15, type_name="Status")
    m = msg("ScopeSpans")
    field(m, "scope", 1, type_name="InstrumentationScope")
    field(m, "spans", 2, type_name="Span", repeated=True)
    m = msg("ResourceSpans")
    field(m, "resource", 1, type_name="Resource")
    field(m, "scope_spans", 2, type_name="ScopeSpans", repeated=True)
    m = msg("ExportTraceServiceRequest")
    field(m, "resource_spans", 1, type_name="ResourceSpans", repeated=True)

    pool = descriptor_pool.DescriptorPool()
    pool.Add(fdp)
    return message_factory.GetMessageClass(
        pool.FindMessageTypeByName("ot.ExportTraceServiceRequest")
    )


def test_differential_vs_protobuf_runtime():
    """The real protobuf runtime parses our bytes into the same values."""
    Req = _build_otlp_descriptors()
    recs = [
        make_record(attributes={"kbid": "kb1", "ok": True, "score": 0.25, "n": 7}),
        make_record(
            name="child",
            span_id="00f067aa0ba902b7",
            parent_id="b7ad6b7169203331",
            start=1.5,
            end=1.75,
        ),
    ]
    body = otlp.encode_export_request("svc-x", recs)
    parsed = Req.FromString(body)
    assert len(parsed.resource_spans) == 1
    rs = parsed.resource_spans[0]
    assert rs.resource.attributes[0].key == "service.name"
    assert rs.resource.attributes[0].value.string_value == "svc-x"
    spans = rs.scope_spans[0].spans
    assert [s.name for s in spans] == ["find", "child"]
    assert spans[0].trace_id.hex() == recs[0].trace_id
    assert spans[1].parent_span_id.hex() == "b7ad6b7169203331"
    assert spans[0].start_time_unix_nano == 10**9
    assert spans[1].end_time_unix_nano == int(1.75e9)
    attrs = {a.key: a.value for a in spans[0].attributes}
    assert attrs["kbid"].string_value == "kb1"
    assert attrs["ok"].bool_value is True
    assert attrs["score"].double_value == 0.25
    assert attrs["n"].int_value == 7


class _Sink(http.server.BaseHTTPRequestHandler):
    received: list = []

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        _Sink.received.append(
            (self.path, self.headers.get("Content-Type"), self.rfile.read(n))
        )
        self.send_response(200)
        self.end_headers()

    def log_message(self, *a):
        pass


def test_end_to_end_http_sink(monkeypatch):
    """span() -> mini-tracer -> OTLP exporter -> live HTTP collector: the
    sink receives protobuf the runtime parses, with parenting intact."""
    from nucliadb_tpu_torch.telemetry import tracing

    _Sink.received = []
    httpd = http.server.HTTPServer(("127.0.0.1", 0), _Sink)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        monkeypatch.setenv(
            "NDBTPU_TELEMETRY__OTLP", f"http://127.0.0.1:{httpd.server_port}"
        )
        tracing.setup_tracing("e2e-svc")
        try:
            with tracing.span("parent", kbid="kb1") as parent:
                with tracing.span("child"):
                    pass
        finally:
            tracing.teardown_tracing()  # flushes the exporter

        deadline = time.time() + 5
        while not _Sink.received and time.time() < deadline:
            time.sleep(0.05)
        assert _Sink.received, "collector sink never received an export"
        path, ctype, body = _Sink.received[0]
        assert path == "/v1/traces"
        assert ctype == "application/x-protobuf"
        Req = _build_otlp_descriptors()
        parsed = Req.FromString(body)
        spans = {
            s.name: s for s in parsed.resource_spans[0].scope_spans[0].spans
        }
        assert set(spans) == {"parent", "child"}
        assert spans["child"].parent_span_id == spans["parent"].span_id
        assert spans["child"].trace_id == spans["parent"].trace_id
        assert spans["parent"].end_time_unix_nano >= spans["parent"].start_time_unix_nano
        attrs = {a.key: a.value for a in spans["parent"].attributes}
        assert attrs["kbid"].string_value == "kb1"
    finally:
        httpd.shutdown()


def test_extract_context_rejects_non_hex():
    """Regression: traceparent ids were length-validated only; a non-hex id
    poisoned the OTLP exporter at flush time (whole batch dropped)."""
    from nucliadb_tpu_torch.telemetry import tracing

    tracing.setup_tracing("hex-test")
    try:
        bad = {"traceparent": "00-" + "g" * 32 + "-" + "h" * 16 + "-01"}
        assert tracing.extract_context(bad) is None
        good = {"traceparent": "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"}
        ctx = tracing.extract_context(good)
        assert ctx is not None and ctx.trace_id == "ab" * 16
    finally:
        tracing.teardown_tracing()


def test_bad_span_does_not_drop_batch():
    """One malformed span (non-hex ids) must not discard sibling spans."""
    from nucliadb_tpu_torch.telemetry.otlp import encode_export_request
    from nucliadb_tpu_torch.telemetry.tracing import SpanRecord

    good = SpanRecord(
        name="ok", trace_id="ab" * 16, span_id="cd" * 8, parent_id="",
        start=1.0, end=2.0, attributes={},
    )
    bad = SpanRecord(
        name="poison", trace_id="g" * 32, span_id="h" * 16, parent_id="",
        start=1.0, end=2.0, attributes={},
    )
    payload = encode_export_request("t", [good, bad])
    assert b"ok" in payload and b"poison" not in payload
