"""The program's own spans beside the benchmark's: a traced CPU run with
the port's tracer set up with an exporter that appends each finished span
to the run's span list, as a ``benchmark.tracing.Span`` with its
``child_ns``. Every existing reader reads the same number with and
without the program's spans in ``run.spans``."""

import pytest

from benchmark import harness
from benchmark import tracing as btracing
from benchmark.systems import vector

PROGRAM = {"coalescer.wait", "coalescer.handoff", "searcher.mask", "searcher.hits",
           "device_index.prepare", "device_index.enqueue", "device_index.fetch"}


class ToSpans:
    def __init__(self, records):
        self.records = records

    def on_span_end(self, rec):
        self.records.append(btracing.Span(rec.name, rec.start_ns, rec.end_ns, rec.child_ns,
                                          int(rec.attributes.get("rows", 0))))

    def shutdown(self):
        pass


@pytest.mark.parametrize("mix", ["batch2048", "clients32"])
def test_program_spans_leave_every_reader_as_it_was(tiny, monkeypatch, mix):
    from nucliadb_tpu_torch.telemetry import tracing

    instrument = vector.VectorSystem.instrument

    def with_program_spans(self, spans):
        instrument(self, spans)
        tracing.setup_tracing("benchmark", exporter=ToSpans(spans.records))

    monkeypatch.setattr(vector.VectorSystem, "instrument", with_program_spans)
    try:
        run, line = tiny(mix, trace=True, seconds=1.0)
    finally:
        tracing.teardown_tracing()
    assert line["correct"] is True
    names = {s.name for s in run.spans}
    want = PROGRAM if mix == "clients32" else PROGRAM - {"coalescer.wait", "coalescer.handoff"}
    assert want <= names
    every = run.spans
    outside = [s for s in every if s.name not in PROGRAM | {"gc.collect"}]
    assert len(outside) < len(every)
    for entry in harness.metrics_for(harness.load_spec(), run.cell, "per_layer"):
        reader = harness.load_reader(entry["name"])
        run.spans = every
        with_program = reader.read(run)
        run.spans = outside
        assert reader.read(run) == with_program, entry["name"]
