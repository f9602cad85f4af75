"""The traced run's reading of a profile, on a synthetic Chrome trace: the
clock mark, a layer's device work read from the operations that run while
its calls are open (calls one at a time, calls that overlap, and a call
cut by the take's start), the busy time and the idle gaps named by what
the host was doing."""

import pytest

from benchmark import tracing

MARK_NS = 1_000_000_000  # the host's perf_counter_ns at the mark
MARK_US = 5_000_000.0  # the same moment on the profiler's clock


def _span(name, lo, hi, rows=0):
    """A span whose ends are given in microseconds past the mark on the
    profiler's clock."""
    return tracing.Span(name, int(MARK_NS + lo * 1e3), int(MARK_NS + hi * 1e3), 0, rows)


def _trace():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.mark", "ts": MARK_US, "dur": 1.0, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "bench.take", "ts": MARK_US + 100, "dur": 1000.0, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": MARK_US + 210, "dur": 2.0, "tid": 9},
    ]
    for name, start, dur in [
        ("fill", 180, 1.0),  # in the cut call, before the stretch: not read
        ("slot_scan_wgmma<2>", 215, 50.0),
        ("fill", 230, 1.0),  # two calls open: read once
        ("gather", 265, 10.0),
        ("host copy", 500, 5.0),  # no call open: not read
        ("slot_scan_wgmma<2>", 615, 40.0),
        ("slot_scan_wgmma<2>", 700, 30.0),
        ("after the take", 1300, 5.0),
    ]:
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": MARK_US + start, "dur": dur, "tid": 7})
    spans = [
        _span("device_index.search", 200, 300, rows=2048),
        _span("device_index.search", 600, 700, rows=1024),
        _span("device_index.search", 680, 800, rows=8),  # overlaps the last
        _span("device_index.search", 50, 250, rows=16),  # cut by the take's start
        _span("searcher.search", 150, 900),
        _span("coalescer.search_one", 100, 1100),
    ]
    return tracing.parse(events, MARK_NS), spans


def test_device_work_of_a_layers_calls():
    take, spans = _trace()
    assert take.start_us == MARK_US + 100 and take.window_s == pytest.approx(1e-3)
    calls = tracing.calls_in(take, [s for s in spans if s.name == "device_index.search"])
    # the stretch runs 200-800: three calls inside, a quarter of the cut one
    assert sorted(calls.shares) == [(0.25, 16), (1.0, 8), (1.0, 1024), (1.0, 2048)]
    assert calls.count == pytest.approx(3.25)
    assert sorted(calls.ops) == [
        ("fill", 1.0), ("gather", 10.0),
        ("slot_scan_wgmma<2>", 30.0), ("slot_scan_wgmma<2>", 40.0), ("slot_scan_wgmma<2>", 50.0),
    ]


def test_no_call_inside_the_take_reads_nothing():
    take, spans = _trace()
    assert tracing.calls_in(take, [_span("device_index.search", 50, 1200, rows=4)]) is None


def test_busy_time_and_idle_gaps():
    take, spans = _trace()
    # busy inside the take (100-1100 past the mark): 180-181, 215-275, 500-505, 615-655, 700-730
    assert tracing.busy_s(take) == pytest.approx(136e-6)
    gaps = tracing.idle_gaps(take, spans)
    assert sum(gaps.values()) == pytest.approx(864e-6)
    # middles 140, 198 and 677.5 fall in a device index call; 387.5 and 560
    # in the searcher's only; 915 in the coalescer's only
    assert gaps == pytest.approx(
        {"device_index.search": 159e-6, "searcher.search": 335e-6, "coalescer.search_one": 370e-6}
    )
    assert tracing.top_device_ops(take)[0] == ["slot_scan_wgmma<2>", pytest.approx(120e-6)]


def test_a_profile_without_its_marks_fails():
    with pytest.raises(RuntimeError, match="bench.mark"):
        tracing.parse([{"ph": "X", "cat": "kernel", "name": "k", "ts": 1.0, "dur": 1.0}], 0)
