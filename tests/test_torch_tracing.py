"""The port's tracer (``telemetry/tracing.py``) and the spans of the
semantic leg, on the CPU.

The tracer: nothing recorded and no clock read while tracing is off; spans
on ``time.perf_counter_ns()`` with epoch times derived from it; the time of
each span's direct children on its own thread (``child_ns``), garbage
collections among them; intervals the caller timed (``record_span``); an
exporter passed to ``setup_tracing`` that receives every span, past the
ring buffer's 2,048. The semantic leg: ``DeviceVectorIndex.search``'s
``prepare``, ``enqueue`` and ``fetch`` on the int8 route, ``VectorSearcher``'s
``mask`` and ``hits``, and the coalescer's ``wait`` and ``handoff`` once a
coalesced query, from six threads.
"""

import contextvars
import gc
import threading
import time

import numpy as np
import pytest
import torch

from nucliadb_tpu_torch.index.vector import VectorConfig, VectorSearcher, VectorSearchRequest, batcher
from nucliadb_tpu_torch.index.vector.device import DeviceVectorIndex
from nucliadb_tpu_torch.ops import quant
from nucliadb_tpu_torch.telemetry import tracing
from nucliadb_tpu_torch.utils.buckets import bucket

ROWS, DIM = 3000, 64
DEVICE_SPANS = ["device_index.prepare", "device_index.enqueue", "device_index.fetch"]


class ListExporter:
    """Takes every finished span, as ``OTLPHttpExporter`` would."""

    def __init__(self):
        self.records = []
        self.shut = 0

    def on_span_end(self, rec):
        self.records.append(rec)

    def shutdown(self):
        self.shut += 1

    def named(self, name):
        return [r for r in self.records if r.name == name]


@pytest.fixture
def exporter():
    out = ListExporter()
    tracing.setup_tracing("test", exporter=out)
    try:
        yield out
    finally:
        tracing.teardown_tracing()


def make_index(codes: bool) -> DeviceVectorIndex:
    """A 3,000 x 64 cosine index on the CPU: with int8 codes it takes the
    int8 route, without them the host exact tier."""
    rng = np.random.default_rng(7)
    p_pad = bucket(ROWS + 1)
    arena = np.zeros((p_pad, DIM), np.float32)
    arena[:ROWS] = rng.standard_normal((ROWS, DIM), dtype=np.float32)
    arrays = {"alive": np.ones(ROWS, bool), "para_seg": np.zeros(ROWS, np.int32), "vectors": arena}
    if codes:
        enc = quant.Int8Codes.encode(torch.from_numpy(arena))
        arrays["codes"], arrays["scale"] = enc.codes.numpy(), enc.scale.numpy()
    cfg = VectorConfig(dimension=DIM, similarity="cosine", quantization="int8" if codes else "none")
    meta = {"field": "/f/f", "split": "", "position": {"start": 0, "end": 1, "page_number": 0}}
    return DeviceVectorIndex.from_reference_state(
        cfg, [f"r{i}/f/f/0-1" for i in range(ROWS)], [meta] * ROWS, {}, [frozenset()], [(0, ROWS)],
        arrays, device="cpu",
    )


@pytest.fixture(scope="module")
def searcher():
    s = VectorSearcher.__new__(VectorSearcher)
    s.index = make_index(codes=True)
    s.config = s.index.config
    return s


def queries(n, seed=3):
    return np.random.default_rng(seed).standard_normal((n, DIM), dtype=np.float32)


# ---- the tracer ----------------------------------------------------------------


def test_off_path_records_nothing_and_reads_no_clock(searcher, monkeypatch):
    tracing.teardown_tracing()
    reads = []
    clock = time.perf_counter_ns

    def counted():
        reads.append(1)
        return clock()

    monkeypatch.setattr(time, "perf_counter_ns", counted)
    assert tracing.span("a") is tracing.span("b", kbid="k") is tracing._OFF
    with tracing.span("a", kbid="k") as rec:
        assert rec is None
    assert tracing.stamp() == 0
    tracing.record_span("a", 1, 2, dispatch=1)
    # the whole semantic leg, batched and coalesced
    searcher.search(VectorSearchRequest(vectors=queries(4), top_k=5))
    batcher.QueryCoalescer().search_one(searcher, VectorSearchRequest(vectors=queries(1)[0], top_k=5))
    assert reads == [] and tracing.recent_spans() == []
    assert not [cb for cb in gc.callbacks if isinstance(getattr(cb, "__self__", None), tracing._MiniTracer)]


def test_spans_on_the_monotonic_clock(exporter):
    before = time.perf_counter_ns()
    with tracing.span("outer", kbid="k") as rec:
        time.sleep(0.002)
    after = time.perf_counter_ns()
    assert before <= rec.start_ns < rec.end_ns <= after and rec.end_ns - rec.start_ns >= 2_000_000
    epoch_ns = tracing._tracer.epoch_ns
    assert rec.start == (rec.start_ns + epoch_ns) / 1e9 and rec.end == (rec.end_ns + epoch_ns) / 1e9
    assert abs(rec.start - time.time()) < 60 and rec.duration_ms == pytest.approx((rec.end_ns - rec.start_ns) / 1e6, abs=1e-3)
    assert rec.attributes == {"kbid": "k"} and rec.thread == threading.get_ident()
    assert tracing.recent_spans()[-1] is rec and exporter.named("outer") == [rec]


def _nested():
    with tracing.span("outer") as outer:
        for _ in range(2):
            with tracing.span("inner"):
                time.sleep(0.001)
    return outer


def _collected():
    with tracing.span("outer") as outer:
        gc.collect()
    return outer


def _other_thread():
    with tracing.span("outer") as outer:
        ctx = contextvars.copy_context()  # the child is parented across threads

        def child():
            with tracing.span("inner"):
                time.sleep(0.001)

        t = threading.Thread(target=ctx.run, args=(child,))
        t.start()
        t.join(10)
        assert not t.is_alive()
    return outer


@pytest.mark.parametrize("case", [_nested, _collected, _other_thread], ids=["nested", "gc", "other_thread"])
def test_child_ns_counts_direct_children_on_the_same_thread(exporter, case):
    outer = case()
    children = [r for r in exporter.records if r.parent_id == outer.span_id]
    assert children and all(c.trace_id == outer.trace_id for c in children)
    local = [c for c in children if c.thread == outer.thread]
    assert outer.child_ns == sum(c.end_ns - c.start_ns for c in local)
    assert all(outer.start_ns <= c.start_ns <= c.end_ns <= outer.end_ns for c in local)
    if case is _collected:
        full = [c for c in children if c.name == "gc.collect" and c.attributes == {"generation": 2}]
        assert len(full) == 1 and outer.child_ns >= full[0].end_ns - full[0].start_ns > 0
        # collections reach the exporter, not the ring buffer
        assert all(r.name != "gc.collect" for r in tracing.recent_spans())
    if case is _other_thread:
        assert any(c.name == "inner" and c.thread != outer.thread for c in children)


def test_record_span_takes_the_callers_interval(exporter):
    with tracing.span("outer") as outer:
        t0 = tracing.stamp()
        t1 = tracing.stamp()
        tracing.record_span("interval", t0, t1, dispatch=3)
    (rec,) = exporter.named("interval")
    assert 0 < t0 <= t1 and (rec.start_ns, rec.end_ns) == (t0, t1)
    assert rec.parent_id == outer.span_id and rec.trace_id == outer.trace_id
    assert rec.attributes == {"dispatch": 3} and outer.child_ns >= t1 - t0


def test_exporter_takes_every_span_past_the_ring(exporter):
    n = 2048 + 100
    for i in range(n):
        with tracing.span("s", i=i):
            pass
    spans = exporter.named("s")
    assert [r.attributes["i"] for r in spans] == list(range(n))
    ring = tracing.recent_spans()
    assert len(ring) == 2048 and ring[-1] is spans[-1]
    tracer = tracing._tracer
    tracing.teardown_tracing()
    assert exporter.shut == 1 and tracer.on_gc not in gc.callbacks and tracing._tracer is None


# ---- the semantic leg ------------------------------------------------------------


def _in_order(spans, lo, hi):
    """Each span inside [lo, hi], one after the other without overlap."""
    at = lo
    for s in spans:
        assert at <= s.start_ns <= s.end_ns
        at = s.end_ns
    assert at <= hi


@pytest.mark.parametrize("b", [1, 5, 20])
def test_device_index_spans_once_a_call(exporter, searcher, b):
    t0 = time.perf_counter_ns()
    scores, ids = searcher.index.search(queries(b), 10)
    t1 = time.perf_counter_ns()
    assert ids.shape == (b, 10) and (ids >= 0).all()
    spans = [r for r in exporter.records if r.name.startswith("device_index.")]
    assert [s.name for s in spans] == DEVICE_SPANS
    _in_order(spans, t0, t1)
    assert spans[0].attributes == {"rows": b, "padded_rows": bucket(b, minimum=8)}


def test_host_exact_tier_records_no_device_spans(exporter):
    index = make_index(codes=False)
    assert index.host_resident()
    index.search(queries(3), 10)
    assert not [r for r in exporter.records if r.name.startswith("device_index.")]


def test_searcher_spans_around_the_device_index(exporter, searcher):
    t0 = time.perf_counter_ns()
    hits = searcher.search(VectorSearchRequest(vectors=queries(6), top_k=5))
    t1 = time.perf_counter_ns()
    assert len(hits) == 6 and all(len(h) == 5 for h in hits)
    spans = [r for r in exporter.records if r.name != "gc.collect"]
    assert [s.name for s in spans] == ["searcher.mask", *DEVICE_SPANS, "searcher.hits"]
    _in_order(spans, t0, t1)


def test_coalescer_spans_once_a_query_from_six_threads(exporter, searcher):
    coalescer = batcher.QueryCoalescer(concurrency=2)
    per_thread, threads_n = 12, 6
    qs = queries(per_thread * threads_n, seed=11)
    got, errors = {}, []

    def client(t):
        try:
            for j in range(per_thread):
                i = t * per_thread + j
                got[i] = coalescer.search_one(searcher, VectorSearchRequest(vectors=qs[i], top_k=5))
        except BaseException as exc:  # reported by the main thread
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(threads_n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads) and errors == []
    n = per_thread * threads_n
    assert coalescer.batched_queries == n and 0 < coalescer.dispatches <= n
    waits, handoffs = exporter.named("coalescer.wait"), exporter.named("coalescer.handoff")
    assert len(waits) == len(handoffs) == n
    # each query records its wait, then its hand-off, on its own thread
    pairs = {}
    for r in exporter.records:
        if r.name.startswith("coalescer."):
            pairs.setdefault(r.thread, []).append(r)
    for spans in pairs.values():
        for w, h in zip(spans[::2], spans[1::2]):
            assert (w.name, h.name) == ("coalescer.wait", "coalescer.handoff")
            assert w.attributes == h.attributes and w.start_ns <= w.end_ns <= h.start_ns <= h.end_ns
    # every dispatch number is a dispatch, and each dispatch's queries are its batch
    numbers = [w.attributes["dispatch"] for w in waits]
    assert set(numbers) == set(range(1, coalescer.dispatches + 1))
    assert len(exporter.named("device_index.fetch")) == coalescer.dispatches
    # the answers are the solo search's
    for i in (0, n // 2, n - 1):
        want = searcher.search(VectorSearchRequest(vectors=qs[i : i + 1], top_k=5))[0]
        assert [h.key for h in got[i]] == [h.key for h in want]
