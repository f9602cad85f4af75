"""The replayed resident int8 route (``index/vector/graphs.py``) on the CPU.

A CUDA graph is captured and replayed only on a card, so here the capture
and the replay are stubs: the stub capture runs the route once and keeps
it, the stub replay runs it again into the kept outputs, reading the same
static buffers a graph would. Dropped graphs are released before the next
capture, so a test that counts them releases them first
(``graphs.settle``). What is checked: the
cache's keys (bucket, top_k, dedup, floor present, filtered), one key for
every floor, the gate (large batches and rerank budgets past the slot table
run eagerly), distinct replays for concurrent callers of one key and no
replay in two calls at once, a replay checked in only after its fetch, the
cap a key holds, the memory share, the eviction of old keys, a failed
capture, the streams of dropped graphs, the counters and the span
attribute, answers equal to the eager route's, and that CPU tensors never
capture.
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from nucliadb_tpu_torch.index.vector import VectorConfig, device, graphs
from nucliadb_tpu_torch.index.vector.device import DeviceVectorIndex
from nucliadb_tpu_torch.ops import quant
from nucliadb_tpu_torch.telemetry import tracing
from nucliadb_tpu_torch.utils import counts
from nucliadb_tpu_torch.utils.buckets import bucket
from nucliadb_tpu_torch.utils.counts import LaunchCounter

ROWS, DIM = 3000, 128


def make_index() -> DeviceVectorIndex:
    """A 3,000 x 128 cosine index with int8 codes on the CPU (p_pad 4,096:
    the top-2 slot scan's plain version)."""
    rng = np.random.default_rng(11)
    p_pad = bucket(ROWS + 1)
    arena = np.zeros((p_pad, DIM), np.float32)
    rows = rng.standard_normal((ROWS, DIM), dtype=np.float32)
    arena[:ROWS] = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    arena[7] = arena[3]  # a duplicate for the dedup
    alive = np.ones(ROWS, bool)
    alive[::50] = False
    enc = quant.Int8Codes.encode(torch.from_numpy(arena))
    arrays = {"alive": alive, "para_seg": np.zeros(ROWS, np.int32), "vectors": arena,
              "codes": enc.codes.numpy(), "scale": enc.scale.numpy()}
    cfg = VectorConfig(dimension=DIM, similarity="cosine", quantization="int8")
    meta = {"field": "/f/f", "split": "", "position": {"start": 0, "end": 1, "page_number": 0}}
    return DeviceVectorIndex.from_reference_state(
        cfg, [f"r{i}/f/f/0-1" for i in range(ROWS)], [meta] * ROWS, {}, [frozenset()], [(0, ROWS)],
        arrays, device="cpu",
    )


@pytest.fixture(scope="module")
def pair():
    """The same index twice: one replays (under ``stubbed``), one runs eagerly."""
    graphed, eager = make_index(), make_index()
    eager.eager_only = True
    return graphed, eager


@pytest.fixture
def stubbed(monkeypatch):
    """Stub capture and replay, the route replayed on the CPU, and the calls
    each stub saw."""
    seen = SimpleNamespace(captures=[], replays=[])

    def capture(r):
        assert threading.current_thread().name == "graph-capture"
        seen.captures.append(r.run)
        r.graph, r.out, r.adds = SimpleNamespace(run=r.run), tuple(t.clone() for t in r.run()), []

    def replay(r):
        seen.replays.append(r)
        for kept, new in zip(r.out, r.graph.run()):
            kept.copy_(new)
        # on a card the fetch copies the outputs to the host; on the CPU it
        # hands out views, which the replay's next call would overwrite
        return tuple(t.clone() for t in r.out)

    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(graphs, "replay", replay)
    monkeypatch.setattr(DeviceVectorIndex, "_graphed", lambda self: not getattr(self, "eager_only", False))
    graphs.settle()
    graphs.GRAPHS.clear()
    yield seen
    graphs.settle()


def _same(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def _near_queries(index, n, seed):
    rng = np.random.default_rng(seed)
    rows = index.vectors[torch.from_numpy(rng.integers(0, ROWS, n))].numpy()
    return rows + 0.2 * rng.standard_normal((n, DIM), dtype=np.float32) / np.sqrt(DIM)


CALLS = [
    (dict(), 1), (dict(), 7), (dict(), 8), (dict(), 9), (dict(), 33),
    (dict(with_duplicates=False), 5), (dict(min_score=0.9), 5),
    (dict(filtered=True), 5), (dict(filtered=True, min_score=0.8, with_duplicates=False), 12),
]


@pytest.mark.parametrize("top_k", [10, 100])
def test_keys_and_answers_equal_the_eager_route(pair, stubbed, top_k):
    """Each call's key is (b_pad, top_k, dedup, floor present, filtered); a
    first call captures, a second replays with other queries, and both
    answer as the eager route does."""
    graphed, eager = pair
    graphed._init_graphs()
    mask = np.arange(ROWS) % 3 != 0
    want_keys = set()
    for n, (kw, b) in enumerate(CALLS):
        kw = dict(kw)
        filtered = kw.pop("filtered", False)
        if filtered:
            kw["para_mask"] = mask
        key = graphs.key_of(bucket(b, minimum=8), top_k, "with_duplicates" in kw, "min_score" in kw, filtered)
        want_keys.add(key)
        for seed in (n, n + 100):
            q = _near_queries(graphed, b, seed)
            _same(graphed.search(q, top_k, **kw), eager.search(q, top_k, **kw))
    assert set(graphed._graphs.sizes()) == want_keys
    assert all(held == 1 for held in graphed._graphs.sizes().values())
    assert len(stubbed.captures) == len(want_keys)
    assert graphs.GRAPHS["capture"] == len(want_keys)
    assert graphs.GRAPHS["eager"] == len(want_keys)
    assert graphs.GRAPHS["replay"] == 2 * len(CALLS) - len(want_keys)


def test_two_floors_share_one_key(pair, stubbed):
    """The floor is an input the graph reads, not a part of the key."""
    graphed, eager = pair
    graphed._init_graphs()
    q = _near_queries(graphed, 4, 5)
    for floor in (0.95, 0.5, 0.99, -1.0):
        got = graphed.search(q, 10, min_score=floor)
        _same(got, eager.search(q, 10, min_score=floor))
    assert graphed._graphs.sizes() == {graphs.key_of(8, 10, False, True, False): 1}
    assert len(stubbed.captures) == 1 and len(stubbed.replays) == 3
    cut = graphed.search(q, 10, min_score=0.99)[1]
    assert (cut == -1).any() and (graphed.search(q, 10, min_score=-1.0)[1] >= 0).all()


def test_concurrent_callers_of_one_key_get_distinct_replays(pair, stubbed, monkeypatch):
    """Four threads in one key at once hold four replays; each replay is
    checked in only after its fetch."""
    graphed, eager = pair
    graphed._init_graphs()
    barrier = threading.Barrier(4, timeout=30)
    local = threading.local()
    enqueue, fetch = graphs.enqueue, device.device_fetch
    free_at_fetch = []

    def held_enqueue(r, run):
        if r is not None and r.graph is None:
            barrier.wait()  # all four are between checkout and check-in
        local.replay = r
        return enqueue(r, run)

    def checked_fetch(*tensors):
        r = local.__dict__.pop("replay", None)  # None: the eager index's fetch
        if r is not None:
            free_at_fetch.append(any(r is f for f in graphed._graphs._free[r.key]))
        return fetch(*tensors)

    monkeypatch.setattr(graphs, "enqueue", held_enqueue)
    monkeypatch.setattr(device, "device_fetch", checked_fetch)
    qs = [_near_queries(graphed, 3, 40 + t) for t in range(4)]
    out, errors = [None] * 4, []

    def run(t):
        try:
            out[t] = graphed.search(qs[t], 10)
        except BaseException as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert not errors, errors
    key = graphs.key_of(8, 10, False, False, False)
    assert graphed._graphs.sizes() == {key: 4}
    assert len({id(r) for r in graphed._graphs._free[key]}) == 4
    assert free_at_fetch == [False] * 4
    for t in range(4):
        _same(out[t], eager.search(qs[t], 10))
    # the next four calls replay, one at a time, each its fetch before check-in
    for t in range(4):
        _same(graphed.search(qs[t], 10), eager.search(qs[t], 10))
    assert graphs.GRAPHS["replay"] == 4 and free_at_fetch[4:] == [False] * 4


def test_no_replay_serves_two_calls_at_once(pair, stubbed, monkeypatch):
    """Six threads send 25 calls each to two keys: a replay is never replayed
    while another call holds it, and every answer is the eager route's."""
    graphed, eager = pair
    graphed._init_graphs()
    lock, in_use, clashes = threading.Lock(), set(), []
    replay, checkin = graphs.replay, graphs.GraphCache.checkin

    def exclusive_replay(r):
        with lock:
            if id(r) in in_use:
                clashes.append(r.key)
            in_use.add(id(r))
        return replay(r)

    def releasing_checkin(self, r, key=None, ok=True):
        with lock:
            in_use.discard(id(r))
        return checkin(self, r, key, ok)

    monkeypatch.setattr(graphs, "replay", exclusive_replay)
    monkeypatch.setattr(graphs.GraphCache, "checkin", releasing_checkin)
    calls = [(_near_queries(graphed, 2 + (j % 2) * 10, 700 + j), 10) for j in range(150)]
    want = [eager.search(q, k) for q, k in calls]
    got, errors = [None] * len(calls), []

    def run(t):
        try:
            for j in range(t, len(calls), 6):
                got[j] = graphed.search(*calls[j])
        except BaseException as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(t,)) for t in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    assert not errors and not clashes, (errors, clashes)
    for g, w in zip(got, want):
        _same(g, w)
    sizes = graphed._graphs.sizes()
    assert set(sizes) == {graphs.key_of(8, 10, False, False, False), graphs.key_of(12, 10, False, False, False)}
    assert all(1 <= n <= graphs.PER_KEY for n in sizes.values())
    assert graphs.GRAPHS["replay"] + graphs.GRAPHS["eager"] == len(calls)


def test_large_batches_and_budgets_run_eagerly(pair, stubbed):
    """Past ``MAX_ROWS`` padded rows, or with a rerank budget past the top-2
    slot table, the route runs eagerly: no replay is made and the call
    counts as ``eager``."""
    graphed, eager = pair
    graphed._init_graphs()
    assert graphed._replays(64, 128) and not graphed._replays(96, 10) and not graphed._replays(8, 129)
    for b, top_k in ((65, 10), (100, 10), (3, 129), (3, 200)):
        for seed in (1, 2):
            q = _near_queries(graphed, b, 800 + b + seed)
            _same(graphed.search(q, top_k), eager.search(q, top_k))
    assert graphed._graphs.sizes() == {} and not stubbed.captures
    assert graphs.GRAPHS == {"eager": 8}


def test_a_key_holds_at_most_per_key_replays(pair, stubbed, monkeypatch):
    """Past ``PER_KEY`` replays out at once, a call runs eagerly."""
    graphed, eager = pair
    graphed._init_graphs()
    monkeypatch.setattr(graphs, "PER_KEY", 1)
    key = graphs.key_of(8, 10, False, False, False)
    held = graphed._graphs.checkout(key, lambda: graphs.new_replay(key, DIM, graphed.base_mask_device()))
    q = _near_queries(graphed, 2, 9)
    _same(graphed.search(q, 10), eager.search(q, 10))
    assert graphs.GRAPHS == {"eager": 1} and not stubbed.captures
    graphed._graphs.checkin(held)  # never ran: dropped
    assert graphed._graphs.sizes() == {key: 0}
    _same(graphed.search(q, 10), eager.search(q, 10))
    assert graphs.GRAPHS["capture"] == 1 and graphed._graphs.sizes() == {key: 1}


def test_past_the_memory_share_calls_run_eagerly(pair, stubbed, monkeypatch):
    """Once the card's graphs hold their memory share, a new replay is
    neither made nor captured; the key is not refused, and captures again
    once there is room."""
    graphed, eager = pair
    graphed._init_graphs()
    key = graphs.key_of(8, 10, False, False, False)
    monkeypatch.setattr(graphs, "full", lambda device: True)
    q = _near_queries(graphed, 2, 19)
    _same(graphed.search(q, 10), eager.search(q, 10))
    assert graphed._graphs.sizes() == {key: 0} and graphs.GRAPHS == {"eager": 1}
    # full only by the time the capture thread comes to it: made, then dropped
    monkeypatch.setattr(graphs, "full", lambda device: threading.current_thread().name == "graph-capture")
    _same(graphed.search(q, 10), eager.search(q, 10))
    assert graphed._graphs.sizes() == {key: 0} and not stubbed.captures
    monkeypatch.setattr(graphs, "full", lambda device: False)
    _same(graphed.search(q, 10), eager.search(q, 10))
    _same(graphed.search(q, 10), eager.search(q, 10))
    assert graphed._graphs.sizes() == {key: 1} and graphs.GRAPHS == {"eager": 3, "capture": 1, "replay": 1}


def test_old_keys_are_evicted(pair, stubbed, monkeypatch):
    """A new key past ``KEYS`` drops the least recently used key."""
    graphed, _ = pair
    graphed._init_graphs()
    monkeypatch.setattr(graphs, "KEYS", 2)
    q = _near_queries(graphed, 2, 10)
    for top_k in (5, 6, 5, 7):
        graphed.search(q, top_k)
    assert set(graphed._graphs.sizes()) == {graphs.key_of(8, k, False, False, False) for k in (5, 7)}


def test_a_failed_capture_runs_its_key_eagerly(pair, stubbed, monkeypatch):
    """The call before a failed capture answers from its eager run; the key
    runs eagerly from then on and captures no more."""
    graphed, eager = pair
    graphed._init_graphs()
    tries = []

    def failing(r):
        tries.append(r.run)
        raise RuntimeError("capture refused")

    monkeypatch.setattr(graphs, "capture", failing)
    q = _near_queries(graphed, 3, 12)
    for _ in range(3):
        _same(graphed.search(q, 10), eager.search(q, 10))
    assert len(tries) == 1 and graphs.GRAPHS == {"eager": 3}
    assert graphed._graphs.sizes() == {graphs.key_of(8, 10, False, False, False): 0}


def test_a_failed_call_drops_its_replay(pair, stubbed, monkeypatch):
    """A replay whose call raised is not handed to the next call."""
    graphed, eager = pair
    graphed._init_graphs()
    q = _near_queries(graphed, 3, 13)
    graphed.search(q, 10)

    def broken(*tensors):
        raise RuntimeError("fetch failed")

    monkeypatch.setattr(device, "device_fetch", broken)
    with pytest.raises(RuntimeError, match="fetch failed"):
        graphed.search(q, 10)
    assert graphed._graphs.sizes() == {graphs.key_of(8, 10, False, False, False): 0}


def test_enqueue_span_names_the_mode(pair, stubbed):
    graphed, _ = pair
    graphed._init_graphs()
    records = []
    tracing.setup_tracing("test", exporter=SimpleNamespace(on_span_end=records.append, shutdown=lambda: None))
    try:
        q = _near_queries(graphed, 3, 14)
        graphed.search(q, 10)
        graphed.search(q, 10)
        graphed.search(_near_queries(graphed, 100, 14), 10)
    finally:
        tracing.teardown_tracing()
    enq = [r.attributes for r in records if r.name == "device_index.enqueue"]
    assert enq == [{"graph": "capture"}, {"graph": "replay"}, {"graph": "eager"}]


def test_cpu_tensors_never_capture(monkeypatch):
    """Without the stubs a CPU index runs eagerly, counts nothing in
    ``GRAPHS`` and records no ``graph`` attribute."""

    def refuse(r):
        raise AssertionError("a capture on the CPU")

    monkeypatch.setattr(graphs, "capture", refuse)
    index = make_index()
    assert not index._graphed()
    before = dict(graphs.GRAPHS)
    records = []
    tracing.setup_tracing("test", exporter=SimpleNamespace(on_span_end=records.append, shutdown=lambda: None))
    try:
        for kw in (dict(), dict(min_score=0.5), dict(para_mask=np.arange(ROWS) % 2 == 0)):
            index.search(_near_queries(index, 5, 15), 10, **kw)
    finally:
        tracing.teardown_tracing()
    assert dict(graphs.GRAPHS) == before and index._graphs.sizes() == {}
    assert all("graph" not in r.attributes for r in records if r.name == "device_index.enqueue")


def test_recording_collects_adds_and_count_replays_them():
    """Inside ``recording()`` a thread's adds are kept, not counted; other
    threads count as usual; ``count`` adds the kept ones."""
    a, b = LaunchCounter(), LaunchCounter()
    with counts.recording() as adds:
        a.add("top2")
        b.add("binary")
        other = threading.Thread(target=a.add, args=("top1",))
        other.start()
        other.join()
    assert adds == [(a, "top2"), (b, "binary")]
    assert a == {"top1": 1} and not b
    counts.count(adds)
    counts.count(adds)
    assert a == {"top1": 1, "top2": 2} and b == {"binary": 2}
    a.add("top2")
    assert a["top2"] == 3


def test_graph_cache_close_drops_free_replays():
    cache = graphs.GraphCache(torch.device("cpu"))
    key = graphs.key_of(8, 10, False, False, True)
    base = torch.ones(16, dtype=torch.bool)
    r = cache.checkout(key, lambda: graphs.new_replay(key, 4, base))
    assert r.queries.shape == (8, 4) and r.floor.shape == (1,) and r.mask.shape == (16,)
    assert r.mask is not base and graphs.new_replay(graphs.key_of(8, 10, False, False, False), 4, base).mask is base
    assert r.queries.data_ptr() == r.inputs.data_ptr()
    r.graph = object()
    cache.checkin(r)
    assert cache.sizes() == {key: 1}
    cache.close()
    graphs.settle()
    assert cache.sizes() == {} and r.graph is None


def test_dropped_graphs_give_back_their_memory_and_streams(monkeypatch):
    """A dropped graph's memory leaves the card's count and its stream is
    captured on again; the stream of a replay whose call failed, whose graph
    may still run, is not."""
    monkeypatch.setattr(graphs, "_BYTES", {None: 300})
    monkeypatch.setattr(graphs, "_STREAMS", {None: []})
    key = graphs.key_of(8, 10, False, False, False)
    base = torch.ones(16, dtype=torch.bool)
    cache = graphs.GraphCache(torch.device("cpu"))
    rs = [cache.checkout(key, lambda: graphs.new_replay(key, 4, base)) for _ in range(2)]
    for n, r in enumerate(rs):
        r.graph, r.stream, r.bytes = object(), f"stream{n}", 100
    cache.checkin(rs[0], ok=False)
    cache.checkin(rs[1])
    graphs.settle()
    assert graphs._BYTES == {None: 200} and graphs._STREAMS == {None: []}
    assert cache.sizes() == {key: 1} and rs[0].graph is None and rs[0].stream is None
    cache.close()
    assert rs[1].graph is not None  # released by the capture thread, before its next capture
    graphs.settle()
    assert graphs._BYTES == {None: 100} and graphs._STREAMS == {None: ["stream1"]}
    assert rs[1].graph is None and rs[1].out == () and rs[1].run is None


def test_a_replay_reads_the_mask_it_was_captured_with(pair, stubbed, monkeypatch):
    """A graph keeps addresses, not tensors: each replay holds the mask its
    graph reads, the index's base mask when it was made, and hands that one
    to the route, even once the index's lazy base mask is another tensor
    (threads that race to make it each make one)."""
    graphed, eager = pair
    graphed._init_graphs()
    route = graphed._int8_route()
    masks = []

    def spying(*args):
        masks.append(args[3])
        return route(*args)

    monkeypatch.setattr(graphed, "_int8_route", lambda: spying)
    graphed._base_mask_dev = None
    q = _near_queries(graphed, 3, 16)
    graphed.search(q, 10)
    first = graphed._graphs._free[graphs.key_of(8, 10, False, False, False)][0]
    assert first.mask is graphed.base_mask_device() and masks and all(m is first.mask for m in masks)
    graphed._base_mask_dev = first.mask.clone()  # another thread's, made in a race
    masks.clear()
    _same(graphed.search(q, 5), eager.search(q, 5))
    second = graphed._graphs._free[graphs.key_of(8, 5, False, False, False)][0]
    assert second.mask is graphed._base_mask_dev and all(m is second.mask for m in masks)
    assert first.mask is not second.mask
    _same(graphed.search(q, 10), eager.search(q, 10))
    graphed._base_mask_dev = None
