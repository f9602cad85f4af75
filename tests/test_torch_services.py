"""The port's index node against the JAX package's, on the same inputs.

The device-relevant scenarios of ``tests/test_services.py`` run on both
packages' ``EmbeddedNode`` (the port's with ``device="cpu"``) and their
answers compare field by field; then the node's parts the port adds or
repairs: segments crossing between the packages through storage, the
refresh through ``prev``, ``_legs_host_resident``, the vector coalescer
under threads, and the kernels' first-use build under threads.
"""

import threading
import time

import numpy as np
import pytest

from nucliadb_tpu.index.vector import VectorConfig
from nucliadb_tpu.services import EmbeddedNode
from nucliadb_tpu.shard import ShardSearchRequest
from nucliadb_tpu.storage import MemoryStorage

import nucliadb_tpu_torch.services as port_services
from nucliadb_tpu_torch.storage import MemoryStorage as PortMemoryStorage

from tests.test_services import DIM, embed, make_resource
from tests.torch_test_helpers import as_port, assert_same_ranked, assert_same_response, plain


def _nodes(tmp_path):
    """(JAX node, port node, the port's input conversion)."""
    ref = EmbeddedNode(data_dir=str(tmp_path / "jax"), storage=MemoryStorage())
    port = port_services.EmbeddedNode(data_dir=str(tmp_path / "port"), storage=PortMemoryStorage(), device="cpu")
    return ref, port


def _end_to_end(node, conv):
    sid = node.create_shard("kb1", conv({"m1": VectorConfig(dimension=DIM)}), shard_id="s1")
    node.index(sid, conv(make_resource("r1", "the quick brown fox")))
    node.index(sid, conv(make_resource("r2", "lazy dogs sleep all day")))
    node.wait_for_sync()
    return [node.search(sid, conv(ShardSearchRequest(body="quick fox", vector=embed("the quick brown fox"), top_k=5)))]


def _reindex(node, conv):
    sid = node.create_shard("kb1", conv({"m1": VectorConfig(dimension=DIM)}), shard_id="s1")
    node.index(sid, conv(make_resource("r1", "original content about cats")))
    updated = make_resource("r1", "updated content about dogs")
    updated.vectors_to_delete_in_all_vectorsets = ["r1/"]
    updated.paragraphs_to_delete = ["r1/"]
    node.index(sid, conv(updated))
    node.wait_for_sync()
    return [
        node.search(sid, conv(ShardSearchRequest(body=body, vector=embed(body), top_k=5)))
        for body in ("cats", "dogs")
    ]


def _delete(node, conv):
    sid = node.create_shard("kb1", conv({"m1": VectorConfig(dimension=DIM)}), shard_id="s1")
    node.index(sid, conv(make_resource("r1", "findable content")))
    node.index(sid, conv(make_resource("r2", "findable content too")))
    node.delete_resource(sid, "r1")
    node.wait_for_sync()
    return [node.search(sid, conv(ShardSearchRequest(body="findable", vector=embed("findable content"), top_k=5)))]


def _merge(node, conv):
    sid = node.create_shard("kb1", conv({"m1": VectorConfig(dimension=DIM)}), shard_id="s1")
    for i in range(6):
        node.index(sid, conv(make_resource(f"r{i}", f"document number {i} quick")))
    node.delete_resource(sid, "r3")
    stats = node.tick_background()
    segments = {
        index.full_name: [(s.records, int(s.seq)) for s in node.metadata.ready_segments(index.id)]
        for index in node.metadata.get_indexes(sid)
    }
    node.wait_for_sync()
    resp = node.search(sid, conv(ShardSearchRequest(body="quick", vector=embed("document number 2 quick"), top_k=10)))
    return [stats, segments, resp]


def _ack_floor(node, conv):
    sid = node.create_shard("kb1", {}, shard_id="s1")
    for i in range(5):
        node.index(sid, conv(make_resource(f"r{i}", f"doc {i}")))
    seq = node.metadata.next_seq()
    node.metadata.record_index_request(seq)
    for i in range(5, 10):
        node.index(sid, conv(make_resource(f"r{i}", f"doc {i}")))
    floor = int(node.metadata.ack_floor())
    jobs = node.scheduler.schedule_merges()
    in_jobs = sorted(
        int(s.seq)
        for index in node.metadata.get_indexes(sid)
        for s in node.metadata.ready_segments(index.id)
        if s.merge_job_id
    )
    assert floor == int(seq) - 1 and all(s <= floor for s in in_jobs) and len(in_jobs) >= 4
    return [floor - int(seq), jobs, [s - int(seq) for s in in_jobs]]


def _delete_vectorset(node, conv):
    sid = node.create_shard("kb1", conv({"m1": VectorConfig(dimension=DIM)}), shard_id="s1")
    node.index(sid, conv(make_resource("r1", "the quick brown fox")))
    node.wait_for_sync()
    req = conv(ShardSearchRequest(body="", vector=embed("the quick brown fox"), paragraph=False, top_k=5))
    before = node.search(sid, req)
    node.delete_vectorset(sid, "m1")
    node.wait_for_sync()
    after = node.search(sid, req)
    assert before.vector and after.vector == []
    return [before, after, node.list_vectorsets(sid)]


def _deleted_shard(node, conv):
    sid = node.create_shard("kb1", {}, shard_id="s1")
    node.index(sid, conv(make_resource("r1", "alpha")))
    node.wait_for_sync()
    resp = node.search(sid, conv(ShardSearchRequest(body="alpha")))
    node.delete_shard(sid)
    node.wait_for_sync()
    return [resp, sid in node.searcher._shards]


SCENARIOS = {
    "end_to_end_index_and_search": _end_to_end,
    "reindex_replaces_old_version": _reindex,
    "delete_resource": _delete,
    "merge_pipeline": _merge,
    "merge_respects_ack_floor": _ack_floor,
    "delete_vectorset_drops_from_open_searcher": _delete_vectorset,
    "deleted_shard_evicted_from_searcher": _deleted_shard,
}


def _same_observations(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if type(w).__name__ == "ShardSearchResponse":
            assert_same_response(g, w)
        else:
            assert plain(g) == plain(w)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_node_scenario_matches_jax(tmp_path, scenario):
    ref, port = _nodes(tmp_path)
    want = SCENARIOS[scenario](ref, lambda x: x)
    got = SCENARIOS[scenario](port, as_port)
    _same_observations(got, want)


def test_node_scenario_assertions_hold_on_the_port(tmp_path):
    """The original scenarios' own assertions, on the port's answers."""
    _, port = _nodes(tmp_path)
    (resp,) = _end_to_end(port, as_port)
    assert resp.paragraph.hits[0].rid == "r1" and resp.vector[0].key.startswith("r1/")
    _, port = _nodes(tmp_path / "reindex")
    cats, dogs = _reindex(port, as_port)
    assert cats.paragraph.hits == [] and dogs.paragraph.hits[0].rid == "r1"
    _, port = _nodes(tmp_path / "merge")
    stats, segments, resp = _merge(port, as_port)
    assert stats["jobs_enqueued"] > 0 and stats["merged"] > 0
    assert [r for r, _ in segments["text"]] == [5]  # one merged segment, r3 dropped
    assert len(resp.paragraph.hits) == 5 and all(h.rid != "r3" for h in resp.paragraph.hits)
    _, port = _nodes(tmp_path / "shard")
    assert _deleted_shard(port, as_port)[1] is False


def test_segments_cross_between_the_packages(tmp_path):
    """One sqlite metadata file and one blob store shared by a JAX node and
    a port node: segments the JAX indexer packed open in the port's
    searcher, the port's worker merges them, and the JAX searcher opens the
    merged segments; every answer equals the other package's."""
    from nucliadb_tpu.metadata import MetadataStore
    from nucliadb_tpu.storage import LocalStorage
    from nucliadb_tpu_torch.metadata import MetadataStore as PortMetadataStore
    from nucliadb_tpu_torch.storage import LocalStorage as PortLocalStorage

    db, blobs = str(tmp_path / "meta.db"), str(tmp_path / "blobs")
    ref = EmbeddedNode(data_dir=str(tmp_path / "jax"), storage=LocalStorage(blobs), metadata=MetadataStore(db))
    port = port_services.EmbeddedNode(
        data_dir=str(tmp_path / "port"), storage=PortLocalStorage(blobs), metadata=PortMetadataStore(db), device="cpu"
    )
    sid = ref.create_shard("kb1", {"m1": VectorConfig(dimension=DIM)}, shard_id="s1")
    for i in range(6):
        ref.index(sid, make_resource(f"r{i}", f"document number {i} quick"))
    ref.delete_resource(sid, "r4")
    reqs = [
        ShardSearchRequest(body="quick number", vector=embed("document number 1 quick"), top_k=10, document=True),
        ShardSearchRequest(body="document", key_filters=["r2/"], top_k=10),
    ]

    def both_answer_alike():
        for node in (ref, port):
            node.wait_for_sync()
        for r in reqs:
            assert_same_response(port.search(sid, as_port(r)), ref.search(sid, r))

    both_answer_alike()  # the JAX indexer's segments, opened by the port
    stats = port.tick_background()  # the port's worker merges them
    assert stats["merged"] >= 3
    text = [i for i in port.metadata.get_indexes(sid) if i.kind == "text"][0]
    assert [s.records for s in port.metadata.ready_segments(text.id)] == [5]
    both_answer_alike()  # the port's merged segments, opened by JAX
    port.index(sid, as_port(make_resource("r9", "document number 9 quick")))
    both_answer_alike()  # a segment of the port's indexer, opened by JAX


def test_merges_write_the_same_segments(tmp_path):
    """Each kind's merge over the same operants and deletions writes the
    same records in both packages."""
    from nucliadb_tpu.services.worker import WorkerService
    from nucliadb_tpu.shard import ShardConfig, ShardIndexer
    from nucliadb_tpu.types import Seq, SimpleOpenIndex
    from nucliadb_tpu_torch.services.worker import WorkerService as PortWorkerService
    from tests.test_shard import RESOURCES

    config = ShardConfig(shard_id="s", vectorsets={"model1": VectorConfig(dimension=16)})
    open_indexes = {}
    for i, r in enumerate(RESOURCES):
        for op in ShardIndexer(config).index_resource(r, str(tmp_path / f"op{i}")):
            oi = open_indexes.setdefault(op.index_name, SimpleOpenIndex(deletion_list=[("r2/", Seq(9))]))
            if op.segment is not None:
                oi.segment_list.append((op.segment, Seq(i + 1)))
    vector_cfg = config.vectorsets["model1"].to_dict()
    for name, oi in open_indexes.items():
        kind = name.split("/")[0]
        want = WorkerService._merge_inner(kind, vector_cfg, oi, str(tmp_path / "jax" / name))
        got = PortWorkerService._merge_inner(kind, vector_cfg, as_port(oi), str(tmp_path / "port" / name))
        assert (got.records, sorted(got.tags)) == (want.records, sorted(want.tags)), name
        assert plain(got.index_metadata) == plain(want.index_metadata), name
        for path in sorted(p.name for p in (tmp_path / "jax" / name).iterdir()):
            assert (tmp_path / "port" / name / path).read_bytes() == (tmp_path / "jax" / name / path).read_bytes(), (
                name, path,
            )


def test_refresh_through_prev_equals_a_fresh_searcher(tmp_path):
    """A sync after a delta reopens the shard with the old searcher as
    ``prev`` (the arena extends in place); its answers equal a fresh
    searcher's over the same segments."""
    from nucliadb_tpu_torch.services.searcher import SyncedSearcher

    _, port = _nodes(tmp_path)
    sid = port.create_shard("kb1", as_port({"m1": VectorConfig(dimension=DIM)}), shard_id="s1")
    for i in range(6):
        port.index(sid, as_port(make_resource(f"r{i}", f"document number {i} quick")))
    port.wait_for_sync()
    req = as_port(ShardSearchRequest(body="number quick", vector=embed("document number 7 quick"), top_k=10, document=True))
    port.search(sid, req)  # opens the shard
    old = port.searcher.shard(sid)
    for i in range(6, 9):
        port.index(sid, as_port(make_resource(f"r{i}", f"document number {i} quick")))
    assert port.wait_for_sync() == [sid]
    new = port.searcher.shard(sid)
    assert new is not old and old.vectors["m1"].index._extended
    assert new.vectors["m1"].index.vectors is old.vectors["m1"].index.vectors
    fresh = SyncedSearcher(port.metadata, port.storage, str(tmp_path / "fresh"), device="cpu")
    got, want = port.search(sid, req), fresh.search(sid, req)
    assert_same_response(got, want)
    assert {h.rid for h in got.paragraph.hits} >= {"r6", "r7", "r8"}


@pytest.mark.parametrize(
    "case", ["host_tiers", "text_tier_off", "vector_host_tier_off", "int8_codes", "no_vectorset", "hnsw", "ivf"]
)
def test_legs_host_resident_answers_as_jax(tmp_path, monkeypatch, case):
    """The port's ``_legs_host_resident`` asks its index's ``host_resident``
    (a host arena, and no codes, IVF layout or graph) and answers as the
    JAX one does: a small index flagged hnsw or ivf walks its graph or
    probes its clusters instead of the host tier."""
    import nucliadb_tpu.index.vector.device as ref_device
    import nucliadb_tpu_torch.index.vector.device as port_device
    from nucliadb_tpu.shard import ShardConfig
    from tests.test_torch_shard import _pair

    from tests.test_shard import RESOURCES

    if case == "vector_host_tier_off":
        monkeypatch.setattr(ref_device, "HOST_SCAN_ELEMS", 0)
        monkeypatch.setattr(port_device, "HOST_SCAN_ELEMS", 0)
    if case == "int8_codes":
        monkeypatch.setattr(ref_device, "EXACT_SCAN_THRESHOLD", 1)
        monkeypatch.setattr(port_device, "EXACT_SCAN_THRESHOLD", 1)
    flags = [case] if case in ("hnsw", "ivf") else []
    vectorsets = {} if case == "no_vectorset" else {"model1": VectorConfig(dimension=16, flags=flags)}
    ref, port, cross = _pair(tmp_path, ShardConfig(shard_id="s", vectorsets=vectorsets), RESOURCES)
    if case == "text_tier_off":
        for s in (ref, port, cross):
            s.paragraph.engine._host_tier_cached = None
    req = ShardSearchRequest(body="quick", vector=np.ones(16, np.float32), top_k=3)
    want = ref._legs_host_resident(req)
    assert port._legs_host_resident(as_port(req)) == want == cross._legs_host_resident(as_port(req))
    assert want == (case in ("host_tiers", "no_vectorset"))
    resp = port.search(as_port(req))  # and the hybrid runs either way
    assert_same_response(resp, ref.search(req))


def test_vector_coalescer_shares_dispatches_under_threads(tmp_path):
    """64 single queries from 8 threads through one coalescer: fewer than
    64 dispatches, every answer its solo answer (scores within RTOL)."""
    from nucliadb_tpu_torch.index.vector import Elem, VectorConfig as PortVectorConfig, VectorSearcher, VectorSearchRequest
    from nucliadb_tpu_torch.index.vector import create_segment
    from nucliadb_tpu_torch.index.vector.batcher import QueryCoalescer
    from nucliadb_tpu_torch.types import Seq, SimpleOpenIndex

    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((300, 32)).astype(np.float32)
    cfg = PortVectorConfig(dimension=32)
    meta = create_segment(str(tmp_path / "s"), [Elem(key=f"r{i:03d}/f/0-1", vectors=vecs[i]) for i in range(300)], cfg)
    searcher = VectorSearcher(cfg, SimpleOpenIndex(segment_list=[(meta, Seq(1))]), device="cpu")

    class Slow:
        """The searcher, with a dispatch that takes long enough for queries
        to queue behind it."""

        def search(self, req):
            time.sleep(0.01)
            return searcher.search(req)

    slow, coalescer = Slow(), QueryCoalescer(concurrency=2)
    queries = rng.standard_normal((64, 32)).astype(np.float32)
    out, errors = {}, []

    def worker(rows):
        try:
            for i in rows:
                out[i] = coalescer.search_one(slow, VectorSearchRequest(vectors=queries[i], top_k=5))
        except BaseException as e:  # pragma: no cover - failure reporting
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(range(t, 64, 8),)) for t in range(8)]
    [t.start() for t in threads]
    [t.join(timeout=60) for t in threads]
    assert not errors and len(out) == 64
    assert coalescer.dispatches < 64 and coalescer.batched_queries == 64
    for i in range(64):
        solo = searcher.search(VectorSearchRequest(vectors=queries[i], top_k=5))[0]
        # a batch's product sums in another order than a lone query's
        hits = [[h[1] for h in plain(x)] for x in (out[i], solo)]
        assert_same_ranked(*hits, lambda h: h["key"], what=f"query {i}")


def test_threaded_hybrid_requests_equal_their_solo_answers(tmp_path):
    """Hybrid requests from 8 threads through one port node (the paragraph
    leg on the index pool, both coalescers shared) answer as one at a time."""
    _, port = _nodes(tmp_path)
    sid = port.create_shard("kb1", as_port({"m1": VectorConfig(dimension=DIM)}), shard_id="s1")
    texts = [f"document {i} about {w}" for i, w in enumerate(["cats", "dogs", "quick foxes", "lazy dogs"] * 4)]
    for i, t in enumerate(texts):
        port.index(sid, as_port(make_resource(f"r{i:02d}", t)))
    port.wait_for_sync()
    reqs = [as_port(ShardSearchRequest(body=t.split()[-1], vector=embed(t), top_k=5)) for t in texts * 2]
    solo = [port.search(sid, r) for r in reqs]
    out = [None] * len(reqs)

    def worker(k):
        for i in range(k, len(reqs), 8):
            out[i] = port.search(sid, reqs[i])

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    [t.start() for t in threads]
    [t.join(timeout=60) for t in threads]
    for got, want in zip(out, solo):
        assert_same_response(got, want)


def test_kernels_build_once_under_threads(monkeypatch):
    """A first request arriving from 8 threads builds and loads each
    kernel once (``kernels.load`` holds one lock around both)."""
    from nucliadb_tpu_torch.utils import kernels

    builds, barrier = [], threading.Barrier(8)

    def build(name):
        builds.append(name)
        time.sleep(0.05)  # a slow nvcc: the other threads arrive meanwhile
        return f"/lib{name}.so"

    monkeypatch.setattr(kernels, "_loaded", {})
    monkeypatch.setattr(kernels, "build", build)
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: ("lib", path))
    libs = []

    def first_request():
        barrier.wait()
        libs.append(kernels.load("int8_slot_scan"))

    threads = [threading.Thread(target=first_request) for _ in range(8)]
    [t.start() for t in threads]
    [t.join(timeout=30) for t in threads]
    assert builds == ["int8_slot_scan"] and libs == [("lib", "/libint8_slot_scan.so")] * 8


def test_launch_counters_lose_no_count_under_threads():
    from nucliadb_tpu_torch.utils.counts import LaunchCounter

    counter = LaunchCounter()

    def bump():
        for _ in range(20_000):
            counter.add("top2")

    threads = [threading.Thread(target=bump) for _ in range(8)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert counter["top2"] == 160_000 and counter.total() == 160_000


def test_searcher_lru_and_single_flight(tmp_path):
    """tests/test_services.py:271 on the port's SyncedSearcher."""
    from unittest import mock

    from nucliadb_tpu_torch.metadata import MetadataStore
    from nucliadb_tpu_torch.services.searcher import SyncedSearcher

    metadata = MetadataStore(str(tmp_path / "meta.db"))
    for i in range(4):
        metadata.create_shard(f"s{i}", "kb")
        metadata.create_index(f"s{i}", "text", "text", {})
    searcher = SyncedSearcher(metadata, PortMemoryStorage(), str(tmp_path / "cache"), max_open_shards=2, device="cpu")
    searcher.shard("s0")
    searcher.shard("s1")
    searcher.shard("s2")  # evicts s0
    assert list(searcher._shards) == ["s1", "s2"]
    searcher.shard("s1")
    searcher.shard("s3")  # evicts s2
    assert list(searcher._shards) == ["s1", "s3"]
    searcher._shards.clear()
    calls = []
    orig = searcher._reload_shard

    def counting(shard_id):
        calls.append(shard_id)
        return orig(shard_id)

    with mock.patch.object(searcher, "_reload_shard", side_effect=counting):
        threads = [threading.Thread(target=searcher.shard, args=("s0",)) for _ in range(8)]
        [t.start() for t in threads]
        [t.join() for t in threads]
    assert calls == ["s0"]


def test_concurrent_search_during_ingest_and_merge(tmp_path):
    """tests/test_services.py:439 on the port's node: searches racing
    ingest, merges and syncs stay well-formed, and the final state holds
    every resource."""
    from nucliadb_tpu.models.internal import IndexParagraph, ResourceDoc, TextInformation, VectorSentence

    dim = 8
    node = port_services.EmbeddedNode(data_dir=str(tmp_path / "n"), storage=PortMemoryStorage(), device="cpu")
    shard = node.create_shard("kbc", as_port({"m1": VectorConfig(dimension=dim)}))

    def doc(i):
        rd = ResourceDoc(resource_id=f"r{i}", created=1, modified=1)
        text = f"race doc number {i} token{i % 3}"
        rd.texts["t/t"] = TextInformation(text=text)
        p = IndexParagraph(start=0, end=len(text))
        v = np.zeros(dim, np.float32)
        v[i % dim] = 1.0
        p.vectorsets_sentences["m1"] = {f"r{i}/t/t/0/0-{len(text)}": VectorSentence(vector=v)}
        rd.paragraphs["t/t"] = {f"r{i}/t/t/0-{len(text)}": p}
        return as_port(rd)

    node.index(shard, doc(0))
    node.wait_for_sync()
    stop = threading.Event()
    errors = []

    def writer():
        try:
            for i in range(1, 40):
                node.index(shard, doc(i))
                if i % 5 == 0:
                    node.tick_background()
                node.wait_for_sync()
        except BaseException as e:  # pragma: no cover - failure reporting
            errors.append(e)

    def reader():
        q = np.zeros(dim, np.float32)
        q[0] = 1.0
        try:
            while not stop.is_set():
                resp = node.search(shard, as_port(ShardSearchRequest(body="race", vector=q, top_k=5)))
                assert all(h.key.startswith("r") for h in resp.vector)
                assert resp.paragraph is None or all(h.rid.startswith("r") for h in resp.paragraph.hits)
                time.sleep(0.001)  # yield the GIL: three spinning readers starve the writer
        except BaseException as e:  # pragma: no cover
            errors.append(e)

    w = threading.Thread(target=writer)
    readers = [threading.Thread(target=reader) for _ in range(3)]
    w.start()
    [r.start() for r in readers]
    w.join(timeout=120)
    stop.set()
    [r.join(timeout=10) for r in readers]
    assert not errors, errors
    node.wait_for_sync()
    assert node.search(shard, as_port(ShardSearchRequest(body="race", top_k=50))).paragraph.total >= 40


def test_prometheus_service_metrics(tmp_path):
    """tests/test_services.py:403 on the port: per-kind indexing and merge
    counters and the sync-delay gauge reach the port's registry, under the
    JAX package's metric names."""
    from nucliadb_tpu_torch.telemetry.metrics import render_prometheus

    node = port_services.EmbeddedNode(data_dir=str(tmp_path / "n"), storage=PortMemoryStorage(), device="cpu")
    shard = node.create_shard("kbm", as_port({"m1": VectorConfig(dimension=DIM)}))
    for i in range(5):
        node.index(shard, as_port(make_resource(f"r{i}", f"metrics doc {i}")))
    node.wait_for_sync()
    node.tick_background()
    body = render_prometheus().decode()
    assert 'ndbtpu_indexing_total{kind="text",status="ok"}' in body
    assert 'ndbtpu_indexing_total{kind="vector",status="ok"}' in body
    assert "ndbtpu_sync_delay_seconds" in body
    assert "ndbtpu_merge_total{" in body
    assert "ndbtpu_indexer_busy_seconds_total" in body and "ndbtpu_worker_busy_seconds_total" in body


def test_node_refuses_what_is_not_ported(tmp_path):
    """Nothing is refused any more: the s3, gcs and azure backends build the
    port's own clients and an unknown backend raises, and a CUDA node
    without a card raises; a CPU node indexes, syncs and searches
    vectorsets flagged hnsw and ivf, and a MULTI vectorset (one elem per
    paragraph, searched by MaxSim)."""
    import torch

    from nucliadb_tpu_torch.index.vector.config import VectorCardinality
    from nucliadb_tpu_torch.settings import StorageSettings
    from nucliadb_tpu_torch.storage import make_storage
    from nucliadb_tpu_torch.storage.azure import AzureStorage
    from nucliadb_tpu_torch.storage.gcs import GCSStorage
    from nucliadb_tpu_torch.storage.s3 import S3Storage

    for backend, cls in (("s3", S3Storage), ("gcs", GCSStorage), ("azure", AzureStorage)):
        assert type(make_storage(StorageSettings(backend=backend, account="acct", container="c"))) is cls
    with pytest.raises(ValueError, match="unknown storage backend"):
        make_storage(StorageSettings(backend="ftp"))
    node = port_services.EmbeddedNode(data_dir=str(tmp_path / "n"), storage=PortMemoryStorage(), device="cpu")
    multi = as_port(VectorConfig(dimension=DIM))
    multi.cardinality = VectorCardinality.MULTI
    sid = node.create_shard("kb", {"m1": multi}, shard_id="multi")
    node.index(sid, as_port(make_resource("r1", "some text")))
    node.wait_for_sync()
    index = node.searcher.shard(sid).vectors["m1"].index
    assert index.multi and index.m_max == 1 and index.keys == ["r1/t/t1/0-9"]
    resp = node.search(sid, as_port(ShardSearchRequest(body="", vector=embed("some text"), paragraph=False)))
    assert [h.key for h in resp.vector] == ["r1/t/t1/0-9"]
    np.testing.assert_allclose(resp.vector[0].score, 1.0, rtol=1e-5)
    for flag in ("hnsw", "ivf"):
        sid = node.create_shard("kb", {"m1": as_port(VectorConfig(dimension=DIM, flags=[flag]))}, shard_id=flag)
        res = as_port(make_resource("r1", "some text"))
        node.index(sid, res)
        node.wait_for_sync()
        index = node.searcher.shard(sid).vectors["m1"].index
        assert (index.graph if flag == "hnsw" else index.ivf) is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            port_services.EmbeddedNode(data_dir=str(tmp_path / "c"), storage=PortMemoryStorage())
