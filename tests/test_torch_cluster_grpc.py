"""The scenarios of ``tests/test_cluster_grpc.py`` on the port: the port's ``EmbeddedNode`` on the CPU behind its gRPC plane and ``cluster/``."""

import numpy as np
import pytest

from nucliadb_tpu_torch.cluster import DistributedSearcher, ShardSelector, merge_shard_responses
from nucliadb_tpu_torch.grpc_plane import NodeClient, NodeGrpcServer
from nucliadb_tpu_torch.index.vector import VectorConfig
from nucliadb_tpu_torch.models.internal import (
    IndexParagraph,
    ResourceDoc,
    TextInformation,
    VectorSentence,
)
from nucliadb_tpu_torch.services import EmbeddedNode
from nucliadb_tpu_torch.shard import ShardSearchRequest
from nucliadb_tpu_torch.storage import MemoryStorage

DIM = 16


def embed(t):
    r = np.random.default_rng(abs(hash(t)) % (2**31))
    v = r.standard_normal(DIM).astype(np.float32)
    return v / np.linalg.norm(v)


def make_resource(rid, text):
    rd = ResourceDoc(resource_id=rid, created=1, modified=1)
    rd.texts["t/t1"] = TextInformation(text=text)
    p = IndexParagraph(start=0, end=len(text))
    p.vectorsets_sentences["m1"] = {
        f"{rid}/t/t1/0/0-{len(text)}": VectorSentence(vector=embed(text))
    }
    rd.paragraphs["t/t1"] = {f"{rid}/t/t1/0-{len(text)}": p}
    rd.vectors_to_delete_in_all_vectorsets = [rid + "/"]
    rd.paragraphs_to_delete = [rid + "/"]
    return rd


# ---- rendezvous ------------------------------------------------------------


def test_rendezvous_determinism_and_spread():
    nodes = [f"node{i}" for i in range(5)]
    sel = ShardSelector(nodes, replication=2)
    shards = [f"shard{i}" for i in range(200)]
    placements = {s: sel.nodes_for_shard(s) for s in shards}
    # deterministic
    assert placements == {s: sel.nodes_for_shard(s) for s in shards}
    # reasonably spread
    counts = {n: 0 for n in nodes}
    for reps in placements.values():
        counts[reps[0]] += 1
    assert max(counts.values()) < 3 * min(counts.values()) + 10


def test_rendezvous_minimal_movement():
    shards = [f"s{i}" for i in range(300)]
    sel5 = ShardSelector([f"n{i}" for i in range(5)], replication=1)
    sel6 = ShardSelector([f"n{i}" for i in range(6)], replication=1)
    moved = sum(
        1 for s in shards if sel5.nodes_for_shard(s)[0] != sel6.nodes_for_shard(s)[0]
    )
    # expected ~1/6 of shards move; allow slack
    assert moved < len(shards) * 0.3


# ---- gRPC node services -----------------------------------------------------


@pytest.fixture
def grpc_node(tmp_path):
    node = EmbeddedNode(device="cpu", data_dir=str(tmp_path / "n"), storage=MemoryStorage())
    server = NodeGrpcServer(node)
    server.start()
    client = NodeClient(f"127.0.0.1:{server.port}")
    yield node, client
    client.close()
    server.stop()


def test_grpc_full_flow(grpc_node):
    node, client = grpc_node
    shard_id = client.new_shard("kb1", {"m1": VectorConfig(dimension=DIM)})
    assert client.list_shards("kb1")[0]["id"] == shard_id

    client.index(shard_id, make_resource("r1", "the quick brown fox"))
    client.index(shard_id, make_resource("r2", "lazy dogs sleep"))
    client.sync()

    resp = client.search(
        shard_id,
        ShardSearchRequest(body="quick fox", vector=embed("the quick brown fox"), top_k=3),
    )
    assert resp.paragraph.hits[0].rid == "r1"
    assert resp.vector[0].key.startswith("r1/")
    np.testing.assert_allclose(resp.vector[0].score, 1.0, rtol=1e-3)

    stats = client.get_shard(shard_id)
    kinds = {i["kind"] for i in stats["indexes"]}
    assert kinds == {"text", "paragraph", "relation", "json", "vector"}
    vec = next(i for i in stats["indexes"] if i["kind"] == "vector")
    # prewarm = int8 codes + f32 rerank arena for 2 vectors of DIM dims
    assert vec["prewarm_bytes"] == 2 * DIM * 5
    assert all("prewarm_bytes" in i for i in stats["indexes"])

    client.delete_resource(shard_id, "r1")
    client.sync()
    resp2 = client.search(shard_id, ShardSearchRequest(body="fox", top_k=3))
    assert resp2.paragraph.hits == []


# ---- distributed scatter-gather with failover -------------------------------


class LocalBackend:
    def __init__(self, node):
        self.node = node
        self.isolated = False  # simulated network partition

    def search(self, shard_id, request):
        if self.isolated:
            raise ConnectionError("network partition")
        return self.node.search(shard_id, request)


def test_distributed_search_failover(tmp_path):
    # 3 nodes; every shard indexed on all (full replication for the test)
    nodes = {}
    backends = {}
    shard_ids = []
    for i in range(3):
        n = EmbeddedNode(device="cpu", data_dir=str(tmp_path / f"n{i}"), storage=MemoryStorage())
        nodes[f"node{i}"] = n
        backends[f"node{i}"] = LocalBackend(n)
    # two shards, same data replicated on every node (replica simulation)
    for s in range(2):
        sid = f"shard{s}"
        shard_ids.append(sid)
        for n in nodes.values():
            n.create_shard("kb1", {"m1": VectorConfig(dimension=DIM)}, shard_id=sid)
            n.index(sid, make_resource(f"r{s}", f"document {s} about topic{s}"))
            n.wait_for_sync()

    selector = ShardSelector(list(backends), replication=3)
    searcher = DistributedSearcher(backends, selector)
    req = ShardSearchRequest(body="document", top_k=5)

    resp, errors = searcher.search(shard_ids, req)
    assert not errors
    assert {h.rid for h in resp.paragraph.hits} == {"r0", "r1"}

    # partition the primary replica of each shard: failover must kick in
    for sid in shard_ids:
        primary = selector.nodes_for_shard(sid)[0]
        backends[primary].isolated = True
    resp2, errors2 = searcher.search(shard_ids, req)
    assert not errors2
    assert {h.rid for h in resp2.paragraph.hits} == {"r0", "r1"}

    # isolate everything: errors reported, no crash
    for b in backends.values():
        b.isolated = True
    resp3, errors3 = searcher.search(shard_ids, req)
    assert len(errors3) == 2
    assert resp3.paragraph is None or resp3.paragraph.hits == []


def test_merge_orders_by_score(tmp_path):
    from nucliadb_tpu_torch.index.paragraph import ParagraphHit, ParagraphSearchResponse
    from nucliadb_tpu_torch.shard import ShardSearchResponse

    def presp(scores, prefix):
        return ShardSearchResponse(
            paragraph=ParagraphSearchResponse(
                hits=[
                    ParagraphHit(
                        paragraph_id=f"{prefix}{j}", rid=prefix, field="f",
                        score=s, start=0, end=1, split="", index=0, ematch=False,
                    )
                    for j, s in enumerate(scores)
                ],
                total=len(scores),
                ematches=[],
                query_terms=[],
            )
        )

    merged = merge_shard_responses([presp([0.9, 0.2], "a"), presp([0.5], "b")], top_k=2)
    assert [h.score for h in merged.paragraph.hits] == [0.9, 0.5]
    assert merged.paragraph.total == 3


def test_grpc_suggest_graph_and_streams(grpc_node):
    """The full NidxSearcher surface over gRPC: Suggest, GraphSearch and the
    Paragraphs/Documents streams (nodereader StreamRequest parity)."""
    from nucliadb_tpu_torch.models.internal import IndexRelation, RelationNode

    node, client = grpc_node
    shard_id = client.new_shard("kbg", {"m1": VectorConfig(dimension=DIM)})
    rd = make_resource("r1", "the quick brown fox")
    rd.relations["a/metadata"] = [
        IndexRelation(
            source=RelationNode(value="fox", subtype="animal"),
            relation="ENTITY",
            label="jumps over",
            target=RelationNode(value="dog", subtype="animal"),
        )
    ]
    client.index(shard_id, rd)
    client.index(shard_id, make_resource("r2", "quiet quiz quota"))
    client.sync()

    sugg = client.suggest(shard_id, "qui", top_k=5)
    assert sugg["paragraphs"] and all("id" in p for p in sugg["paragraphs"])
    assert any(p["rid"] in ("r1", "r2") for p in sugg["paragraphs"])

    paths = client.graph_search(shard_id, source_value="fox")
    assert paths and paths[0]["target"] == "dog"
    assert client.graph_search(shard_id, source_value="cat") == []

    paragraphs = list(client.stream_paragraphs(shard_id))
    assert {p["id"].split("/")[0] for p in paragraphs} == {"r1", "r2"}
    documents = list(client.stream_documents(shard_id))
    assert {d["uuid"] for d in documents} == {"r1", "r2"}
    assert all(d["field"] == "t/t1" for d in documents)

    # deletions drop out of the streams after sync
    client.delete_resource(shard_id, "r2")
    client.sync()
    assert {p["id"].split("/")[0] for p in client.stream_paragraphs(shard_id)} == {"r1"}


def test_writer_grpc_service(tmp_path):
    """Product-level Writer gRPC (parity: WriterServicer, ingest/service/
    writer.py:78): KB admin, ProcessMessage writes, vectorsets, backups."""
    from nucliadb_tpu_torch.common.kb import KnowledgeBoxManager
    from nucliadb_tpu_torch.grpc_plane import WriterClient, WriterGrpcServer
    from nucliadb_tpu_torch.ingest.processor import Processor
    from nucliadb_tpu_torch.maindb import Driver

    node = EmbeddedNode(device="cpu", data_dir=str(tmp_path / "n"), storage=MemoryStorage())
    driver = Driver(str(tmp_path / "kv.db"))
    kbs = KnowledgeBoxManager(driver, node)
    processor = Processor(driver, node, kbs)
    server = WriterGrpcServer(kbs, processor)
    server.start()
    client = WriterClient(f"127.0.0.1:{server.port}")
    try:
        kbid = client.new_kb({"slug": "wkb"})
        assert kbid in client.list_kbs()
        client.new_vectorset(kbid, "m1", {"dimension": DIM})

        out = client.process_message(
            kbid, "create",
            payload={"title": "Doc", "texts": {"t": {"body": "writer grpc body"}}},
        )
        rid = out["rid"]
        assert out["seq"] >= 0
        client.process_message(kbid, "update", rid=rid, payload={"title": "Doc2"})
        assert processor.get_payload(kbid, rid).title == "Doc2"

        backup_id = client.create_backup(kbid)
        restored = client.restore_backup(backup_id, slug="wkb-copy")
        assert processor.list_resources(restored)
        client.delete_backup(backup_id)

        client.process_message(kbid, "delete", rid=rid)
        assert processor.get_payload(kbid, rid) is None
        client.del_vectorset(kbid, "m1")
        client.delete_kb(kbid)
        assert kbid not in client.list_kbs()
    finally:
        client.close()
        server.stop()


def test_search_request_codec_roundtrip():
    """Every ShardSearchRequest field must survive the gRPC-plane codec —
    a dropped field silently changes remote search results (the date-range
    windows were missing until this test)."""
    import dataclasses

    import numpy as np

    from nucliadb_tpu_torch.grpc_plane.codec import (
        pack_search_request,
        unpack_search_request,
    )
    from nucliadb_tpu_torch.index.relation import (
        GraphSearchRequest,
        NodePattern,
        RelationPattern,
    )
    from nucliadb_tpu_torch.query_language import LabelAtom
    from nucliadb_tpu_torch.shard import ShardSearchRequest

    req = ShardSearchRequest(
        body="hello",
        top_k=7,
        paragraph=True,
        document=True,
        vector=np.ones((2, 4), np.float32),
        vectorset="m",
        min_score_semantic=0.3,
        min_score_bm25=0.1,
        all_terms=True,
        filter=LabelAtom("/l/a/b"),
        security_groups=["g1"],
        key_filters=["rid1/"],
        include_hidden=True,
        with_duplicates=True,  # default-False fields MUST flip here, or a
        # codec drop is invisible to the field loop below
        range_creation=(1.0, 2.0),
        range_modification=(None, 9.0),
        graph=GraphSearchRequest(
            source=NodePattern(value="a"),
            relation=RelationPattern(),
            target=NodePattern(),
            undirected=True,
            top_k=5,
        ),
        faceted=["/l"],
        only_faceted=False,
        order_by="created",
        order_desc=False,
    )
    got = unpack_search_request(pack_search_request(req))
    for f in dataclasses.fields(ShardSearchRequest):
        a, b = getattr(req, f.name), getattr(got, f.name)
        if f.name == "vector":
            assert np.array_equal(a, b), "vector"
        elif f.name in ("filter", "field_filter", "json_filter", "graph"):
            assert (a is None) == (b is None), f.name
        elif f.name in ("range_creation", "range_modification"):
            assert (tuple(a) if a else None) == (tuple(b) if b else None), f.name
        else:
            assert a == b, f"field {f.name} dropped by codec: {a!r} != {b!r}"
