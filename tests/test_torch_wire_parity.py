"""The two packages' cluster planes talk to each other.

Clients and servers of the JAX package and of the port (a CPU node) are
crossed over the msgpack wire (``nidx.Node``), the protobuf wire
(``nidx.NidxSearcher``) and the substrate wire (``ndbtpu.Substrate``):

- a request packed by either package's codec unpacks in the other's into
  an equal object of that package, and so does a response;
- both packages' ``NodeClient``s ask both packages' ``NodeGrpcServer``s,
  which serve the same segment files (one sqlite metadata file and one
  blob store), and every answer equals the JAX node's in-process answer
  (ids in the reference's order up to ties, scores within 1e-5);
- one protobuf ``SearchRequest`` gets the same ``SearchResponse`` from
  both servers;
- a port node indexes and searches over a substrate served by the JAX
  package, and a JAX node over one served by the port, each answering as
  the other package's node over the same substrate.
"""

import grpc
import numpy as np
import pytest
from google.protobuf.json_format import MessageToDict

from nucliadb_tpu.grpc_plane import NodeClient, NodeGrpcServer, codec, protowire as pw
from nucliadb_tpu.index.json import JsonPredicate
from nucliadb_tpu.index.relation import GraphSearchRequest, NodePattern
from nucliadb_tpu.index.vector import VectorConfig
from nucliadb_tpu.metadata import MetadataStore
from nucliadb_tpu.models.internal import IndexRelation, RelationNode
from nucliadb_tpu.query_language import LabelAtom, and_, not_
from nucliadb_tpu.services import EmbeddedNode
from nucliadb_tpu.shard import ShardSearchRequest
from nucliadb_tpu.storage import LocalStorage
from nucliadb_tpu.substrate import RemoteMetadataStore, RemoteStorage, SubstrateServer

import nucliadb_tpu_torch.grpc_plane as port_plane
import nucliadb_tpu_torch.grpc_plane.codec as port_codec
import nucliadb_tpu_torch.services as port_services
import nucliadb_tpu_torch.substrate as port_substrate
from nucliadb_tpu_torch.metadata import MetadataStore as PortMetadataStore
from nucliadb_tpu_torch.storage import LocalStorage as PortLocalStorage

from tests.protowire_helpers import build_messages, fill
from tests.test_cluster_grpc import DIM, embed, make_resource
from tests.torch_test_helpers import as_port, assert_same_response, plain

MSGS = build_messages({"SearchRequest": pw.SEARCH_REQUEST, "SearchResponse": pw.SEARCH_RESPONSE})
TEXTS = [
    "the quick brown fox jumps", "lazy dogs sleep all day", "quick markets rally today",
    "a brown bear in the woods", "foxes and dogs are friends", "quantum flux capacitor quick",
]


def _resource(i):
    rd = make_resource(f"r{i}", TEXTS[i])
    rd.labels = [f"/l/topic/{'odd' if i % 2 else 'even'}"]
    rd.json_fields = {"a/j": '{"n": %d}' % i}
    rd.relations["a/metadata"] = [IndexRelation(source=RelationNode(value=f"r{i}"), target=RelationNode(value="x"))]
    return rd


def _requests():
    return [
        ShardSearchRequest(body="quick fox", vector=embed(TEXTS[0]), top_k=5, document=True),
        ShardSearchRequest(body="dogs", vector=embed(TEXTS[4]), top_k=3, filter=LabelAtom("/l/topic/even")),
        ShardSearchRequest(body="quick", top_k=10, key_filters=["r2/", "r5/"], paragraph=True),
        ShardSearchRequest(vector=embed(TEXTS[3]), top_k=4, paragraph=False, with_duplicates=True,
                           filter=and_(LabelAtom("/l/topic/odd"), not_(LabelAtom("/l/topic/even")))),
        ShardSearchRequest(body="brown", top_k=5, json_filter=JsonPredicate(path="n", op="gte", value=2),
                           graph=GraphSearchRequest(source=NodePattern(value="r3"))),
        ShardSearchRequest(body="quick", vector=embed(TEXTS[5]), top_k=5, min_score_semantic=0.5,
                           range_creation=(0.5, 2.0), order_by="created"),
    ]


@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    """A JAX node and a port node over one metadata file and blob store,
    each behind its own package's server, and each package's client of
    each server."""
    tmp = tmp_path_factory.mktemp("wire")
    db, blobs = str(tmp / "meta.db"), str(tmp / "blobs")
    ref = EmbeddedNode(data_dir=str(tmp / "jax"), storage=LocalStorage(blobs), metadata=MetadataStore(db))
    port = port_services.EmbeddedNode(
        data_dir=str(tmp / "port"), storage=PortLocalStorage(blobs), metadata=PortMetadataStore(db), device="cpu"
    )
    servers = {"jax": NodeGrpcServer(ref), "port": port_plane.NodeGrpcServer(port)}
    for server in servers.values():
        server.start()
    clients = {
        (client, server): (NodeClient if client == "jax" else port_plane.NodeClient)(f"127.0.0.1:{s.port}")
        for client in ("jax", "port")
        for server, s in servers.items()
    }
    # each package's client creates and writes through the other's server
    sid = clients["jax", "port"].new_shard("kb1", {"m1": VectorConfig(dimension=DIM)}, shard_id="s1")
    for i in range(6):
        if i % 2:
            clients["port", "jax"].index(sid, as_port(_resource(i)))
        else:
            clients["jax", "port"].index(sid, _resource(i))
    clients["port", "jax"].delete_resource(sid, "r1")
    for c in clients.values():
        c.sync()
    yield ref, port, clients, servers, sid
    for c in clients.values():
        c.close()
    for server in servers.values():
        server.stop(0)


@pytest.mark.parametrize("i", range(len(_requests())))
def test_codec_request_crosses_both_ways(i):
    req = _requests()[i]
    got = port_codec.unpack_search_request(codec.pack_search_request(req))
    assert plain(got) == plain(as_port(req))
    assert type(got).__module__.startswith("nucliadb_tpu_torch.")
    back = codec.unpack_search_request(port_codec.pack_search_request(as_port(req)))
    assert plain(back) == plain(req)
    for f in ("filter", "json_filter", "graph"):
        value = getattr(got, f)
        assert value is None or type(value).__module__.startswith("nucliadb_tpu_torch."), f
    if req.vector is not None:
        assert got.vector.dtype == np.float32 and isinstance(got.vector, np.ndarray)


def test_codec_resource_and_response_cross(planes):
    ref, _, _, _, sid = planes
    doc = _resource(2)
    got = port_codec.unpack_resource(codec.pack_resource(doc))
    assert plain(got) == plain(as_port(doc))
    assert plain(codec.unpack_resource(port_codec.pack_resource(as_port(doc)))) == plain(doc)
    resp = ref.search(sid, _requests()[0])
    assert_same_response(port_codec.unpack_search_response(codec.pack_search_response(resp)), resp)


@pytest.mark.parametrize("client", ["jax", "port"])
@pytest.mark.parametrize("server", ["jax", "port"])
def test_clients_and_servers_cross(planes, client, server):
    ref, _, clients, _, sid = planes
    for req in _requests():
        want = ref.search(sid, req)
        got = clients[client, server].search(sid, req if client == "jax" else as_port(req))
        assert type(got).__module__.startswith("nucliadb_tpu_torch." if client == "port" else "nucliadb_tpu.")
        assert_same_response(got, want)
    # the shard admin and the streams answer alike
    assert clients[client, server].list_shards("kb1") == [{"id": sid, "kbid": "kb1"}]
    ids = sorted(p["id"] for p in clients[client, server].stream_paragraphs(sid))
    assert ids and not any(i.startswith("r1/") for i in ids)
    assert ids == sorted(p["id"] for p in clients["jax", "jax"].stream_paragraphs(sid))


def test_proto_wire_answers_alike(planes):
    *_, servers, sid = planes
    req = MSGS["SearchRequest"]()
    fill(req, {"shard_ids": [sid], "body": "quick fox", "result_per_page": 5, "paragraph": True, "document": True,
               "vector": embed(TEXTS[0]).tolist(), "vectorset": "m1", "min_score_semantic": -1.0})
    answers = {}
    for name, server in servers.items():
        with grpc.insecure_channel(f"127.0.0.1:{server.port}") as channel:
            fn = channel.unary_unary("/nidx.NidxSearcher/Search", request_serializer=lambda m: m.SerializeToString(),
                                     response_deserializer=MSGS["SearchResponse"].FromString)
            answers[name] = MessageToDict(fn(req, timeout=30))
    want, got = answers["jax"], answers["port"]
    assert want["paragraph"]["results"] and want["vector"]["documents"]
    for leg, items in (("paragraph", "results"), ("document", "results"), ("vector", "documents")):
        w, g = want[leg].pop(items), got[leg].pop(items)
        assert len(g) == len(w), leg
        for a, b in zip(g, w):
            score_a, score_b = a.pop("score"), b.pop("score")
            sa = score_a.get("bm25", score_a) if isinstance(score_a, dict) else score_a
            sb = score_b.get("bm25", score_b) if isinstance(score_b, dict) else score_b
            assert np.isclose(sa, sb, rtol=1e-5, atol=1e-6), (leg, a, b)
            assert a == b, leg
    assert got == want


def _index_and_search(node, sid, conv):
    for i in range(6):
        node.index(sid, conv(_resource(i)))
    node.wait_for_sync()
    return [node.search(sid, conv(r)) for r in _requests()]


@pytest.mark.parametrize("served_by", ["jax", "port"])
def test_node_over_the_other_packages_substrate(tmp_path, served_by):
    """A node of one package writes through a substrate served by the
    other; a node of the serving package then reads it, and each answers
    as the other. The remote clients are the writer's own package's."""
    server_cls = SubstrateServer if served_by == "jax" else port_substrate.SubstrateServer
    server = server_cls(str(tmp_path / "substrate"))
    server.start()
    addr = f"127.0.0.1:{server.port}"
    try:
        if served_by == "jax":  # the port writes, the JAX node reads
            writer = port_services.EmbeddedNode(
                data_dir=str(tmp_path / "w"), metadata=port_substrate.RemoteMetadataStore(addr),
                storage=port_substrate.RemoteStorage(addr), device="cpu",
            )
            reader = EmbeddedNode(data_dir=str(tmp_path / "r"), metadata=RemoteMetadataStore(addr),
                                  storage=RemoteStorage(addr))
            wconv, rconv = as_port, (lambda x: x)
        else:  # the JAX node writes, the port reads
            writer = EmbeddedNode(data_dir=str(tmp_path / "w"), metadata=RemoteMetadataStore(addr),
                                  storage=RemoteStorage(addr))
            reader = port_services.EmbeddedNode(
                data_dir=str(tmp_path / "r"), metadata=port_substrate.RemoteMetadataStore(addr),
                storage=port_substrate.RemoteStorage(addr), device="cpu",
            )
            wconv, rconv = (lambda x: x), as_port
        sid = writer.create_shard("kb1", wconv({"m1": VectorConfig(dimension=DIM)}), shard_id="s1")
        written = _index_and_search(writer, sid, wconv)
        stats = writer.tick_background()  # merges over the remote metadata and blobs
        assert stats["merged"] >= 1
        reader.wait_for_sync()
        read = [reader.search(sid, rconv(r)) for r in _requests()]
        for got, want in zip(read, written):
            assert_same_response(got, want)
        assert written[0].vector and written[0].paragraph.hits
    finally:
        server.stop()


def test_substrate_kv_and_bus_cross(tmp_path):
    """The maindb and the bus through the other package's clients."""
    jax_server = SubstrateServer(str(tmp_path / "j"))
    port_server = port_substrate.SubstrateServer(str(tmp_path / "p"))
    for s in (jax_server, port_server):
        s.start()
    try:
        import nucliadb_tpu.substrate as jax_substrate

        for clients, server in ((port_substrate, jax_server), (jax_substrate, port_server)):
            addr = f"127.0.0.1:{server.port}"
            kv = clients.RemoteDriver(addr)
            with kv as txn:
                txn.set("a/1", b"v1")
                txn.set("a/2", b"v2")
            with kv as txn:
                assert txn.batch_get(["a/1", "a/3"]) == [b"v1", None] and txn.count("a/") == 2
            bus = clients.RemoteBus(addr)
            assert bus.publish("st", "p.0", b"one") == 1
            msg = bus.next("st", "c1")
            assert (msg.seq, msg.payload) == (1, b"one") and type(msg).__module__.startswith(clients.__name__.split(".")[0])
            bus.ack("st", "c1", msg.seq)
            meta = clients.RemoteMetadataStore(addr)
            s1 = meta.next_seq()
            assert type(s1).__module__.startswith(clients.__name__.split(".")[0]) and int(meta.last_seq()) == int(s1)
            for c in (kv, bus, meta):
                c.close()
    finally:
        for s in (jax_server, port_server):
            s.stop()

