"""The port never imports jax or the JAX package, and never moves a CUDA
request to the CPU: its vector and keyword legs, its index node, its
product layer's /find, its standalone server answering /find over HTTP,
its mesh (the sharded indexes, the groups and ``search_multi``'s mesh
branch) and its component mode (the substrate, the gRPC planes and the
cluster's scatter-gather, with each component in a process of its own).

``tests/conftest.py`` imports jax into the test process, so the import
check runs in a fresh interpreter.
"""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent(
    """
    import sys, tempfile
    import numpy as np
    import nucliadb_tpu_torch
    import nucliadb_tpu_torch.utils.kernels
    from nucliadb_tpu_torch.index.vector import (
        Elem, VectorConfig, VectorSearcher, VectorSearchRequest, create_segment,
    )
    import nucliadb_tpu_torch.index.vector.device as device
    from nucliadb_tpu_torch.ops import binary_scan, distance, quant, slot_scan, topk
    from nucliadb_tpu_torch.types import Seq, SimpleOpenIndex

    rng = np.random.default_rng(0)
    v = rng.standard_normal((40, 16)).astype(np.float32)
    cfg = VectorConfig(dimension=16)
    with tempfile.TemporaryDirectory() as d:
        meta = create_segment(d + "/s", [Elem(key=f"r/{i}", vectors=v[i]) for i in range(40)], cfg)
        searcher = VectorSearcher(cfg, SimpleOpenIndex(segment_list=[(meta, Seq(1))]), device="cpu")
        hits = searcher.search(VectorSearchRequest(vectors=v[7], top_k=3))
    assert hits[0][0].key == "r/7", hits

    # the hnsw and ivf flags: the graph and the centroids built at create
    from nucliadb_tpu_torch.ops import hnsw, ivf
    for flag in ("hnsw", "ivf"):
        cfg = VectorConfig(dimension=16, flags=[flag])
        with tempfile.TemporaryDirectory() as d:
            meta = create_segment(d + "/s", [Elem(key=f"r/{i}", vectors=v[i]) for i in range(40)], cfg, device="cpu")
            searcher = VectorSearcher(cfg, SimpleOpenIndex(segment_list=[(meta, Seq(1))]), device="cpu")
            hits = searcher.search(VectorSearchRequest(vectors=v[7], top_k=3))
        assert hits[0][0].key == "r/7", (flag, hits)
    assert hnsw.SEARCHES["search"] == 1 and ivf.SEARCHES["search"] == 1

    # binary codes + "pallas": the popcount slot scan's plain version
    device.EXACT_SCAN_THRESHOLD = 256
    slot_scan.SLOTS, binary_scan.BINARY_BLOCK_N = 256, 512
    v = rng.standard_normal((1500, 128)).astype(np.float32)
    cfg = VectorConfig(dimension=128, quantization="binary", flags=["pallas"])
    with tempfile.TemporaryDirectory() as d:
        meta = create_segment(d + "/s", [Elem(key=f"r/{i:04d}", vectors=v[i]) for i in range(1500)], cfg)
        searcher = VectorSearcher(cfg, SimpleOpenIndex(segment_list=[(meta, Seq(1))]), device="cpu")
        calls = []
        real = binary_scan.binary_scan_slots
        binary_scan.binary_scan_slots = lambda *a, **k: calls.append(1) or real(*a, **k)
        hits = searcher.search(VectorSearchRequest(vectors=v[[7, 900]], top_k=3))
    assert isinstance(searcher.index.codes, quant.BinaryCodes) and calls == [1], calls
    assert [h[0].key for h in hits] == ["r/0007", "r/0900"], hits

    # the keyword leg: segments from the port's builder, both searchers,
    # a device-route batch (the host tier off) and the default route
    import os
    from nucliadb_tpu_torch.index.paragraph import ParagraphSearcher, ParagraphSearchRequest
    from nucliadb_tpu_torch.index.text import DocumentSearchRequest, TextSearcher
    from nucliadb_tpu_torch.index.text_engine import TextQuery
    from nucliadb_tpu_torch.index.text_engine.builder import DocEntry, build_segment
    from nucliadb_tpu_torch.ops import bm25

    words = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot"]
    docs = [DocEntry(key=f"r{i:03d}/t/t/0-9", text=" ".join(rng.choice(words, 6)),
                     facets=["/l/odd"] if i % 2 else [], columns={"created": i}) for i in range(200)]
    with tempfile.TemporaryDirectory() as d:
        idx = SimpleOpenIndex(segment_list=[(build_segment(d + "/p", docs, kind="paragraph"), Seq(1))])
        para = ParagraphSearcher(idx, device="cpu")
        default = para.search(ParagraphSearchRequest(query="alpha bravo", top_k=5))
        os.environ["NDBTPU_TEXT_HOST_TIER"] = "0"
        text = TextSearcher(SimpleOpenIndex(segment_list=[(build_segment(d + "/t", docs, kind="text"), Seq(1))]), device="cpu")
        para.engine._host_tier_cached = None
        out = para.engine.search_batch([TextQuery(text=t, top_k=5) for t in ("alpha", "bravo echo", "delta")])
        assert bm25.DISPATCHES["batch"] == 1 and all(len(h) == 5 for h, _ in out), out
        resp = para.search(ParagraphSearchRequest(query="alpha bravo", top_k=5))
        docs_resp = text.search(DocumentSearchRequest(query="charlie", top_k=3, order_by="created"))
    assert len(resp.hits) == len(default.hits) == 5, (resp, default)
    assert len(docs_resp.hits) == 3 and bm25.DISPATCHES["single"] >= 1, bm25.DISPATCHES

    # the index node: index, merge, sync and a hybrid request
    from nucliadb_tpu_torch.index.json import JsonPredicate
    from nucliadb_tpu_torch.index.relation import GraphSearchRequest, NodePattern
    from nucliadb_tpu_torch.models.internal import (
        IndexParagraph, IndexRelation, RelationNode, ResourceDoc, TextInformation, VectorSentence,
    )
    from nucliadb_tpu_torch.services import EmbeddedNode
    from nucliadb_tpu_torch.shard import ShardSearchRequest
    from nucliadb_tpu_torch.storage import MemoryStorage

    os.environ.pop("NDBTPU_TEXT_HOST_TIER")
    with tempfile.TemporaryDirectory() as d:
        node = EmbeddedNode(d, storage=MemoryStorage(), device="cpu")
        sid = node.create_shard("kb", {"m": VectorConfig(dimension=16)})
        for i in range(5):
            text = " ".join(rng.choice(words, 5))
            rd = ResourceDoc(resource_id=f"r{i}", created=i, modified=i, json_fields={"a/j": '{"n": %d}' % i})
            rd.texts["t/t"] = TextInformation(text=text)
            para = IndexParagraph(start=0, end=len(text))
            para.vectorsets_sentences["m"] = {f"r{i}/t/t/0/0-{len(text)}": VectorSentence(vector=v[i, :16])}
            rd.paragraphs["t/t"] = {f"r{i}/t/t/0-{len(text)}": para}
            rd.relations["t/t"] = [IndexRelation(source=RelationNode(value=f"r{i}"), target=RelationNode(value="x"))]
            node.index(sid, rd)
        assert node.tick_background()["merged"] >= 4
        node.wait_for_sync()
        resp = node.search(sid, ShardSearchRequest(
            body=text, vector=v[4, :16], top_k=3, document=True,
            json_filter=JsonPredicate(path="n", op="gte", value=2),
            graph=GraphSearchRequest(source=NodePattern(value="r4")),
        ))
    assert resp.vector[0].key.startswith("r4/") and resp.paragraph.hits and resp.document.hits, resp
    assert len(resp.graph) == 1 and {h.rid for h in resp.paragraph.hits} <= {"r2", "r3", "r4"}, resp

    # the product layer: a knowledge box through the Processor, one /find
    from nucliadb_tpu_torch.common.kb import KnowledgeBoxManager
    from nucliadb_tpu_torch.ingest import Processor
    from nucliadb_tpu_torch.maindb import Driver
    from nucliadb_tpu_torch.models.api import (
        CreateResourcePayload, FindRequest, KnowledgeBoxConfig, SentenceEmbedding, TextFieldPayload, VectorSetSpec,
    )
    from nucliadb_tpu_torch.search import SearchService

    with tempfile.TemporaryDirectory() as d:
        node = EmbeddedNode(d + "/node", storage=MemoryStorage(), device="cpu")
        driver = Driver(d + "/kv.db")
        kbs = KnowledgeBoxManager(driver, node)
        processor = Processor(driver, node, kbs)
        kbid = kbs.create(KnowledgeBoxConfig(slug="kb", vectorsets={"m": VectorSetSpec(dimension=16)}))
        rids = []
        for i in range(4):
            body = " ".join(rng.choice(words, 5))
            emb = SentenceEmbedding(start=0, end=len(body), vector=v[i, :16].tolist())
            rids.append(processor.create_resource(kbid, CreateResourcePayload(
                title=f"doc {i}", texts={"body": TextFieldPayload(body=body)}, embeddings={"m": {"body": [emb]}},
            ))[0])
        node.wait_for_sync()
        found = SearchService(node, kbs, processor).find(kbid, FindRequest(query=body, vector=v[3, :16].tolist(), top_k=4))
    assert found.best_matches[0].startswith(rids[3]) and found.resources[rids[3]].title == "doc 3", found

    # the mesh: a sharded index and a hybrid index on 4 members repeating
    # the CPU, a vector group and search_multi's mesh branch with the
    # device listing replaced (one CPU does not turn mesh serving on)
    import torch
    from nucliadb_tpu_torch.parallel import MeshHybridIndex, MeshShardedVectorIndex, make_mesh
    from nucliadb_tpu_torch.parallel import group as pgroup, mesh as pmesh

    mesh = make_mesh(4, device="cpu")
    vs = rng.standard_normal((200, 16)).astype(np.float32)
    vs /= np.linalg.norm(vs, axis=1, keepdims=True)
    s_, i_ = MeshShardedVectorIndex(vs, mesh, quantize=True).search(vs[[5, 150]], 3)
    assert i_[:, 0].tolist() == [5, 150], i_
    assert not pgroup.mesh_serving_active("cpu")
    with tempfile.TemporaryDirectory() as d:
        from nucliadb_tpu_torch.index.text_engine.engine import DeviceTextEngine
        from nucliadb_tpu_torch.index.text_engine.builder import open_text_segment
        shards = []
        for s in range(4):
            seg = build_segment(f"{d}/h{s}", docs[s * 10 : (s + 1) * 10], kind="text")
            shards.append((vs[s * 10 : (s + 1) * 10], DeviceTextEngine([(open_text_segment(seg.path), Seq(1))], device="cpu")))
        fs, fi = MeshHybridIndex(shards, mesh).search(vs[[12]], TextQuery(text="alpha", top_k=4), 4)
    assert fs.shape == (1, 4) and (fi >= 0).any(), fi
    pmesh.visible_devices = lambda device="cuda": [torch.device("cpu")] * 2
    assert pgroup.mesh_serving_active("cpu")
    with tempfile.TemporaryDirectory() as d:
        node = EmbeddedNode(d, storage=MemoryStorage(), device="cpu")
        sids = [node.create_shard("kb", {"m": VectorConfig(dimension=16)}) for _ in range(2)]
        for i in range(6):
            text = " ".join(rng.choice(words, 5))
            rd = ResourceDoc(resource_id=f"r{i}", created=i, modified=i)
            rd.texts["t/t"] = TextInformation(text=text)
            para = IndexParagraph(start=0, end=len(text))
            para.vectorsets_sentences["m"] = {f"r{i}/t/t/0/0-{len(text)}": VectorSentence(vector=v[i, :16])}
            rd.paragraphs["t/t"] = {f"r{i}/t/t/0-{len(text)}": para}
            node.index(sids[i % 2], rd)
        node.wait_for_sync()
        resps = node.search_multi(sids, ShardSearchRequest(body=text, vector=v[5, :16], top_k=3))
        assert len(node.searcher._mesh_groups) == 1
    assert resps[1].vector[0].key.startswith("r5/"), resps
    _no_jax_loaded()
    print("OK")
    """
)

_NO_JAX = textwrap.dedent(
    """
    import sys

    def _no_jax_loaded():
        loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
        assert not loaded, loaded
        # the JAX package neither: nucliadb_tpu_torch* and nucliadb_tpu_native are allowed
        loaded = sorted(m for m in sys.modules if m == "nucliadb_tpu" or m.startswith("nucliadb_tpu."))
        assert not loaded, loaded
    """
)

# the standalone server: boot on the CPU, serve one /find over HTTP
_SERVER_SCRIPT = textwrap.dedent(
    """
    import asyncio, tempfile, threading
    import httpx
    import numpy as np
    from nucliadb_tpu_torch.standalone import StandaloneApp

    with tempfile.TemporaryDirectory() as d:
        app = StandaloneApp(data_dir=d, host="127.0.0.1", port=0, device="cpu")
        app.start_background(3600.0)
        app._warmup_thread.join(60)
        assert app.warmup_seconds is not None
        loop = asyncio.new_event_loop()
        started = threading.Event()

        def run():
            asyncio.set_event_loop(loop)
            loop.run_until_complete(app.server.start())
            started.set()
            loop.run_forever()

        threading.Thread(target=run, daemon=True).start()
        assert started.wait(30)
        v = np.random.default_rng(0).standard_normal(16)
        with httpx.Client(base_url=f"http://127.0.0.1:{app.server.port}", timeout=60) as client:
            kbid = client.post("/api/v1/kbs", json={"slug": "kb", "vectorsets": {"m": {"dimension": 16}}}).json()["uuid"]
            body = "the quick brown fox"
            rid = client.post(f"/api/v1/kb/{kbid}/resources", json={
                "title": "fox", "texts": {"t": {"body": body}},
                "embeddings": {"m": {"t": [{"start": 0, "end": len(body), "vector": v.tolist()}]}},
            }).json()["uuid"]
            app._sync(force=True)
            found = client.post(f"/api/v1/kb/{kbid}/find", json={"query": "quick fox", "vector": v.tolist()})
        loop.call_soon_threadsafe(loop.stop)
        app.stop_background()
    assert found.status_code == 200 and rid in found.json()["resources"], found.text
    _no_jax_loaded()
    print("OK")
    """
)


# component mode: a substrate process and a writer/ingest/searcher process
# of the port (each reports the modules it loaded when it is terminated),
# a write through the writer plane, a search scattered over the node plane
_CLUSTER_SCRIPT = textwrap.dedent(
    """
    import socket, subprocess, sys, tempfile, time
    from nucliadb_tpu_torch.cluster import DistributedSearcher, ShardSelector
    from nucliadb_tpu_torch.grpc_plane import NodeClient, WriterClient
    from nucliadb_tpu_torch.shard import ShardSearchRequest
    import nucliadb_tpu_torch.component.control, nucliadb_tpu_torch.grpc_plane.proto_compat

    CHILD = (
        "import os, signal, sys\\n"
        "def stop(*_):\\n"
        "    loaded = sorted(m for m in sys.modules if m in ('jax', 'nucliadb_tpu')\\n"
        "                    or m.startswith(('jax.', 'jaxlib', 'nucliadb_tpu.')))\\n"
        "    print('loaded: %r' % loaded, flush=True)\\n"
        "    os._exit(0)\\n"
        "signal.signal(signal.SIGTERM, stop)\\n"
        "sys.argv = ['run', *sys.argv[1:]]\\n"
        "from nucliadb_tpu_torch.component.run import main\\n"
        "main()\\n"
    )

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def wait_port(port, proc):
        for _ in range(300):
            assert proc.poll() is None, proc.stdout.read()
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1).close()
                return
            except OSError:
                time.sleep(0.2)
        raise AssertionError(port)

    def child(*args):
        return subprocess.Popen([sys.executable, "-c", CHILD, *args], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    sub, writer, search = free_port(), free_port(), free_port()
    with tempfile.TemporaryDirectory() as d:
        procs = [child("substrate", "--serve-substrate", f"127.0.0.1:{sub}", "--data-dir", d + "/s")]
        try:
            wait_port(sub, procs[0])
            procs.append(child("writer", "ingest", "searcher", "--substrate", f"127.0.0.1:{sub}", "--device", "cpu",
                               "--data-dir", d + "/w", "--writer-address", f"127.0.0.1:{writer}",
                               "--grpc-address", f"127.0.0.1:{search}"))
            wait_port(search, procs[1])
            client = WriterClient(f"127.0.0.1:{writer}", timeout=120)
            kbid = client.new_kb({"slug": "kb"})
            rid = client.process_message(kbid, "create", payload={
                "title": "t", "texts": {"body": {"body": "distributed quantum flux search"}}})["rid"]
            node = NodeClient(f"127.0.0.1:{search}", timeout=120)
            sid = node.list_shards(kbid)[0]["id"]
            cluster = DistributedSearcher({"c": node}, ShardSelector(["c"], replication=1), strict=True)
            for _ in range(240):
                resp, errors = cluster.search([sid], ShardSearchRequest(body="quantum flux", top_k=3))
                if resp.paragraph.hits:
                    break
                time.sleep(0.5)
            assert resp.paragraph.hits[0].rid == rid and errors == [], resp
        finally:
            for proc in procs:
                proc.terminate()
            outs = [proc.communicate(timeout=60)[0] for proc in procs]
    for out in outs:
        assert "loaded: []" in out, out
    _no_jax_loaded()
    print("OK")
    """
)


def _fresh_interpreter(script):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX + script], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_port_imports_no_jax():
    _fresh_interpreter(_SCRIPT)


def test_port_server_imports_no_jax():
    _fresh_interpreter(_SERVER_SCRIPT)


# "import nucliadb_tpu", "from nucliadb_tpu.x import", "import nucliadb_tpu.x as y",
# but not nucliadb_tpu_torch or nucliadb_tpu_native
_JAX_PACKAGE_IMPORT = re.compile(r"^\s*(?:import|from)\s+nucliadb_tpu(?:\.|\s|,|$)", re.M)


def test_port_component_processes_import_no_jax():
    _fresh_interpreter(_CLUSTER_SCRIPT)


def test_port_sources_name_no_jax_package_import():
    sources = sorted((Path(REPO) / "nucliadb_tpu_torch").rglob("*.py"))
    sources.append(Path(REPO) / "chip_smoke.py")
    names = {str(path.relative_to(REPO)) for path in sources}
    assert len(sources) > 40 and {
        "nucliadb_tpu_torch/services/binding.py", "nucliadb_tpu_torch/shard/searcher.py",
        "nucliadb_tpu_torch/index/relation/__init__.py", "nucliadb_tpu_torch/telemetry/metrics.py",
        "nucliadb_tpu_torch/search/find.py", "nucliadb_tpu_torch/common/kb.py", "nucliadb_tpu_torch/ingest/consumer.py",
        "nucliadb_tpu_torch/maindb/driver.py", "nucliadb_tpu_torch/models/api.py",
        "nucliadb_tpu_torch/standalone/app.py", "nucliadb_tpu_torch/standalone/run.py",
        "nucliadb_tpu_torch/standalone/workers.py", "nucliadb_tpu_torch/http/server.py",
        "nucliadb_tpu_torch/migrator/migrations.py", "nucliadb_tpu_torch/train/dataset.py",
        "nucliadb_tpu_torch/common/export_import.py", "nucliadb_tpu_torch/utils/warmup.py",
        "nucliadb_tpu_torch/ops/hnsw.py", "nucliadb_tpu_torch/ops/ivf.py",
        "nucliadb_tpu_torch/tools/hnsw_build_bench.py", "nucliadb_tpu_torch/ops/fusion.py",
        "nucliadb_tpu_torch/parallel/__init__.py", "nucliadb_tpu_torch/parallel/mesh.py",
        "nucliadb_tpu_torch/parallel/group.py", "nucliadb_tpu_torch/parallel/text_group.py",
        "nucliadb_tpu_torch/parallel/text_mesh.py", "nucliadb_tpu_torch/parallel/hybrid_mesh.py",
        "nucliadb_tpu_torch/grpc_plane/codec.py", "nucliadb_tpu_torch/grpc_plane/proto_translate.py",
        "nucliadb_tpu_torch/grpc_plane/proto_compat.py", "nucliadb_tpu_torch/grpc_plane/server.py",
        "nucliadb_tpu_torch/cluster/distributed.py", "nucliadb_tpu_torch/cluster/topology.py",
        "nucliadb_tpu_torch/substrate/__init__.py", "nucliadb_tpu_torch/component/run.py",
    } <= names
    offending = [
        f"{path.relative_to(REPO)}:{text[:m.start()].count(chr(10)) + 1}"
        for path in sources
        for text in [path.read_text()]
        for m in _JAX_PACKAGE_IMPORT.finditer(text)
    ]
    assert not offending, offending
    assert _JAX_PACKAGE_IMPORT.search("from nucliadb_tpu.types import Seq")
    assert _JAX_PACKAGE_IMPORT.search("    import nucliadb_tpu")
    assert not _JAX_PACKAGE_IMPORT.search("from nucliadb_tpu_torch.types import Seq")
    assert not _JAX_PACKAGE_IMPORT.search("import nucliadb_tpu_native")


def test_cuda_request_without_a_card_raises(tmp_path):
    from nucliadb_tpu_torch.types import Seq, SimpleOpenIndex
    from nucliadb_tpu_torch.index.vector import Elem, VectorConfig, VectorSearcher, create_segment
    from nucliadb_tpu_torch.utils.platform import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a card is present: a cuda index is valid here")
    cfg = VectorConfig(dimension=8)
    v = np.ones((1, 8), np.float32)
    meta = create_segment(str(tmp_path / "s"), [Elem(key="r/0", vectors=v)], cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        VectorSearcher(cfg, SimpleOpenIndex(segment_list=[(meta, Seq(1))]), device="cuda")
    for flag in ("hnsw", "ivf"):  # the graph and the centroids build on the card, never quietly here
        with pytest.raises(RuntimeError, match="cuda"):
            create_segment(str(tmp_path / flag), [Elem(key="r/0", vectors=v)], VectorConfig(dimension=8, flags=[flag]))
    from nucliadb_tpu_torch.index.paragraph import ParagraphSearcher
    from nucliadb_tpu_torch.index.text_engine.builder import DocEntry, build_segment

    para = build_segment(str(tmp_path / "p"), [DocEntry(key="r/0", text="alpha")], kind="paragraph")
    with pytest.raises(RuntimeError, match="cuda"):
        ParagraphSearcher(SimpleOpenIndex(segment_list=[(para, Seq(1))]), device="cuda")
    from nucliadb_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="cuda"):  # a mesh of cards, never quietly of the CPU
        make_mesh(4)
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
