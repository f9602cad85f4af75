"""The port never imports jax or the JAX package, and never moves a CUDA
request to the CPU: its vector and keyword legs, its index node and its
product layer's /find.

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
    loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
    assert not loaded, loaded
    # the JAX package neither: nucliadb_tpu_torch* and nucliadb_tpu_native are allowed
    loaded = sorted(m for m in sys.modules if m == "nucliadb_tpu" or m.startswith("nucliadb_tpu."))
    assert not loaded, loaded
    print("OK")
    """
)


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


# "import nucliadb_tpu", "from nucliadb_tpu.x import", "import nucliadb_tpu.x as y",
# but not nucliadb_tpu_torch or nucliadb_tpu_native
_JAX_PACKAGE_IMPORT = re.compile(r"^\s*(?:import|from)\s+nucliadb_tpu(?:\.|\s|,|$)", re.M)


def test_port_sources_name_no_jax_package_import():
    sources = sorted((Path(REPO) / "nucliadb_tpu_torch").rglob("*.py"))
    sources.append(Path(REPO) / "chip_smoke.py")
    names = {str(path.relative_to(REPO)) for path in sources}
    assert len(sources) > 40 and {
        "nucliadb_tpu_torch/services/binding.py", "nucliadb_tpu_torch/shard/searcher.py",
        "nucliadb_tpu_torch/index/relation/__init__.py", "nucliadb_tpu_torch/telemetry/metrics.py",
        "nucliadb_tpu_torch/search/find.py", "nucliadb_tpu_torch/common/kb.py", "nucliadb_tpu_torch/ingest/consumer.py",
        "nucliadb_tpu_torch/maindb/driver.py", "nucliadb_tpu_torch/models/api.py",
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
    from nucliadb_tpu_torch.index.paragraph import ParagraphSearcher
    from nucliadb_tpu_torch.index.text_engine.builder import DocEntry, build_segment

    para = build_segment(str(tmp_path / "p"), [DocEntry(key="r/0", text="alpha")], kind="paragraph")
    with pytest.raises(RuntimeError, match="cuda"):
        ParagraphSearcher(SimpleOpenIndex(segment_list=[(para, Seq(1))]), device="cuda")
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
