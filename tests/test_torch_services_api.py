"""The scenarios of ``tests/test_services_api.py`` on the port: the port's product services over a CPU node."""

import numpy as np
import pytest

from nucliadb_tpu_torch.common.external_index import (
    InMemoryExternalIndex,
    get_provider,
)
from nucliadb_tpu_torch.common.kb import KnowledgeBoxManager
from nucliadb_tpu_torch.common.kb_services import SynonymsService
from nucliadb_tpu_torch.ingest.processor import Processor
from nucliadb_tpu_torch.learning_proxy import LearningProxy
from nucliadb_tpu_torch.maindb import Driver
from nucliadb_tpu_torch.models.api import (
    CreateResourcePayload,
    FindRequest,
    KnowledgeBoxConfig,
    SearchFeature,
    TextFieldPayload,
)
from nucliadb_tpu_torch.models.internal import IndexParagraph, ResourceDoc, TextInformation, VectorSentence
from nucliadb_tpu_torch.search import SearchService
from nucliadb_tpu_torch.search.augmentor import AugmentOp, AugmentRequest, Augmentor
from nucliadb_tpu_torch.services import EmbeddedNode
from nucliadb_tpu_torch.settings import Settings, from_env
from nucliadb_tpu_torch.storage import MemoryStorage


@pytest.fixture
def stack(tmp_path):
    node = EmbeddedNode(device="cpu", data_dir=str(tmp_path / "n"), storage=MemoryStorage())
    driver = Driver(str(tmp_path / "kv.db"))
    kbs = KnowledgeBoxManager(driver, node)
    processor = Processor(driver, node, kbs)
    search = SearchService(node, kbs, processor)
    kbid = kbs.create(KnowledgeBoxConfig(slug="svc"))
    processor.create_resource(
        kbid,
        CreateResourcePayload(
            title="Car doc",
            texts={"t": TextFieldPayload(body="the automobile is fast.\n\nIt has wheels.")},
        ),
    )
    node.wait_for_sync()
    return node, driver, kbs, processor, search, kbid


def test_synonyms_expand_query(stack):
    node, driver, kbs, processor, search, kbid = stack
    syn = SynonymsService(driver)
    syn.set_synonyms(kbid, {"car": ["automobile", "vehicle"]})
    # with synonyms the query must match via "automobile"
    res2 = search.find(
        kbid,
        FindRequest(query="car", features=[SearchFeature.KEYWORD], with_synonyms=True),
    )
    assert len(res2.resources) == 1


def test_learning_proxy_config(stack):
    node, driver, kbs, processor, search, kbid = stack
    lp = LearningProxy(driver)
    assert lp.get_configuration(kbid) == {}
    lp.set_configuration(kbid, {"semantic_model": "model1"})
    lp.set_configuration(kbid, {"generative_model": "g"})
    assert lp.get_configuration(kbid) == {
        "semantic_model": "model1",
        "generative_model": "g",
    }
    lp.delete_configuration(kbid)
    assert lp.get_configuration(kbid) == {}


def test_augmentor(stack):
    node, driver, kbs, processor, search, kbid = stack
    rid = processor.list_resources(kbid)[0]
    aug = Augmentor(processor)
    resp = aug.augment(
        kbid,
        AugmentRequest(
            operations=[
                AugmentOp(op="resource", rid=rid),
                AugmentOp(op="field", rid=rid, field_id="t/t"),
                AugmentOp(op="paragraph", paragraph_id=f"{rid}/t/t/0-23"),
                AugmentOp(op="neighbours", paragraph_id=f"{rid}/t/t/0-23", after=1),
                AugmentOp(op="resource", rid="missing"),
            ]
        ),
    )
    assert resp.blocks[0].title == "Car doc"
    assert "automobile" in resp.blocks[1].text
    assert resp.blocks[2].text == "the automobile is fast."
    assert "wheels" in resp.blocks[3].text  # neighbour included
    assert resp.blocks[4].error == "not found"


def test_external_index_provider():
    cls = get_provider("memory")
    idx = cls()
    doc = ResourceDoc(resource_id="r1")
    doc.texts["t/t"] = TextInformation(text="x")
    para = IndexParagraph(start=0, end=1)
    para.vectorsets_sentences["vs"] = {
        "r1/t/t/0/0-1": VectorSentence(vector=np.array([1.0, 0.0], np.float32))
    }
    doc.paragraphs["t/t"] = {"r1/t/t/0-1": para}
    doc.labels = ["/l/a/b"]
    idx.index_resource(doc, "vs")
    hits = idx.query(np.array([1.0, 0.0], np.float32), 5)
    assert hits[0].key == "r1/t/t/0/0-1"
    assert idx.query(np.array([1.0, 0.0], np.float32), 5, filter_labels=["/l/x/y"]) == []
    idx.delete_resource("r1")
    assert idx.query(np.array([1.0, 0.0], np.float32), 5) == []
    with pytest.raises(KeyError):
        get_provider("nope")


def test_settings_from_env():
    s = from_env(
        {
            "NDBTPU_DATA_DIR": "/tmp/x",
            "NDBTPU_SCHEDULER__VECTOR_MAX_SEGMENT": "100000",
            "NDBTPU_HTTP__PORT": "9999",
            "NDBTPU_FLAGS": "hnsw,debug",
            "UNRELATED": "1",
        }
    )
    assert s.data_dir == "/tmp/x"
    assert s.scheduler.vector_max_segment == 100000
    assert s.scheduler.min_segments_to_merge == 4  # default preserved
    assert s.http.port == 9999
    assert s.has_flag("hnsw") and not s.has_flag("nope")


def test_external_index_end_to_end(tmp_path):
    """A KB with external_index_provider routes vectors to the provider at
    ingest (node vector index stays empty) and serves the semantic find leg
    from it (parity: the external-index route in Processor + find)."""
    import numpy as np

    from nucliadb_tpu_torch.common.kb import KnowledgeBoxManager
    from nucliadb_tpu_torch.ingest.processor import Processor
    from nucliadb_tpu_torch.maindb import Driver
    from nucliadb_tpu_torch.models.api import (
        CreateResourcePayload,
        FindRequest,
        KnowledgeBoxConfig,
        SearchFeature,
        SentenceEmbedding,
        TextFieldPayload,
        VectorSetSpec,
    )
    from nucliadb_tpu_torch.search import SearchService
    from nucliadb_tpu_torch.services import EmbeddedNode
    from nucliadb_tpu_torch.storage import MemoryStorage

    dim = 8
    node = EmbeddedNode(device="cpu", data_dir=str(tmp_path / "node"), storage=MemoryStorage())
    driver = Driver(str(tmp_path / "kv.db"))
    kbs = KnowledgeBoxManager(driver, node)
    processor = Processor(driver, node, kbs)
    search = SearchService(node, kbs, processor)
    kbid = kbs.create(
        KnowledgeBoxConfig(
            slug="extkb",
            vectorsets={"vs": VectorSetSpec(dimension=dim)},
            external_index_provider={"type": "memory"},
        )
    )

    def unit(i):
        v = np.zeros(dim, np.float32)
        v[i] = 1.0
        return v.tolist()

    rids = []
    for i, text in enumerate(["alpha doc body", "beta doc body"]):
        rid, _ = processor.create_resource(
            kbid,
            CreateResourcePayload(
                title=f"D{i}",
                texts={"t": TextFieldPayload(body=text)},
                embeddings={
                    "vs": {"t": [SentenceEmbedding(start=0, end=len(text), vector=unit(i))]}
                },
            ),
        )
        rids.append(rid)
    node.wait_for_sync()

    # vectors never reached the node's vector index
    ext = kbs.external_index(kbid)
    assert ext is not None and len(ext._vectors) == 2
    shard = kbs.get_shards(kbid).shards[0]
    stats = node.shard_stats(shard) if hasattr(node, "shard_stats") else None
    resp = node.search(
        shard,
        __import__("nucliadb_tpu_torch.shard", fromlist=["searcher"]).searcher.ShardSearchRequest(
            body="", vector=np.asarray(unit(0)), vectorset="vs", top_k=5
        ),
    )
    assert resp.vector == []

    # semantic find leg served from the provider
    res = search.find(
        kbid,
        FindRequest(
            query="doc", vector=unit(1), vectorset="vs", top_k=5,
            features=[SearchFeature.SEMANTIC],
        ),
    )
    assert res.best_matches[0].startswith(rids[1])

    # delete drops it from the provider too
    processor.delete_resource(kbid, rids[1])
    assert len(ext._vectors) == 1
    res2 = search.find(
        kbid,
        FindRequest(query="doc", vector=unit(1), vectorset="vs", top_k=5,
                    features=[SearchFeature.SEMANTIC]),
    )
    assert rids[1] not in res2.resources
    assert res2.best_matches and res2.best_matches[0].startswith(rids[0])


def test_external_index_filters_and_updates(tmp_path):
    """Review regressions: the external leg honors filters/security/
    min_score, and updates drop stale vectors from the provider."""
    import numpy as np

    from nucliadb_tpu_torch.common.kb import KnowledgeBoxManager
    from nucliadb_tpu_torch.ingest.processor import Processor
    from nucliadb_tpu_torch.maindb import Driver
    from nucliadb_tpu_torch.models.api import (
        Classification,
        CreateResourcePayload,
        FilterExpression,
        FindRequest,
        KnowledgeBoxConfig,
        ResourceSecurity,
        SearchFeature,
        SentenceEmbedding,
        TextFieldPayload,
        UpdateResourcePayload,
        UserMetadata,
        VectorSetSpec,
    )
    from nucliadb_tpu_torch.search import SearchService
    from nucliadb_tpu_torch.services import EmbeddedNode
    from nucliadb_tpu_torch.storage import MemoryStorage

    dim = 4
    node = EmbeddedNode(device="cpu", data_dir=str(tmp_path / "node"), storage=MemoryStorage())
    driver = Driver(str(tmp_path / "kv.db"))
    kbs = KnowledgeBoxManager(driver, node)
    processor = Processor(driver, node, kbs)
    search = SearchService(node, kbs, processor)
    kbid = kbs.create(
        KnowledgeBoxConfig(
            slug="extf", vectorsets={"vs": VectorSetSpec(dimension=dim)},
            external_index_provider={"type": "memory"},
        )
    )
    v = [1.0, 0.0, 0.0, 0.0]
    mk = lambda i, labels, groups=None: CreateResourcePayload(
        title=f"D{i}",
        texts={"t": TextFieldPayload(body=f"body {i}")},
        usermetadata=UserMetadata(
            classifications=[Classification(labelset=ls, label=l) for ls, l in labels]
        ),
        security=ResourceSecurity(access_groups=groups) if groups else None,
        embeddings={"vs": {"t": [SentenceEmbedding(start=0, end=6, vector=v)]}},
    )
    r_open, _ = processor.create_resource(kbid, mk(0, [("topic", "open")]))
    r_sec, _ = processor.create_resource(kbid, mk(1, [("topic", "sec")], groups=["admins"]))
    node.wait_for_sync()

    base = dict(query="", vector=v, vectorset="vs", top_k=5,
                features=[SearchFeature.SEMANTIC])
    # label filter only matches the open doc
    res = search.find(kbid, FindRequest(
        **base, filter_expression=FilterExpression(literal="/l/topic/open")))
    assert set(res.resources) == {r_open}
    # security: without the group, the secured doc is invisible
    res = search.find(kbid, FindRequest(**base, security_groups=["public"]))
    assert set(res.resources) == {r_open}
    res = search.find(kbid, FindRequest(**base, security_groups=["admins"]))
    assert set(res.resources) == {r_open, r_sec}
    # min_score cut applies to provider scores
    res = search.find(kbid, FindRequest(**base, min_score_semantic=2.0))
    assert res.resources == {}

    # update replaces the doc's vectors (no stale keys linger)
    ext = kbs.external_index(kbid)
    n_before = len(ext._vectors)
    processor.update_resource(
        kbid, r_open,
        UpdateResourcePayload(
            texts={"t": TextFieldPayload(body="new")},
            embeddings={"vs": {"t": [SentenceEmbedding(start=0, end=3, vector=v)]}},
        ),
    )
    assert len(ext._vectors) == n_before  # replaced, not accumulated
    assert not any("0-6" in k and k.startswith(r_open) for k in ext._vectors)
