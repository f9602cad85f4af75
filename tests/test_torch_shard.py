"""The port's shard layer against the JAX package's, on the same inputs.

The ``shard`` fixture and the eleven scenarios of ``tests/test_shard.py``:
both packages' ``ShardIndexer`` write their own segments from one set of
resources (the port's from ``as_port`` copies), and each package's
``ShardSearcher`` answers every request, the port's on the CPU. The port
also opens the JAX package's segments. ``ShardSearchResponse`` compares
field by field: vector keys equal and scores within 1e-5; paragraph and
document hits equal up to ties, scores within 1e-5; graph paths and the
prefilter equal.
"""

import numpy as np
import pytest

from nucliadb_tpu.index.json import JsonPredicate
from nucliadb_tpu.index.relation import GraphSearchRequest, NodePattern, RelationPattern
from nucliadb_tpu.index.vector import VectorConfig
from nucliadb_tpu.models.internal import ResourceDoc, TextInformation
from nucliadb_tpu.query_language import LabelAtom
from nucliadb_tpu.shard import ShardConfig, ShardIndexer, ShardSearcher, ShardSearchRequest
from nucliadb_tpu.types import Seq, SimpleOpenIndex

import nucliadb_tpu_torch.shard as port_shard
from nucliadb_tpu_torch.index.text import TextSearcher as PortTextSearcher
from nucliadb_tpu_torch.types import SimpleOpenIndex as PortSimpleOpenIndex

from tests.test_shard import RESOURCES, embed
from tests.torch_test_helpers import as_port, assert_same_response, plain

DIM = 16


def _index(indexer, resources, tmp, seq_cls, oi_cls):
    open_indexes = {}
    for i, r in enumerate(resources):
        for op in indexer.index_resource(r, str(tmp / f"op{i}")):
            oi = open_indexes.setdefault(op.index_name, oi_cls())
            if op.segment is not None:
                oi.segment_list.append((op.segment, seq_cls(i + 1)))
    return open_indexes


def _pair(tmp, config, resources):
    """(JAX searcher, port searcher over its own segments, port searcher
    over the JAX package's segments)."""
    from nucliadb_tpu_torch.types import Seq as PortSeq

    ref_oi = _index(ShardIndexer(config), resources, tmp / "jax", Seq, SimpleOpenIndex)
    port_config = as_port(config)
    port_oi = _index(
        port_shard.ShardIndexer(port_config), as_port(resources), tmp / "port", PortSeq, PortSimpleOpenIndex
    )
    ref = ShardSearcher(config, ref_oi)
    port = port_shard.ShardSearcher(port_config, port_oi, device="cpu")
    cross = port_shard.ShardSearcher(port_config, as_port(ref_oi), device="cpu")
    return ref, port, cross


def _device_route(searchers):
    """The keyword legs on the BM25 device program (the host WAND tier off
    on both sides, as ``NDBTPU_TEXT_HOST_TIER=0`` does)."""
    for s in searchers:
        for leg in (s.text, s.paragraph):
            leg.engine._host_tier_cached = None
    return searchers


@pytest.fixture(scope="module", params=["host_tier", "device_route"])
def shards(tmp_path_factory, request):
    config = ShardConfig(shard_id="s1", kbid="kb1", vectorsets={"model1": VectorConfig(dimension=DIM)})
    searchers = _pair(tmp_path_factory.mktemp("shard"), config, RESOURCES)
    return _device_route(searchers) if request.param == "device_route" else searchers


@pytest.fixture(scope="module")
def dated_shards(tmp_path_factory):
    """tests/test_shard.py:226 — two dated documents, no vectorset."""
    resources = []
    for rid, text, created in (("old", "quick update about markets", 1000), ("new", "another quick update indeed", 5000)):
        rd = ResourceDoc(resource_id=rid, created=created, modified=created)
        rd.texts["t/text1"] = TextInformation(text=text)
        resources.append(rd)
    config = ShardConfig(shard_id="s2", kbid="kb1", vectorsets={})
    return _pair(tmp_path_factory.mktemp("dated"), config, resources)


def _hybrid():
    return [ShardSearchRequest(body="quick fox", vector=embed("the quick brown fox jumps over the lazy dog"), top_k=5)]


def _label_filter():
    return [ShardSearchRequest(body="quick", vector=embed("anything"), filter=LabelAtom("/l/topic/finance"), top_k=5)]


def _security():
    v = embed("the fox entity is a quick animal in markets of fur")
    return [
        ShardSearchRequest(body="fox", vector=v, security_groups=[], top_k=5),
        ShardSearchRequest(body="fox", vector=v, security_groups=["admins"], top_k=5),
    ]


def _json():
    return [
        ShardSearchRequest(body="quick", vector=embed("anything"), json_filter=JsonPredicate(path="price", op="gt", value=40), top_k=5),
        ShardSearchRequest(body="quick", json_filter=JsonPredicate(path="price", op="gt", value=1000), top_k=5),
        # the two prefilters under "or" (satellite of the same planner code)
        ShardSearchRequest(
            body="quick", vector=embed("anything"), security_groups=[], filter_operator="or",
            json_filter=JsonPredicate(path="price", op="gt", value=40), top_k=5,
        ),
    ]


def _graph():
    return [
        ShardSearchRequest(body="", graph=GraphSearchRequest(source=NodePattern(value="fox")), top_k=5),
        ShardSearchRequest(body="", graph=GraphSearchRequest(source=NodePattern(value="foz", fuzzy=True))),
        ShardSearchRequest(body="", graph=GraphSearchRequest(relation=RelationPattern(label="located in"))),
    ]


def _document():
    return [ShardSearchRequest(body="markets", document=True, paragraph=False, top_k=5)]


def _key_filters():
    return [ShardSearchRequest(body="quick", key_filters=["r2/"], top_k=5)]


def _document_json():
    return [ShardSearchRequest(body="quick", document=True, json_filter=JsonPredicate(path="price", op="gt", value=40), top_k=5)]


SCENARIOS = {
    "hybrid_search": _hybrid,
    "label_filter_applies_to_both": _label_filter,
    "security_prefilter_clears_vector": _security,
    "json_prefilter": _json,
    "graph_search": _graph,
    "document_search_via_shard": _document,
    "key_filters": _key_filters,
    "document_leg_respects_json_prefilter": _document_json,
}


@pytest.mark.parametrize("segments", ["own", "jax"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_shard_scenario_matches_jax(shards, scenario, segments):
    ref, port, cross = shards
    searcher = port if segments == "own" else cross
    for req in SCENARIOS[scenario]():
        want = ref.search(req)
        got = searcher.search(as_port(req))
        assert_same_response(got, want)


def test_scenario_assertions_hold_on_the_port(shards):
    """The original scenarios' own assertions, on the port's answers."""
    from nucliadb_tpu_torch.ops import bm25

    _, port, _ = shards
    before = bm25.DISPATCHES.total()
    resp = port.search(as_port(_hybrid()[0]))
    # the fixture's route: the device program serves the keyword leg only
    # with the host tier off
    assert (bm25.DISPATCHES.total() > before) == (port.paragraph.engine.host_tier() is None)
    assert resp.paragraph.hits[0].rid in ("r1", "r3") and resp.vector[0].key.startswith("r1/")
    np.testing.assert_allclose(resp.vector[0].score, 1.0, rtol=1e-3)
    resp = port.search(as_port(_label_filter()[0]))
    assert all(h.rid == "r2" for h in resp.paragraph.hits) and all(h.key.startswith("r2/") for h in resp.vector)
    hidden, shown = (port.search(as_port(r)) for r in _security())
    assert all(h.rid != "r3" for h in hidden.paragraph.hits) and all(not h.key.startswith("r3/") for h in hidden.vector)
    assert any(h.key.startswith("r3/") for h in shown.vector)
    some, none, _ = (port.search(as_port(r)) for r in _json())
    assert {h.rid for h in some.paragraph.hits} <= {"r2", "r3"}
    assert none.prefilter.is_none and none.paragraph is None and none.vector == []
    g1, g2, g3 = (port.search(as_port(r)).graph for r in _graph())
    assert [p.target.value for p in g1] == ["dog"] and len(g2) == 1 and g3[0].source.value == "nasdaq"
    assert {h.rid for h in port.search(as_port(_document()[0])).document.hits} == {"r2", "r3"}
    assert all(h.rid == "r2" for h in port.search(as_port(_key_filters()[0])).paragraph.hits)
    rids = {h.rid for h in port.search(as_port(_document_json()[0])).document.hits}
    assert rids and rids <= {"r2", "r3"}


@pytest.mark.parametrize("segments", ["own", "jax"])
def test_relation_suggest_matches_jax(shards, segments):
    ref, port, cross = shards
    searcher = port if segments == "own" else cross
    for prefix in ("new", "fo", "nasd", "zzz"):
        assert plain(searcher.relation.suggest_nodes(prefix)) == plain(ref.relation.suggest_nodes(prefix))
    assert any(n.value == "new york" for n in searcher.relation.suggest_nodes("new"))


@pytest.mark.parametrize("segments", ["own", "jax"])
def test_document_date_range_and_key_filters_match_jax(dated_shards, segments):
    ref, port, cross = dated_shards
    searcher = port if segments == "own" else cross
    reqs = [
        ShardSearchRequest(body="quick", document=True, paragraph=False, top_k=5, range_creation=(2000, None)),
        ShardSearchRequest(body="quick", document=True, paragraph=False, top_k=5, key_filters=["old/"]),
    ]
    got = [searcher.search(as_port(r)) for r in reqs]
    for g, r in zip(got, reqs):
        assert_same_response(g, ref.search(r))
    assert [{h.rid for h in g.document.hits} for g in got] == [{"new"}, {"old"}]


def test_prefilter_on_empty_text_index_is_none():
    from nucliadb_tpu.index.text import TextSearcher

    ref = TextSearcher(SimpleOpenIndex())
    port = PortTextSearcher(PortSimpleOpenIndex(), device="cpu")
    for kwargs in ({"security_groups": ["admins"]}, {"filter": LabelAtom("/l/x/y")}):
        want = ref.prefilter(**kwargs)
        got = port.prefilter(**as_port(kwargs))
        assert want.is_none and got.is_none and plain(got) == plain(want)


def test_shard_request_as_port_is_the_ports():
    """``as_port`` rebuilds a whole request: nested requests, filters and
    JSON expressions become the port's classes, arrays are kept."""
    req = _json()[0]
    req.graph = GraphSearchRequest(source=NodePattern(value="fox"))
    got = as_port(req)
    assert type(got) is port_shard.ShardSearchRequest
    assert type(got.json_filter).__module__ == "nucliadb_tpu_torch.index.json"
    assert type(got.graph.source).__module__ == "nucliadb_tpu_torch.index.relation"
    assert got.vector is req.vector
    doc = as_port(RESOURCES[0])
    assert type(doc).__module__ == "nucliadb_tpu_torch.models.internal"
    para = next(iter(doc.paragraphs["t/text1"].values()))
    assert type(next(iter(para.vectorsets_sentences["model1"].values()))).__module__ == doc.__module__
    assert plain(doc) == plain(RESOURCES[0])
