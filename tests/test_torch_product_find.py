"""The port's product layer against the JAX package's, on the same inputs.

Every scenario of ``tests/test_product_find.py`` (with ``retrieve``, the
graph expressions and the bus consumer of ``tests/test_consumer_predict.py``)
runs on both packages: the JAX package's ``SearchService``,
``KnowledgeBoxManager`` and ``Processor`` over its ``EmbeddedNode``, and the
port's over ``EmbeddedNode(device="cpu")``. The inputs are built once with
the JAX package's models and handed to the port as ``as_port(...)``; every
``uuid.uuid4()`` call that names a shard, a knowledge box or a resource
returns the same sequence on both sides, so kbids, rids and shard ids line
up. Answers compare through ``_norm`` (pydantic
models dumped by alias) with ``assert_plain_close``: ids and order equal,
scores within the helpers' ``RTOL`` (1e-5, f32 BM25 sums taken in another
order). Fields that carry the wall-clock time of the run (``WALL_CLOCK``)
are left out of the comparison.

Then the differential fuzz of ``tests/test_find_differential_fuzz.py`` on
the port against its dict oracle, with the same seeds and each answer equal
to the JAX package's, and knowledge boxes written by one package and
answered by the other over the same sqlite file and node directory.
"""

import dataclasses
import enum
import importlib
import itertools
import logging
import time
import uuid
from types import SimpleNamespace

import numpy as np
import pydantic
import pytest

import nucliadb_tpu.models.api as api
from nucliadb_tpu.index.text_engine.tokenizer import tokenize
from tests.test_find_differential_fuzz import GROUPS, LABELSETS, VOCAB, Oracle
from tests.test_product_find import DIM, embed, payload
from tests.torch_test_helpers import as_port, assert_plain_close

PACKAGES = ("nucliadb_tpu", "nucliadb_tpu_torch")
# keys whose values are time.time() of the run (resource created/modified
# stamps, per-phase timings): they differ between any two runs
WALL_CLOCK = frozenset({"created", "modified", "timings"})


def _pkg(name):
    """One package's product entry points; the port's node on the CPU."""

    def mod(path):
        return importlib.import_module(f"{name}.{path}")

    port = name != "nucliadb_tpu"
    services = mod("services")
    return SimpleNamespace(
        name=name,
        conv=as_port if port else (lambda x: x),
        Driver=mod("maindb").Driver,
        KnowledgeBoxManager=mod("common.kb").KnowledgeBoxManager,
        Processor=mod("ingest.processor").Processor,
        SearchService=mod("search").SearchService,
        brain=mod("ingest.brain"),
        predict=mod("search.predict"),
        metrics=mod("search.metrics"),
        consumer=mod("ingest.consumer"),
        EmbeddedBus=mod("bus").EmbeddedBus,
        MAX_DELIVERIES=mod("bus.stream").MAX_DELIVERIES,
        tracing=mod("telemetry.tracing"),
        MemoryStorage=mod("storage").MemoryStorage,
        node=lambda data_dir, **kw: services.EmbeddedNode(
            data_dir=str(data_dir), **kw, **({"device": "cpu"} if port else {})
        ),
    )


def _norm(obj):
    """Plain data that compares across the packages: pydantic models dumped
    by alias, dataclasses as (class name, fields), enums by name, sets
    sorted; ``WALL_CLOCK`` keys dropped."""
    if isinstance(obj, pydantic.BaseModel):
        return _norm(obj.model_dump(mode="json", by_alias=True))
    if isinstance(obj, enum.Enum):
        return obj.name
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [type(obj).__qualname__, _norm({f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)})]
    if isinstance(obj, dict):
        return {_norm(k): _norm(v) for k, v in obj.items() if k not in WALL_CLOCK}
    if isinstance(obj, (set, frozenset)):
        return sorted(_norm(x) for x in obj)
    if isinstance(obj, (list, tuple)):
        return [_norm(x) for x in obj]
    if isinstance(obj, np.ndarray):
        return _norm(obj.tolist())
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


# the modules that name shards, knowledge boxes and resources by uuid4
UUID_USERS = ("services.binding", "common.kb", "ingest.processor")


@pytest.fixture
def run_both(monkeypatch, tmp_path):
    """``run_both(scenario)`` runs ``scenario(pkg, tmp_dir)`` on the JAX
    package, then on the port, each with the same uuid sequence in
    ``UUID_USERS``, asserts
    the port's ``_norm``ed outputs equal the JAX package's, and returns
    both outputs."""

    runs = itertools.count()

    def run(scenario):
        outs = []
        for name in PACKAGES:
            counter = itertools.count(1)
            same = SimpleNamespace(uuid4=lambda: uuid.UUID(int=next(counter)))
            for module in UUID_USERS:
                monkeypatch.setattr(importlib.import_module(f"{name}.{module}"), "uuid", same)
            d = tmp_path / f"{name}-{next(runs)}"
            d.mkdir()
            outs.append(scenario(_pkg(name), d))
        want, got = outs
        assert_plain_close(_norm(got), _norm(want))
        return outs

    return run


def _raises(exc, fn):
    try:
        fn()
    except exc as e:
        return type(e).__name__
    return None


# ---------------------------------------------------------------------------
# the scenarios of tests/test_product_find.py
# ---------------------------------------------------------------------------


def _stack(pkg, tmp):
    """test_product_find.py's ``stack`` fixture on ``pkg``."""
    node = pkg.node(tmp / "node", storage=pkg.MemoryStorage())
    driver = pkg.Driver(str(tmp / "kv.db"))
    kbs = pkg.KnowledgeBoxManager(driver, node)
    processor = pkg.Processor(driver, node, kbs)
    search = pkg.SearchService(node, kbs, processor)
    kbid = kbs.create(pkg.conv(api.KnowledgeBoxConfig(slug="testkb", vectorsets={"model1": api.VectorSetSpec(dimension=DIM)})))
    rids = {}
    rids["fox"], _ = processor.create_resource(kbid, pkg.conv(payload(
        "Fox doc", "the quick brown fox jumps over the lazy dog", labels=[("topic", "animals")],
        entities=[("fox", "jumps over", "meadow")], slug="fox-doc",
    )))
    rids["fin"], _ = processor.create_resource(kbid, pkg.conv(payload(
        "Finance doc", "stock markets rallied on quick tech gains", labels=[("topic", "finance")],
    )))
    node.wait_for_sync()
    return SimpleNamespace(node=node, driver=driver, kbs=kbs, processor=processor, search=search, kbid=kbid, rids=rids)


def _find(s, pkg, **kw):
    return s.search.find(s.kbid, pkg.conv(api.FindRequest(**kw)))


KEYWORD = [api.SearchFeature.KEYWORD]
FOX_BODY = "the quick brown fox jumps over the lazy dog"


def sc_split_paragraphs(pkg, tmp):
    split = pkg.brain.split_paragraphs
    return [split("a b c"), split("first para\n\nsecond para"), split(""), split("x\n\n\n\ny\n \nz")]


def sc_brain_builder_labels(pkg, tmp):
    p = payload("T", "body", labels=[("topic", "x")], entities=[("a", "knows", "b")])
    return [pkg.brain.ResourceBrain("r1").build(pkg.conv(p))]


def sc_find_hybrid(pkg, tmp):
    s = _stack(pkg, tmp)
    return [s.rids, _find(s, pkg, query="quick fox", vector=embed(FOX_BODY), top_k=5)]


def sc_find_filter(pkg, tmp):
    s = _stack(pkg, tmp)
    return [_find(s, pkg, query="quick", features=KEYWORD, top_k=5,
                  filter_expression=api.FilterExpression(literal="/l/topic/finance"))]


def sc_find_relations_feature(pkg, tmp):
    s = _stack(pkg, tmp)
    return [_find(s, pkg, query="fox news", features=[api.SearchFeature.KEYWORD, api.SearchFeature.RELATIONS], top_k=5)]


def sc_resource_update_and_find(pkg, tmp):
    s = _stack(pkg, tmp)
    p = payload("Wolf doc", "a silent grey wolf watches")
    s.processor.update_resource(s.kbid, s.rids["fox"], pkg.conv(api.UpdateResourcePayload(**p.model_dump())))
    s.node.wait_for_sync()
    return [_find(s, pkg, query="fox", features=KEYWORD), _find(s, pkg, query="wolf", features=KEYWORD)]


def sc_resource_delete(pkg, tmp):
    s = _stack(pkg, tmp)
    s.processor.delete_resource(s.kbid, s.rids["fin"])
    s.node.wait_for_sync()
    return [_find(s, pkg, query="markets", features=KEYWORD), s.processor.get_payload(s.kbid, s.rids["fin"])]


def sc_suggest(pkg, tmp):
    s = _stack(pkg, tmp)
    return [s.search.suggest(s.kbid, pkg.conv(api.SuggestRequest(query="qui"))),
            s.search.suggest(s.kbid, pkg.conv(api.SuggestRequest(query="fo", features=["entities"])))]


def sc_catalog(pkg, tmp):
    s = _stack(pkg, tmp)
    return [s.search.catalog(s.kbid, pkg.conv(api.CatalogRequest(faceted=["/l/topic"]))),
            s.search.catalog(s.kbid, pkg.conv(api.CatalogRequest(
                filter_expression=api.FilterExpression(literal="/l/topic/finance"))))]


def sc_graph_endpoint(pkg, tmp):
    s = _stack(pkg, tmp)
    return [s.search.graph(s.kbid, pkg.conv(api.GraphSearchPayload(source_value="fox"))),
            s.search.graph_relations_expr(s.kbid, {"prop": "relation", "label": "jumps over"}, top_k=10)]


def sc_ask_without_generative(pkg, tmp):
    s = _stack(pkg, tmp)
    return [s.search.ask(s.kbid, pkg.conv(api.AskRequest(query="quick fox", vector=embed(FOX_BODY))))]


def sc_kb_lifecycle(pkg, tmp):
    node = pkg.node(tmp / "n", storage=pkg.MemoryStorage())
    kbs = pkg.KnowledgeBoxManager(pkg.Driver(str(tmp / "kv2.db")), node)
    kbid = kbs.create(pkg.conv(api.KnowledgeBoxConfig(slug="kb-a")))
    out = [kbid, kbs.resolve_slug("kb-a"), kbs.list_kbs(), kbs.get_config(kbid),
           _raises(KeyError, lambda: kbs.create(pkg.conv(api.KnowledgeBoxConfig(slug="kb-a"))))]
    kbs.delete(kbid)
    return out + [kbs.resolve_slug("kb-a"), kbs.list_kbs()]


def sc_slug_resolution(pkg, tmp):
    s = _stack(pkg, tmp)
    return [s.processor.resolve_slug(s.kbid, "fox-doc"), s.processor.resolve_slug(s.kbid, "none"),
            s.processor.list_resources(s.kbid), s.processor.get_payload(s.kbid, s.rids["fox"])]


def sc_find_highlight_and_offset(pkg, tmp):
    s = _stack(pkg, tmp)
    return [_find(s, pkg, query="quick fox", features=KEYWORD, highlight=True),
            _find(s, pkg, query="quick", features=KEYWORD, top_k=10),
            _find(s, pkg, query="quick", features=KEYWORD, top_k=1, offset=1)]


def sc_find_search_after_cursor(pkg, tmp):
    s = _stack(pkg, tmp)
    page1 = _find(s, pkg, query="quick", features=KEYWORD, top_k=1)
    return [page1, _find(s, pkg, query="quick", features=KEYWORD, top_k=1, search_after=page1.next_cursor),
            _raises(ValueError, lambda: _find(s, pkg, query="quick", features=KEYWORD, search_after="garbage!"))]


def sc_find_phase_metrics(pkg, tmp):
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    log = logging.getLogger("nucliadb_tpu.search.slow")
    log.addHandler(handler)
    try:
        metrics = pkg.metrics.Metrics()
        with metrics.time("retrieval"):
            pass
        with metrics.time("fusion"):
            pass
        keys = sorted(metrics.to_dict())
        metrics.log_if_slow("find", "kbid=x")
        quiet = len(records)
        metrics.phases["retrieval"] = 1.5
        metrics.log_if_slow("find", "kbid=x")
    finally:
        log.removeHandler(handler)
    return [keys, quiet, ["slow find query" in r.getMessage() for r in records]]


def sc_ask_rag_strategies_and_history(pkg, tmp):
    s = _stack(pkg, tmp)

    def ask(**kw):
        return s.search.ask(s.kbid, pkg.conv(api.AskRequest(**kw)))

    return [ask(query="fox", top_k=3), ask(query="fox", citations=False),
            ask(query="fox", rag_strategies=["full_resource"]),
            ask(query="fox", rag_strategies=["neighbouring_paragraphs"]),
            ask(query="irrelevantquerywithnomatches",
                chat_history=[api.ChatContextMessage(author="USER", text="earlier q")],
                extra_context=["caller supplied grounding"])]


def sc_date_range_filters(pkg, tmp):
    s = _stack(pkg, tmp)
    common = importlib.import_module(f"{pkg.name}.common.kb")
    cutoff = time.time() + 1
    late_rid, _ = s.processor.create_resource(s.kbid, pkg.conv(payload("Late doc", "the quick late arrival", slug="late")))
    meta = s.processor.get_meta(s.kbid, late_rid)
    meta.created = cutoff + 100
    with s.processor.driver as txn:
        txn.set(common.RESOURCE_META.format(kbid=s.kbid, rid=late_rid), meta.to_json())
    s.processor.update_resource(s.kbid, late_rid, pkg.conv(api.UpdateResourcePayload()))
    s.node.wait_for_sync()
    import datetime

    iso = datetime.datetime.fromtimestamp(cutoff, datetime.timezone.utc).isoformat()
    return [late_rid,
            _find(s, pkg, query="quick", features=KEYWORD, range_creation_start=cutoff),
            _find(s, pkg, query="quick", features=KEYWORD, range_creation_end=cutoff),
            _find(s, pkg, query="quick", features=KEYWORD, range_creation_start=iso),
            s.search.catalog(s.kbid, pkg.conv(api.CatalogRequest(range_creation_start=cutoff)))]


def sc_find_predict_reranker(pkg, tmp):
    node = pkg.node(tmp / "node", storage=pkg.MemoryStorage())
    driver = pkg.Driver(str(tmp / "kv.db"))
    kbs = pkg.KnowledgeBoxManager(driver, node)
    processor = pkg.Processor(driver, node, kbs)
    engine = pkg.predict.LocalPredictEngine(reranker=lambda q, ps: [10.0 if "snail" in p else 0.0 for p in ps])
    search = pkg.SearchService(node, kbs, processor, predict=engine)
    kbid = kbs.create(pkg.conv(api.KnowledgeBoxConfig(slug="rrkb")))
    processor.create_resource(kbid, pkg.conv(payload("Fox", "the quick brown fox jumps high", slug="fox")))
    processor.create_resource(kbid, pkg.conv(payload("Snail", "the quick snail crawls slowly", slug="snail")))
    node.wait_for_sync()
    s = SimpleNamespace(search=search, kbid=kbid)
    return [_find(s, pkg, query="quick", features=KEYWORD, top_k=2),
            _find(s, pkg, query="quick", features=KEYWORD, top_k=2, reranker="predict")]


def sc_find_autofilter(pkg, tmp):
    s = _stack(pkg, tmp)
    s.search.entities.set_group(s.kbid, "person", {"title": "P", "entities": {"fox": {"value": "fox"}}})
    return [_find(s, pkg, query="quick fox", features=KEYWORD, autofilter=True),
            _find(s, pkg, query="quick", features=KEYWORD)]


def sc_ask_rephrase_with_history(pkg, tmp):
    s = _stack(pkg, tmp)
    engine = pkg.predict.LocalPredictEngine(encoder=pkg.predict.HashingEncoder(dimension=DIM))
    search = pkg.SearchService(s.node, s.kbs, s.processor, predict=engine)
    return [search.ask(s.kbid, pkg.conv(api.AskRequest(
        query="and the lazy one?",
        chat_history=[api.ChatContextMessage(author="user", text="tell me about the quick brown fox"),
                      api.ChatContextMessage(author="assistant", text="it jumps over the lazy dog")],
    )))]


def sc_find_fulltext_feature(pkg, tmp):
    s = _stack(pkg, tmp)
    return [_find(s, pkg, query="quick", features=[api.SearchFeature.FULLTEXT]),
            _find(s, pkg, query="quick", features=[api.SearchFeature.KEYWORD, api.SearchFeature.FULLTEXT])]


def sc_find_fulltext_sort_and_facets(pkg, tmp):
    s = _stack(pkg, tmp)
    return [_find(s, pkg, query="quick", features=[api.SearchFeature.FULLTEXT], sort_field="created",
                  sort_order="asc", faceted=["/l/topic"]),
            _find(s, pkg, query="quick", features=[api.SearchFeature.FULLTEXT], sort_field="created")]


class NodeEncoder:
    """test_product_find.py's: 'fox'-ish queries land near the fox node."""

    def __call__(self, text):
        t = text.lower()
        v = np.zeros(4, np.float32)
        v[0] = 1.0 if "fox" in t or "vulpine" in t else 0.0
        v[1] = 1.0 if "meadow" in t else 0.0
        v[2] = 0.1
        n = np.linalg.norm(v)
        return v / n if n else v


def sc_graph_semantic_nodes(pkg, tmp):
    s = _stack(pkg, tmp)
    search = pkg.SearchService(s.node, s.kbs, s.processor, predict=pkg.predict.LocalPredictEngine(encoder=NodeEncoder()))
    leaf = {"prop": "node", "value": "vulpine animal", "match": "semantic"}
    return [search.graph(s.kbid, pkg.conv(api.GraphSearchPayload(query="vulpine animal", semantic=True, top_k=10))),
            search.graph(s.kbid, pkg.conv(api.GraphSearchPayload(top_k=10))),
            search.graph_expr(s.kbid, leaf, top_k=10),
            search.graph_nodes_expr(s.kbid, leaf, top_k=10)]


def _echo(pkg, s):
    return pkg.SearchService(s.node, s.kbs, s.processor, predict=pkg.predict.LocalPredictEngine(
        encoder=pkg.predict.HashingEncoder(dimension=DIM), generator=lambda prompt, ctx: "||".join(ctx)))


def sc_ask_strategies_hierarchy_metadata_graph_prequeries(pkg, tmp):
    s = _stack(pkg, tmp)
    strategies = ["hierarchy", "metadata_extension", "graph"]
    pre = [api.PreQuery(request=api.FindRequest(query="markets", features=KEYWORD), weight=2.0)]
    return [s.search.ask(s.kbid, pkg.conv(api.AskRequest(query="quick fox", rag_strategies=strategies, prequeries=pre))),
            _echo(pkg, s).ask(s.kbid, pkg.conv(api.AskRequest(query="quick fox", rag_strategies=strategies)))]


def sc_ask_strategies_field_extension_and_conversation(pkg, tmp):
    s = _stack(pkg, tmp)
    p = payload("Conv doc", "unrelated body text")
    p.conversations = {"chat": api.ConversationFieldPayload(messages=[
        api.ConversationMessage(who=f"u{i}", text=f"message number {i} zebra" if i == 6 else f"message number {i}")
        for i in range(12)
    ])}
    s.processor.create_resource(s.kbid, pkg.conv(p))
    s.node.wait_for_sync()
    echo = _echo(pkg, s)

    def ask(query, strategies):
        return echo.ask(s.kbid, pkg.conv(api.AskRequest(query=query, features=KEYWORD, rag_strategies=strategies)))

    return [ask("quick fox", [{"name": "field_extension", "fields": ["a/title"]}]),
            ask("zebra", [{"name": "conversation", "max_messages": 4}]),
            ask("zebra", [{"name": "conversation", "full": True}]),
            ask("quick fox", [{"name": "neighbouring_paragraphs", "before": 0, "after": 0}]),
            ask("quick", [{"name": "full_resource", "count": 1}])]


def sc_fulltext_offset_and_global_sort(pkg, tmp):
    node = pkg.node(tmp / "node", storage=pkg.MemoryStorage())
    driver = pkg.Driver(str(tmp / "kv.db"))
    kbs = pkg.KnowledgeBoxManager(driver, node)
    processor = pkg.Processor(driver, node, kbs)
    s = SimpleNamespace(search=pkg.SearchService(node, kbs, processor))
    s.kbid = kbs.create(pkg.conv(api.KnowledgeBoxConfig(slug="ftkb", shards=2)))
    rids = [processor.create_resource(s.kbid, pkg.conv(api.CreateResourcePayload(
        title=f"F{i}", texts={"t": api.TextFieldPayload(body=f"shared token doc{i}")})), created=1000.0 + i)[0]
        for i in range(4)]
    node.wait_for_sync()
    kw = dict(query="shared", features=[api.SearchFeature.FULLTEXT], sort_field="created", sort_order="asc", top_k=2)
    return [rids, _find(s, pkg, **kw), _find(s, pkg, offset=2, **kw)]


def sc_retrieve(pkg, tmp):
    """Not in test_product_find.py: /retrieve, hybrid with RRF and keyword
    with weighted fusion, with each match's score history."""
    s = _stack(pkg, tmp)

    def retrieve(**kw):
        return s.search.retrieve(s.kbid, pkg.conv(api.RetrievalRequest(**kw)))

    return [retrieve(query=api.RetrievalQuery(keyword="quick fox", semantic="quick fox", vector=embed(FOX_BODY)), top_k=5),
            retrieve(query=api.RetrievalQuery(keyword="quick"), rank_fusion="weighted", top_k=3),
            retrieve(query=api.RetrievalQuery(keyword="quick"), top_k=3,
                     filter_expression=api.FilterExpression(literal="/l/topic/animals"))]


def sc_find_multivector(pkg, tmp):
    """Not in test_product_find.py: a knowledge box whose vectorset is
    multivector (MaxSim): each paragraph's sentence embeddings become one
    elem keyed by the paragraph; /find sends one query vector (M = 1),
    semantic only and hybrid, with a label filter and a semantic floor."""
    node = pkg.node(tmp / "node", storage=pkg.MemoryStorage())
    driver = pkg.Driver(str(tmp / "kv.db"))
    kbs = pkg.KnowledgeBoxManager(driver, node)
    processor = pkg.Processor(driver, node, kbs)
    search = pkg.SearchService(node, kbs, processor)
    kbid = kbs.create(pkg.conv(api.KnowledgeBoxConfig(
        slug="mvkb", vectorsets={"colbert": api.VectorSetSpec(dimension=DIM, multivector=True)})))
    rng = np.random.default_rng(17)
    rids = []
    for r, (title, topic) in enumerate((("Fox doc", "animals"), ("Finance doc", "finance"), ("Wolf doc", "animals"))):
        paras = [f"{title} paragraph {p} about quick things number {r}" for p in range(3)]
        body = "\n\n".join(paras)
        embs, start = [], 0
        for text in paras:
            for t in range(int(rng.integers(1, 4))):  # 1-3 token vectors a paragraph
                v = rng.standard_normal(DIM).astype(np.float32)
                embs.append(api.SentenceEmbedding(start=start, end=start + len(text), vector=(v / np.linalg.norm(v)).tolist()))
            start += len(text) + 2
        p = payload(title, body, labels=[("topic", topic)])
        p.embeddings = {"colbert": {"text1": embs}}
        rids.append(processor.create_resource(kbid, pkg.conv(p))[0])
    node.wait_for_sync()
    q = embs[0].vector
    sem = [api.SearchFeature.SEMANTIC]
    return [
        rids,
        search.find(kbid, pkg.conv(api.FindRequest(query="", vector=q, vectorset="colbert", features=sem, top_k=5))),
        search.find(kbid, pkg.conv(api.FindRequest(query="quick paragraph", vector=q, vectorset="colbert", top_k=5))),
        search.find(kbid, pkg.conv(api.FindRequest(
            query="", vector=q, vectorset="colbert", features=sem, top_k=5, min_score_semantic=0.0,
            filter_expression=api.FilterExpression(literal="/l/topic/animals")))),
    ]


SCENARIOS = {name[3:]: fn for name, fn in globals().items() if name.startswith("sc_")}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_product_scenario_matches_jax(run_both, scenario):
    run_both(SCENARIOS[scenario])


def test_scenarios_cover_test_product_find():
    import tests.test_product_find as ref

    names = {n[5:] for n in dir(ref) if n.startswith("test_")}
    assert names <= set(SCENARIOS), sorted(names - set(SCENARIOS))


def test_port_answers_hold_test_product_find_assertions(run_both):
    """A few of test_product_find.py's assertions, read on the port's answers."""
    jax_out, port_out = run_both(sc_find_hybrid)
    rids, res = port_out
    assert rids["fox"] in res.resources and res.resources[rids["fox"]].title == "Fox doc"
    assert type(res).__module__ == "nucliadb_tpu_torch.models.api"
    _, cursor = run_both(sc_find_search_after_cursor)
    assert cursor[2] == "ValueError" and cursor[1].best_matches


# ---------------------------------------------------------------------------
# as_port over the pydantic API models
# ---------------------------------------------------------------------------


def test_as_port_rebuilds_api_models_with_the_from_alias():
    import nucliadb_tpu_torch.models.api as port_api

    rel = api.RelationPayload(relation="ENTITY", label="knows", **{"from": api.RelationNodePayload(value="a", group="p")},
                              to=api.RelationNodePayload(value="b"))
    got = as_port(rel)
    assert type(got) is port_api.RelationPayload and type(got.from_) is port_api.RelationNodePayload
    assert got.from_.value == "a" and got.from_.group == "p" and got.to.value == "b"
    assert got.model_dump(by_alias=True)["from"] == rel.model_dump(by_alias=True)["from"]
    # enums become the port's members; unset fields stay unset (updates
    # merge only the fields a caller set)
    req = as_port(api.FindRequest(query="q", features=[api.SearchFeature.KEYWORD],
                                  filter_expression=api.FilterExpression(literal="/l/a")))
    assert req.features == [port_api.SearchFeature.KEYWORD] and type(req.filter_expression) is port_api.FilterExpression
    upd = as_port(api.UpdateResourcePayload(title="t"))
    assert type(upd) is port_api.UpdateResourcePayload and upd.model_dump(exclude_unset=True) == {"title": "t"}
    p = as_port(payload("T", "body", entities=[("x", "rel", "y")]))
    assert type(p.usergenerated_relations[0].from_) is port_api.RelationNodePayload
    assert p.model_dump(mode="json") == payload("T", "body", entities=[("x", "rel", "y")]).model_dump(mode="json")


# ---------------------------------------------------------------------------
# the consumer cases of tests/test_consumer_predict.py
# ---------------------------------------------------------------------------


def _consumer_stack(pkg, tmp):
    node = pkg.node(tmp / "n", storage=pkg.MemoryStorage())
    driver = pkg.Driver(str(tmp / "kv.db"))
    kbs = pkg.KnowledgeBoxManager(driver, node)
    return node, kbs, pkg.Processor(driver, node, kbs)


def sc_component_mode_ingest_via_bus(pkg, tmp):
    node, kbs, processor = _consumer_stack(pkg, tmp)
    c = pkg.consumer
    kbid = kbs.create(pkg.conv(api.KnowledgeBoxConfig(slug="comp")))
    bus = pkg.EmbeddedBus(str(tmp / "bus.db"))
    txn_util, consumer = c.TransactionUtility(bus), c.IngestConsumer(bus, processor)
    p = api.CreateResourcePayload(title="Doc", texts={"t": api.TextFieldPayload(body="hello bus world")})
    txn_util.commit(c.BrokerMessage(kbid=kbid, rid="r1", op="create", payload=pkg.conv(p.model_dump())))
    txn_util.commit(c.BrokerMessage(kbid=kbid, rid="r1", op="update", payload={"title": "Doc v2"}))
    out = [consumer.drain(), processor.get_payload(kbid, "r1")]
    node.wait_for_sync()
    search = pkg.SearchService(node, kbs, processor)
    out.append(search.find(kbid, pkg.conv(api.FindRequest(query="bus", features=KEYWORD))))
    notes = []
    while (m := bus.next(c.NOTIFY_STREAM, "watcher")) is not None:
        notes.append(m.payload)
        bus.ack(c.NOTIFY_STREAM, "watcher", m.seq)
    txn_util.commit(c.BrokerMessage(kbid=kbid, rid="r1", op="delete"))
    return out + [len(notes), consumer.drain(), processor.get_payload(kbid, "r1")]


def sc_hashing_encoder_properties(pkg, tmp):
    enc = pkg.predict.HashingEncoder(dimension=64)
    return [enc("the quick brown fox"), enc("stock markets rally"), enc("")]


def sc_predict_engine_in_find(pkg, tmp):
    node, kbs, processor = _consumer_stack(pkg, tmp)
    kbid = kbs.create(pkg.conv(api.KnowledgeBoxConfig(slug="pred", vectorsets={"hash": api.VectorSetSpec(dimension=64)})))
    enc = pkg.predict.HashingEncoder(dimension=64)
    for rid, body in [("r1", "the quick brown fox"), ("r2", "markets rallied today")]:
        p = api.CreateResourcePayload(title=rid, texts={"t": api.TextFieldPayload(body=body)}, embeddings={
            "hash": {"t": [{"start": 0, "end": len(body), "vector": enc(body).tolist()}]}})
        processor.create_resource(kbid, pkg.conv(p), rid=rid)
    node.wait_for_sync()
    search = pkg.SearchService(node, kbs, processor, predict=pkg.predict.LocalPredictEngine(encoder=enc))
    semantic = [api.SearchFeature.SEMANTIC]
    return [search.find(kbid, pkg.conv(api.FindRequest(query="quick fox", features=semantic))),
            search.find(kbid, pkg.conv(api.FindRequest(query="quick fox", features=semantic, min_score_semantic=0.35))),
            search.ask(kbid, pkg.conv(api.AskRequest(query="quick fox")))]


def sc_trace_propagation_through_bus(pkg, tmp):
    node, kbs, processor = _consumer_stack(pkg, tmp)
    c, tracing = pkg.consumer, pkg.tracing
    kbid = kbs.create(pkg.conv(api.KnowledgeBoxConfig(slug="tracekb")))
    bus = pkg.EmbeddedBus(str(tmp / "tbus.db"))
    txn_util, consumer = c.TransactionUtility(bus), c.IngestConsumer(bus, processor)
    tracing.setup_tracing("test")
    try:
        p = api.CreateResourcePayload(title="Traced", texts={"t": api.TextFieldPayload(body="x")})
        with tracing.span("writer.commit"):
            txn_util.commit(c.BrokerMessage(kbid=kbid, rid="rt", op="create", payload=pkg.conv(p.model_dump())))
        drained = consumer.drain()
        by_name = {s.name: s for s in tracing.recent_spans()}
        writer, ingest, idx = by_name["writer.commit"], by_name["ingest.process"], by_name["indexer.index_resource"]
        ctx = tracing.extract_context({"traceparent": f"00-{writer.trace_id}-{writer.span_id}-01"})
        # trace and span ids are random: the relations between them compare
        return [drained, sorted(by_name), ingest.trace_id == writer.trace_id == idx.trace_id,
                ingest.parent_id == writer.span_id, ingest.attributes["kbid"] == kbid, ingest.duration_ms >= 0,
                ctx.trace_id == writer.trace_id]
    finally:
        tracing.teardown_tracing()


def sc_tracing_noop_when_unconfigured(pkg, tmp):
    tracing = pkg.tracing
    tracing.teardown_tracing()
    with tracing.span("anything", key="v") as s:
        inside = s
    return [inside, tracing.inject_context({}), tracing.extract_context({})]


def sc_create_resource_redelivery_idempotent(pkg, tmp):
    node, kbs, processor = _consumer_stack(pkg, tmp)
    kbid = kbs.create(pkg.conv(api.KnowledgeBoxConfig(slug="redeliver")))
    p = pkg.conv(api.CreateResourcePayload(title="Doc", slug="s1", texts={"t": api.TextFieldPayload(body="redelivered create")}))
    rid, _ = processor.create_resource(kbid, p, created=123.0)
    out = [rid, kbs.get_shards(kbid), processor.get_meta(kbid, rid)]
    rid2, _ = processor.create_resource(kbid, p, rid=rid)
    return out + [rid2, kbs.get_shards(kbid), processor.get_meta(kbid, rid).created]


def sc_poison_broker_message_does_not_stop_consumer(pkg, tmp):
    node, kbs, processor = _consumer_stack(pkg, tmp)
    c = pkg.consumer
    kbid = kbs.create(pkg.conv(api.KnowledgeBoxConfig(slug="poison")))
    bus = pkg.EmbeddedBus(str(tmp / "bus_p.db"), ack_wait=0.01)
    txn_util, consumer = c.TransactionUtility(bus), c.IngestConsumer(bus, processor)
    bus.publish(c.INGEST_STREAM, "ingest.0.garbage", b"\xc1 not msgpack")
    txn_util.commit(c.BrokerMessage(kbid=kbid, rid="bad", op="create", payload={"title": {"x": 1}}))
    good = api.CreateResourcePayload(title="Good", texts={})
    txn_util.commit(c.BrokerMessage(kbid=kbid, rid="good", op="create", payload=pkg.conv(good.model_dump())))
    for _ in range(2 * pkg.MAX_DELIVERIES + 4):
        consumer.drain()
        time.sleep(0.02)
    return [processor.get_payload(kbid, "good"), processor.get_payload(kbid, "bad")]


def sc_bus_purge_acked_cleans_consumer_rows(pkg, tmp):
    bus = pkg.EmbeddedBus(str(tmp / "bus_c.db"))
    for i in range(5):
        bus.publish("s", "ingest.0.x", f"m{i}".encode())
    while (m := bus.next("s", "c", subject_prefix="ingest.0.")) is not None:
        bus.ack("s", "c", m.seq)
    purged = bus.purge_acked("s", [("c", "ingest.0.")])
    return [purged, bus._conn.execute("SELECT COUNT(*) FROM consumers WHERE stream='s'").fetchone()[0]]


CONSUMER_SCENARIOS = {
    name: globals()[f"sc_{name}"]
    for name in (
        "component_mode_ingest_via_bus", "hashing_encoder_properties", "predict_engine_in_find",
        "trace_propagation_through_bus", "tracing_noop_when_unconfigured",
        "create_resource_redelivery_idempotent", "poison_broker_message_does_not_stop_consumer",
        "bus_purge_acked_cleans_consumer_rows",
    )
}

@pytest.mark.parametrize("scenario", sorted(CONSUMER_SCENARIOS))
def test_consumer_scenario_matches_jax(run_both, scenario):
    run_both(CONSUMER_SCENARIOS[scenario])


def test_consumer_scenarios_cover_test_consumer_predict():
    import tests.test_consumer_predict as ref

    names = {n[5:] for n in dir(ref) if n.startswith("test_")}
    assert names <= set(CONSUMER_SCENARIOS), sorted(names - set(CONSUMER_SCENARIOS))


# ---------------------------------------------------------------------------
# the differential fuzz of tests/test_find_differential_fuzz.py
# ---------------------------------------------------------------------------


def _fuzz(pkg, tmp, seed):
    """test_find_differential_fuzz.py's loop on ``pkg``: every answer is
    held to the dict oracle here, and returned for the comparison."""
    rng = np.random.default_rng(seed)
    driver = pkg.Driver(str(tmp / "db.sqlite"))
    node = pkg.node(tmp / "node")
    kbs = pkg.KnowledgeBoxManager(driver, node)
    kbid = kbs.create(pkg.conv(api.KnowledgeBoxConfig(
        slug="fuzz", hidden_resources_enabled=True, vectorsets={"m": api.VectorSetSpec(dimension=8)})))
    processor = pkg.Processor(driver, node, kbs)
    search = pkg.SearchService(node, kbs, processor)
    oracle, live, answers = Oracle(), [], []

    def random_payload(cls):
        body = " ".join(rng.choice(VOCAB, size=rng.integers(2, 6)))
        labels = [LABELSETS[i] for i in rng.choice(len(LABELSETS), size=rng.integers(0, 3), replace=False)]
        groups = list(rng.choice(GROUPS, size=rng.integers(0, 3), replace=False))
        hidden = bool(rng.random() < 0.2)
        vec = rng.standard_normal(8).astype(np.float32)
        vec /= np.linalg.norm(vec)
        p = cls(
            title="t", texts={"t": api.TextFieldPayload(body=body)},
            usermetadata=api.UserMetadata(classifications=[api.Classification(labelset=s, label=l) for s, l in labels]),
            security=api.ResourceSecurity(access_groups=groups) if groups else None, hidden=hidden,
            embeddings={"m": {"t": [api.SentenceEmbedding(start=0, end=len(body), vector=vec.tolist())]}},
        )
        return pkg.conv(p), body, [f"/l/{s}/{l}" for s, l in labels], groups, hidden

    for step in range(30):
        op = rng.random()
        if op < 0.55 or not live:
            p, body, labels, groups, hidden = random_payload(api.CreateResourcePayload)
            created = float(rng.integers(1000, 2000))
            rid, _ = processor.create_resource(kbid, p, created=created)
            live.append(rid)
            oracle.put(rid, body, labels, groups, hidden, created)
        elif op < 0.8:
            rid = live[int(rng.integers(len(live)))]
            p, body, labels, groups, hidden = random_payload(api.UpdateResourcePayload)
            processor.update_resource(kbid, rid, p)
            oracle.put(rid, body, labels, groups, hidden, oracle.docs[rid]["created"])
        else:
            rid = live.pop(int(rng.integers(len(live))))
            processor.delete_resource(kbid, rid)
            oracle.delete(rid)
        if rng.random() < 0.3:
            node.tick_background()
        if step % 3 != 2:
            continue
        node.wait_for_sync()
        q_tokens = list(rng.choice(VOCAB, size=rng.integers(1, 3), replace=False))
        label = LABELSETS[int(rng.integers(len(LABELSETS)))] if rng.random() < 0.4 else None
        security = list(rng.choice(GROUPS, size=1)) if rng.random() < 0.4 else None
        show_hidden = bool(rng.random() < 0.3)
        window = None
        if rng.random() < 0.4:
            lo = float(rng.integers(900, 1900))
            window = (lo, lo + float(rng.integers(100, 700)))
        filt = api.FilterExpression(literal=f"/l/{label[0]}/{label[1]}") if label else None
        res = search.find(kbid, pkg.conv(api.FindRequest(
            query=" ".join(q_tokens), features=KEYWORD, top_k=50, filter_expression=filt,
            security_groups=security, show_hidden=show_hidden,
            range_creation_start=window[0] if window else None, range_creation_end=window[1] if window else None,
        )))
        assert set(res.resources) == oracle.find(q_tokens, label, security, show_hidden, window), (pkg.name, step)
        qv = rng.standard_normal(8).astype(np.float32)
        sem = search.find(kbid, pkg.conv(api.FindRequest(
            query="", vector=(qv / np.linalg.norm(qv)).tolist(), features=[api.SearchFeature.SEMANTIC], top_k=100,
            filter_expression=filt, security_groups=security, show_hidden=show_hidden,
        )))
        expect_sem = {
            rid for rid, d in oracle.docs.items()
            if (label is None or f"/l/{label[0]}/{label[1]}" in d["labels"])
            and (security is None or not d["groups"] or (d["groups"] & set(security)))
            and (show_hidden or not d["hidden"])
        }
        assert set(sem.resources) == expect_sem, (pkg.name, step, "semantic")
        answers += [res, sem]
    return answers


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_fuzz_matches_oracle_and_jax(run_both, seed):
    assert tokenize("Alpha BRAVO") == ["alpha", "bravo"]  # the oracle's tokenizer
    jax_answers, port_answers = run_both(lambda pkg, tmp: _fuzz(pkg, tmp, seed))
    assert len(port_answers) == len(jax_answers) == 20


# ---------------------------------------------------------------------------
# one knowledge box, two packages
# ---------------------------------------------------------------------------


def _ingest(pkg, tmp, kbid=None):
    """A knowledge box written by ``pkg``'s Processor (a local storage and
    sqlite files under ``tmp``), then synced."""
    node = pkg.node(tmp / "node")
    driver = pkg.Driver(str(tmp / "kv.db"))
    kbs = pkg.KnowledgeBoxManager(driver, node)
    processor = pkg.Processor(driver, node, kbs)
    if kbid is None:
        kbid = kbs.create(pkg.conv(api.KnowledgeBoxConfig(
            slug="shared", vectorsets={"model1": api.VectorSetSpec(dimension=DIM)})))
    rng = np.random.default_rng(4)
    words = ["quick", "fox", "markets", "lazy", "dog", "stock", "grey", "wolf"]
    for i in range(12):
        body = " ".join(rng.choice(words, 6)) + f"\n\n{words[i % 8]} paragraph {i}"
        processor.create_resource(kbid, pkg.conv(payload(
            f"Doc {i}", body, labels=[("topic", "animals" if i % 3 else "finance")],
            entities=[(words[i % 8], "near", words[(i + 3) % 8])], slug=f"doc-{i}")), created=1000.0 + i)
    node.tick_background()
    node.wait_for_sync()
    return kbid


def _answers(pkg, tmp, kbid):
    """The /find, suggest, catalog and graph answers of ``pkg`` over the
    knowledge box in ``tmp``."""
    node = pkg.node(tmp / "node")
    driver = pkg.Driver(str(tmp / "kv.db"))
    kbs = pkg.KnowledgeBoxManager(driver, node)
    search = pkg.SearchService(node, kbs, pkg.Processor(driver, node, kbs))
    s = SimpleNamespace(search=search, kbid=kbid)
    return [kbs.get_config(kbid),
            _find(s, pkg, query="quick fox", vector=embed("quick fox lazy dog"), top_k=8),
            _find(s, pkg, query="markets", features=KEYWORD, filter_expression=api.FilterExpression(literal="/l/topic/finance")),
            _find(s, pkg, query="wolf", features=[api.SearchFeature.FULLTEXT], sort_field="created"),
            search.suggest(kbid, pkg.conv(api.SuggestRequest(query="mar"))),
            search.catalog(kbid, pkg.conv(api.CatalogRequest(faceted=["/l/topic"]))),
            search.graph(kbid, pkg.conv(api.GraphSearchPayload(source_value="fox")))]


@pytest.mark.parametrize("writer", PACKAGES)
def test_knowledge_box_written_by_one_package_is_answered_by_the_other(tmp_path, writer):
    """The maindb rows (KB config, shards, resource meta and payloads) and
    the node's data directory written by ``writer`` are read by both
    packages, and both give the same answers."""
    kbid = _ingest(_pkg(writer), tmp_path)
    want, got = (_answers(_pkg(name), tmp_path, kbid) for name in PACKAGES)
    assert want[1].resources and want[2].resources and want[5].resources
    assert_plain_close(_norm(got), _norm(want))
