"""The port's ``ParagraphSearcher`` and ``TextSearcher`` against the JAX
package's, on the CPU, on the fixtures of ``tests/test_text_paragraph_index.py``.

Both searchers open the same segment files. ``route`` is "device" (the host
WAND tier off on both sides: the JAX program against ``ops/bm25.py``) or
"default" (the cost-model routing of both packages). Responses compare
field by field: hits in order with scores within ``RTOL``, totals,
ematches, facet counts, pagination and ``SearchAfter`` cursors.
"""

import threading

import numpy as np
import pytest

from nucliadb_tpu.index import paragraph as jpara
from nucliadb_tpu.index import text as jtext
from nucliadb_tpu.models.internal import IndexParagraph, ResourceDoc, Security, TextInformation
from nucliadb_tpu.query_language import LabelAtom
from nucliadb_tpu.types import FieldId, PrefilterResult, Seq, SimpleOpenIndex
from nucliadb_tpu_torch.index import paragraph as tpara
from nucliadb_tpu_torch.index import text as ttext
from nucliadb_tpu_torch.index.text_engine import batcher as tbatcher
from nucliadb_tpu_torch.ops import bm25
from torch_test_helpers import RTOL, as_port


def make_resource(rid, text, labels=None, groups=None, created=1000):
    rd = ResourceDoc(resource_id=rid, labels=labels or [], created=created, modified=created + 5)
    rd.texts["t/text1"] = TextInformation(text=text, labels=["/t/t"])
    half = max(text.find(". ") + 1, len(text) // 2)
    rd.paragraphs["t/text1"] = {
        f"{rid}/t/text1/0-{half}": IndexParagraph(start=0, end=half),
        f"{rid}/t/text1/{half}-{len(text)}": IndexParagraph(start=half, end=len(text), index=1),
    }
    if groups is not None:
        rd.security = Security(access_groups=groups)
    return rd


RESOURCES = [
    make_resource("r1", "the quick brown fox jumps. the lazy dog sleeps", ["/l/ls/a"], created=1000),
    make_resource("r2", "a quick cat naps. brown leaves fall", ["/l/ls/b"], created=3000),
    make_resource("r3", "secret quick document here. hidden content", ["/l/ls/a"], groups=["admins"], created=2000),
]


@pytest.fixture(params=["device", "default"])
def route(request, monkeypatch):
    if request.param == "device":
        monkeypatch.setenv("NDBTPU_TEXT_HOST_TIER", "0")
    return request.param


def _index(tmp_path, resources, indexer, name, deletions=()):
    segs = []
    for i, r in enumerate(resources):
        m = indexer.index_resource(r, str(tmp_path / f"{name}{i}"))
        segs.append((m, Seq(i + 1)))
    return SimpleOpenIndex(segment_list=segs, deletion_list=list(deletions))


def _para_pair(tmp_path, resources=RESOURCES, deletions=()):
    idx = _index(tmp_path, resources, jpara.ParagraphIndexer(), "p", deletions)
    return jpara.ParagraphSearcher(idx), tpara.ParagraphSearcher(as_port(idx), device="cpu")


def _text_pair(tmp_path, resources=RESOURCES):
    idx = _index(tmp_path, resources, jtext.TextIndexer(), "t")
    return jtext.TextSearcher(idx), ttext.TextSearcher(as_port(idx), device="cpu")


def _same_score(a, b):
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-6)


def assert_same_paragraph_response(j, t):
    assert (t.total, t.ematches, t.query_terms) == (j.total, j.ematches, j.query_terms)
    assert len(t.hits) == len(j.hits)
    for jh, th in zip(j.hits, t.hits):
        _same_score(jh.score, th.score)
        assert {**vars(th), "score": 0} == {**vars(jh), "score": 0}


def _both_para(js, ts, **kw):
    j = js.search(jpara.ParagraphSearchRequest(**kw))
    t = ts.search(tpara.ParagraphSearchRequest(**as_port(kw)))
    assert_same_paragraph_response(j, t)
    return t


PARAGRAPH_REQUESTS = {
    "bm25": dict(query="lazy dog", top_k=10),
    "fuzzy": dict(query="quik", top_k=10, fuzzy=True),
    "no_fuzzy": dict(query="quik", top_k=10, fuzzy=False),
    "phrase": dict(query='"lazy dog"', top_k=10),
    "phrase_reversed": dict(query='"dog lazy"', top_k=10),
    "phrase_absent": dict(query='"no such phrase here"', top_k=10),
    "ematch": dict(query="lazy dog sleeps", top_k=10),
    "field_some": dict(query="quick", top_k=10, field_filter=PrefilterResult.some([FieldId("r2", "t/text1")])),
    "field_none": dict(query="quick", top_k=10, field_filter=PrefilterResult.none()),
    "page": dict(query="quick", top_k=1, offset=1),
    "exclude": dict(query="quick -cat", top_k=10),
    "exclude2": dict(query="quick -cat -secret", top_k=10),
    "exclude_absent": dict(query="quick -zebra", top_k=10),
    "advanced": dict(query="quick", top_k=10, advanced_query='brown -"lazy dog"'),
    "filter": dict(query="quick", top_k=10, filter=LabelAtom("/l/ls/a")),
    "filter_or": dict(
        query="quick", top_k=10, filter=LabelAtom("/l/ls/b"), filter_operator="or",
        field_filter=PrefilterResult.some([FieldId("r3", "t/text1")]),
    ),
    "key_prefixes": dict(query="quick brown", top_k=10, key_prefixes=["r1/"]),
    "min_score": dict(query="quick brown", top_k=10, min_score=0.5),
    "all_terms": dict(query="quick brown", top_k=10, all_terms=True),
    "all_terms_fuzzy": dict(query="quik brwn", top_k=10, all_terms=True, fuzzy=True),
    "no_total": dict(query="quick", top_k=10, need_total=False),
    "pure_filter": dict(query="", top_k=10, filter=LabelAtom("/l/ls/a")),
}


def test_paragraph_requests_match_reference(tmp_path, route):
    js, ts = _para_pair(tmp_path, deletions=[("r9/", Seq(10))])
    before = bm25.DISPATCHES.total()
    for kw in PARAGRAPH_REQUESTS.values():
        _both_para(js, ts, **kw)
    grew = bm25.DISPATCHES.total() > before
    assert grew == (route == "device" or ts.engine.host_tier() is None)
    assert [h.paragraph_id for h in ts.suggest("qui", top_k=5)] == [h.paragraph_id for h in js.suggest("qui", top_k=5)]


def test_search_after_cursor_pages(tmp_path, route):
    """Deep pagination: each page's cursor is the last hit of the page
    before, taken from the same package's answer (scores may differ in the
    last bit between the packages); both walk the same pages."""
    resources = [make_resource(f"p{i:03d}", f"machine learning topic {i % 7} trains models") for i in range(30)]
    js, ts = _para_pair(tmp_path, resources)
    jcur = tcur = None
    seen = []
    for _ in range(4):
        kw = dict(query="learning topic 3", top_k=7)
        j = js.search(jpara.ParagraphSearchRequest(**kw, search_after=jcur))
        t = ts.search(tpara.ParagraphSearchRequest(**kw, search_after=tcur))
        assert_same_paragraph_response(j, t)
        if not t.hits:
            break
        seen += [h.paragraph_id for h in t.hits]
        jcur = jpara.SearchAfter(j.hits[-1].score, j.hits[-1].doc_id)
        tcur = tpara.SearchAfter(t.hits[-1].score, t.hits[-1].doc_id)
    assert len(seen) == len(set(seen)) > 7


def test_stopwords_and_phrase_totals(tmp_path, route):
    resources = [make_resource(f"s{i:03d}", f"the common filler words surround topic{i} here") for i in range(110)]
    resources += [make_resource(f"q{i:03d}", f"machine learning topic {i} trains. unrelated {i} learning") for i in range(12)]
    js, ts = _para_pair(tmp_path, resources)
    for q in ("the topic7", "topic5 the", '"machine learning"', '"machine learning" topic', "learning machine"):
        _both_para(js, ts, query=q, top_k=5)
        _both_para(js, ts, query=q, top_k=5, offset=5)
    plan = dict(query="the topic7 -here", top_k=5)
    jq = js.plan_kernel_query(jpara.ParagraphSearchRequest(**plan))
    tq = ts.plan_kernel_query(tpara.ParagraphSearchRequest(**plan))
    assert (tq.text, tq.excluded, tq.top_k, tq.fuzzy, tq.extra_mask) == (jq.text, jq.excluded, jq.top_k, jq.fuzzy, jq.extra_mask)
    # finish_kernel on one cut: the same response from both
    hits, _ = ts.engine.search(tq)
    top_s = np.array([h.score for h in hits] + [-3.0e38] * (5 - len(hits)), np.float32)
    top_i = np.array([h.doc_id for h in hits] + [-1] * (5 - len(hits)))
    top_ic = np.concatenate([top_i, np.full(5, -1)])
    req = dict(query="the topic7 -here", top_k=5)
    assert_same_paragraph_response(
        js.finish_kernel(jpara.ParagraphSearchRequest(**req), jq, top_s, top_ic, len(hits)),
        ts.finish_kernel(tpara.ParagraphSearchRequest(**req), tq, top_s, top_ic, len(hits)),
    )


def test_refresh_with_prev_matches_reference(tmp_path, route):
    idx = _index(tmp_path, RESOURCES[:2], jpara.ParagraphIndexer(), "p")
    j0, t0 = jpara.ParagraphSearcher(idx), tpara.ParagraphSearcher(as_port(idx), device="cpu")
    idx2 = _index(tmp_path, RESOURCES, jpara.ParagraphIndexer(), "p", deletions=[("r1/", Seq(9))])
    j1, t1 = jpara.ParagraphSearcher(idx2, prev=j0), tpara.ParagraphSearcher(as_port(idx2), prev=t0, device="cpu")
    assert t1.engine.reused_groups == j1.engine.reused_groups
    for q in ("quick", "brown leaves", "secret"):
        _both_para(j1, t1, query=q, top_k=10)


def test_coalesced_requests_share_dispatches(tmp_path, monkeypatch):
    """Unfiltered requests from several threads ride shared batches of the
    port's coalescer; each answer equals the request's solo answer."""
    monkeypatch.setenv("NDBTPU_TEXT_HOST_TIER", "0")
    monkeypatch.setattr(tbatcher.coalescer, "concurrency", 1)
    resources = [make_resource(f"c{i:03d}", f"alpha beta gamma {i} delta. epsilon {i % 5} zeta") for i in range(40)]
    js, ts = _para_pair(tmp_path, resources)
    queries = [f"gamma {i} epsilon" for i in range(24)]
    want = {q: ts.search(tpara.ParagraphSearchRequest(query=q, top_k=5)) for q in queries}
    before = tbatcher.coalescer.dispatches
    got, errors = {}, []
    start = threading.Barrier(6)

    def worker(qs):
        try:
            start.wait(timeout=60)
            for q in qs:
                got[q] = ts.search(tpara.ParagraphSearchRequest(query=q, top_k=5))
        except Exception as exc:  # surfaced by the assert below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(queries[i::6],)) for i in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors and not any(th.is_alive() for th in threads)
    assert tbatcher.coalescer.dispatches - before < len(queries)
    for q in queries:
        assert [(h.paragraph_id, h.score) for h in got[q].hits] == [(h.paragraph_id, h.score) for h in want[q].hits]
        assert_same_paragraph_response(js.search(jpara.ParagraphSearchRequest(query=q, top_k=5)), got[q])


# ---------------------------------------------------------------------------
# documents
# ---------------------------------------------------------------------------


def _both_docs(js, ts, **kw):
    j = js.search(jtext.DocumentSearchRequest(**kw))
    t = ts.search(ttext.DocumentSearchRequest(**as_port(kw)))
    assert (t.total, t.facet_counts) == (j.total, j.facet_counts), kw
    assert [(h.key, h.rid, h.field) for h in t.hits] == [(h.key, h.rid, h.field) for h in j.hits], kw
    _same_score([h.score for h in j.hits], [h.score for h in t.hits])
    return t


DOCUMENT_REQUESTS = [
    dict(query="quick brown", top_k=10),
    dict(query="quick", top_k=10, security_groups=[]),
    dict(query="quick", top_k=10, security_groups=["admins"]),
    dict(query="quick", top_k=10, faceted=["/l/ls"]),
    dict(query="quick", top_k=10, faceted=["/l/ls", "/n/s"], count_resources=True),
    dict(query="quick", top_k=10, order_by="created", order_desc=False),
    dict(query="quick", top_k=2, order_by="created"),
    dict(query="quick", top_k=10, range_creation=(1500, None)),
    dict(query="", top_k=10, only_faceted=True, faceted=["/l/ls"], filter=LabelAtom("/l/ls/a")),
    dict(query="quick", top_k=10, field_filter=PrefilterResult.some([FieldId("r1", "t/text1")])),
    dict(query="quick", top_k=10, advanced_query="-secret"),
    dict(query="quick", top_k=10, key_prefixes=["r2/"]),
    dict(query="quick lazy", top_k=10, all_terms=True),
    dict(query="quick", top_k=10, min_score=0.2),
]


def test_document_requests_match_reference(tmp_path, route):
    js, ts = _text_pair(tmp_path)
    for kw in DOCUMENT_REQUESTS:
        _both_docs(js, ts, **kw)
    keys = ["r1/t/text1", "r3/t/text1", "nope/t/text1"]
    assert ts.get_fields_text(keys) == js.get_fields_text(keys)
    for kw in (
        dict(), dict(filter=LabelAtom("/l/ls/a"), security_groups=[]), dict(filter=LabelAtom("/l/nope/x")),
        dict(range_creation=(1500, 2500)), dict(security_groups=["admins"]),
    ):
        jp, tp = as_port(js.prefilter(**kw)), ts.prefilter(**as_port(kw))
        assert (tp.kind, sorted(tp.fields or [], key=str)) == (jp.kind, sorted(jp.fields or [], key=str))


def test_indexers_write_the_reference_segments(tmp_path):
    """The port's indexers write the files the JAX package's write, and
    merge them alike; the query grammar parses alike."""
    from nucliadb_tpu.index.text_engine import builder as jbuilder

    def fields(path):
        seg = jbuilder.open_text_segment(path)
        arrays = (seg.postings_offsets, seg.postings_docs, seg.postings_tfs, seg.positions_offsets, seg.positions, seg.dlen)
        return (
            seg.keys, seg.terms, seg.attrs, [np.asarray(a).tolist() for a in arrays],
            {f: v.tolist() for f, v in seg.facets.items()}, {c: v.tolist() for c, v in seg.columns.items()},
            None if seg.stored_off is None else [seg.stored_text(i) for i in range(seg.n_docs)],
        )

    for name, jidx, tidx in (
        ("p", jpara.ParagraphIndexer(), tpara.ParagraphIndexer()),
        ("t", jtext.TextIndexer(), ttext.TextIndexer()),
    ):
        jsegs, tsegs = [], []
        for i, r in enumerate(RESOURCES):
            jm = jidx.index_resource(r, str(tmp_path / f"j{name}{i}"))
            tm = tidx.index_resource(as_port(r), str(tmp_path / f"t{name}{i}"))
            assert fields(tm.path) == fields(jm.path)
            assert tidx.deletions_for_resource(as_port(r)) == jidx.deletions_for_resource(r)
            jsegs.append((jm, Seq(i + 1)))
            tsegs.append((tm, Seq(i + 1)))
        dels = [("r2/", Seq(9))]
        jm = jidx.merge(SimpleOpenIndex(segment_list=jsegs, deletion_list=dels), str(tmp_path / f"jm{name}"))
        tm = tidx.merge(as_port(SimpleOpenIndex(segment_list=tsegs, deletion_list=dels)), str(tmp_path / f"tm{name}"))
        assert fields(tm.path) == fields(jm.path)
    for q in ('hello "brown fox" -noise world', "state-of-the-art search", 'broken "quote here', '-a -b "c d" e'):
        assert tpara.parse_query(q) == jpara.parse_query(q)
        assert tpara.split_phrases(q) == jpara.split_phrases(q)
