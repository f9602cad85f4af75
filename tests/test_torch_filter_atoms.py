"""The scenarios of ``tests/test_filter_atoms.py`` on the port: the port's searchers on the CPU.

The reference file's own docstring:

Reference FilterExpression atom parity at the native layer.

The proto plane translates nodereader FilterExpression atoms
(nodereader.proto:286-330) into these query_language atoms; semantics
mirror nidx_text/src/search_query.rs filter_to_query:

- Field    -> /{type}[/{name}] field term
- Keyword  -> tokenized term / consecutive-phrase match
- Date     -> created/modified range (nestable in the boolean tree)
- Resource / ResourceFieldPrefix -> key prefixes (KeyPrefixAtom)

Plus the request-level pieces the proto plane needs: filter_operator OR
between the text and json prefilters (prefilter.rs combine), the
advanced_query Must() mask (nidx_paragraph search_query.rs:202-210) and
the paragraph SearchAfter cursor (nodereader SearchAfter).
"""

import numpy as np
import pytest

from nucliadb_tpu_torch.index.json import JsonPredicate
from nucliadb_tpu_torch.index.paragraph import (
    ParagraphIndexer,
    ParagraphSearcher,
    ParagraphSearchRequest,
    SearchAfter,
)
from nucliadb_tpu_torch.index.text import DocumentSearchRequest, TextIndexer, TextSearcher
from nucliadb_tpu_torch.index.vector import VectorConfig
from nucliadb_tpu_torch.models.internal import (
    IndexParagraph,
    ResourceDoc,
    TextInformation,
    VectorSentence,
)
from nucliadb_tpu_torch.query_language import (
    DateRangeAtom,
    FieldAtom,
    KeyPrefixAtom,
    KeywordAtom,
    LabelAtom,
    and_,
    not_,
    or_,
)
from nucliadb_tpu_torch.shard import (
    ShardConfig,
    ShardIndexer,
    ShardSearcher,
    ShardSearchRequest,
)
from nucliadb_tpu_torch.types import Seq, SimpleOpenIndex

DIM = 8


def embed(text):
    r = np.random.default_rng(abs(hash(text)) % (2**31))
    v = r.standard_normal(DIM).astype(np.float32)
    return v / np.linalg.norm(v)


def make_resource(rid, fields, labels=None, created=1000, meta_json=None):
    """fields: {field_id: text}."""
    rd = ResourceDoc(
        resource_id=rid, labels=labels or [], created=created, modified=created
    )
    for fid, text in fields.items():
        rd.texts[fid] = TextInformation(text=text)
        para = IndexParagraph(start=0, end=len(text))
        para.vectorsets_sentences["m"] = {
            f"{rid}/{fid}/0/0-{len(text)}": VectorSentence(vector=embed(text))
        }
        rd.paragraphs[fid] = {f"{rid}/{fid}/0-{len(text)}": para}
    if meta_json:
        rd.json_fields[next(iter(fields))] = meta_json
    return rd


RESOURCES = [
    make_resource(
        "r1",
        {"t/intro": "the quick brown fox", "f/doc": "annual report of the fox fund"},
        labels=["/l/topic/animals"],
        created=1000,
        meta_json='{"price": 10}',
    ),
    make_resource(
        "r2",
        {"t/intro": "markets rallied on quick gains"},
        labels=["/l/topic/finance"],
        created=2000,
        meta_json='{"price": 99}',
    ),
    make_resource(
        "r3",
        {"t/body": "a quick brown bear in the fox woods"},
        labels=["/l/topic/animals"],
        created=3000,
    ),
]


def build_text(tmp_path):
    indexer = TextIndexer()
    segs = []
    for i, r in enumerate(RESOURCES):
        m = indexer.index_resource(r, str(tmp_path / f"t{i}"))
        segs.append((m, Seq(i + 1)))
    return TextSearcher(SimpleOpenIndex(segment_list=segs), device="cpu")


def build_para(tmp_path):
    indexer = ParagraphIndexer()
    segs = []
    for i, r in enumerate(RESOURCES):
        m = indexer.index_resource(r, str(tmp_path / f"p{i}"))
        segs.append((m, Seq(i + 1)))
    return ParagraphSearcher(SimpleOpenIndex(segment_list=segs), device="cpu")


@pytest.fixture
def shard(tmp_path):
    config = ShardConfig(
        shard_id="s1", kbid="kb1", vectorsets={"m": VectorConfig(dimension=DIM)}
    )
    indexer = ShardIndexer(config)
    open_indexes = {}
    for i, r in enumerate(RESOURCES):
        for op in indexer.index_resource(r, str(tmp_path / f"op{i}")):
            oi = open_indexes.setdefault(op.index_name, SimpleOpenIndex())
            if op.segment is not None:
                oi.segment_list.append((op.segment, Seq(i + 1)))
    return ShardSearcher(config, open_indexes, device="cpu")


def _prefilter_rids(searcher, expr):
    pf = searcher.prefilter(filter=expr)
    if pf.is_all:
        return {"r1", "r2", "r3"}
    if pf.is_none:
        return set()
    return {f.resource_id for f in pf.fields}


def _prefilter_fields(searcher, expr):
    pf = searcher.prefilter(filter=expr)
    assert not pf.is_all and not pf.is_none
    return {(f.resource_id, f.field_id) for f in pf.fields}


def test_field_atom_type_only(tmp_path):
    s = build_text(tmp_path)
    assert _prefilter_fields(s, FieldAtom("f")) == {("r1", "f/doc")}
    assert _prefilter_fields(s, FieldAtom("t")) == {
        ("r1", "t/intro"), ("r2", "t/intro"), ("r3", "t/body"),
    }


def test_field_atom_type_and_name(tmp_path):
    s = build_text(tmp_path)
    assert _prefilter_fields(s, FieldAtom("t", "intro")) == {
        ("r1", "t/intro"), ("r2", "t/intro"),
    }
    assert _prefilter_rids(s, FieldAtom("t", "nope")) == set()


def test_keyword_atom_single_term(tmp_path):
    s = build_text(tmp_path)
    assert _prefilter_rids(s, KeywordAtom("fox")) == {"r1", "r3"}
    assert _prefilter_rids(s, KeywordAtom("rallied")) == {"r2"}
    assert _prefilter_rids(s, KeywordAtom("absent")) == set()


def test_keyword_atom_phrase(tmp_path):
    s = build_text(tmp_path)
    # both r1 and r3 contain "quick" and "brown"; only as a consecutive
    # phrase in both ("quick brown fox" / "quick brown bear")
    assert _prefilter_rids(s, KeywordAtom("quick brown")) == {"r1", "r3"}
    # "brown fox" is consecutive only in r1 (r3 has "brown bear ... fox")
    assert _prefilter_rids(s, KeywordAtom("brown fox")) == {"r1"}


def test_date_range_atom_nested(tmp_path):
    s = build_text(tmp_path)
    assert _prefilter_rids(s, DateRangeAtom("created", since=1500)) == {"r2", "r3"}
    assert _prefilter_rids(s, DateRangeAtom("created", until=1500)) == {"r1"}
    # nested in a boolean tree with a keyword — something the old
    # range_creation side-channel could not express
    expr = and_(KeywordAtom("quick"), DateRangeAtom("created", since=1500, until=2500))
    assert _prefilter_rids(s, expr) == {"r2"}
    expr = or_(DateRangeAtom("created", until=1500), LabelAtom("/l/topic/finance"))
    assert _prefilter_rids(s, expr) == {"r1", "r2"}
    # no bounds -> AllQuery parity
    assert _prefilter_rids(s, DateRangeAtom("created")) == {"r1", "r2", "r3"}


def test_resource_and_prefix_atoms(tmp_path):
    s = build_text(tmp_path)
    assert _prefilter_rids(s, KeyPrefixAtom(("r1/",))) == {"r1"}
    assert _prefilter_fields(s, KeyPrefixAtom(("r1/f/",))) == {("r1", "f/doc")}
    assert _prefilter_rids(s, not_(KeyPrefixAtom(("r1/",)))) == {"r2", "r3"}


def test_filter_operator_or_combines_prefilters(shard):
    # text side matches r2 (finance); json side matches r1 (price < 50)
    req_and = ShardSearchRequest(
        body="quick",
        field_filter=LabelAtom("/l/topic/finance"),
        json_filter=JsonPredicate(path="price", op="lt", value=50),
        filter_operator="and",
    )
    assert shard.compute_prefilter(req_and).is_none
    req_or = ShardSearchRequest(
        body="quick",
        field_filter=LabelAtom("/l/topic/finance"),
        json_filter=JsonPredicate(path="price", op="lt", value=50),
        filter_operator="or",
    )
    pf = shard.compute_prefilter(req_or)
    assert {f.resource_id for f in pf.fields} == {"r1", "r2"}
    resp = shard.search(req_or)
    assert {h.rid for h in resp.paragraph.hits} == {"r1", "r2"}


def test_advanced_query_is_a_must_filter(shard):
    # base query matches r1/r2/r3 ("quick"); advanced_query restricts to
    # docs containing fox (r1, r3), scores still from the base query
    base = ShardSearchRequest(body="quick", top_k=10)
    resp = shard.search(base)
    assert {h.rid for h in resp.paragraph.hits} == {"r1", "r2", "r3"}
    resp = shard.search(
        ShardSearchRequest(body="quick", top_k=10, advanced_query="fox")
    )
    assert {h.rid for h in resp.paragraph.hits} == {"r1", "r3"}
    # phrase + exclusion grammar
    resp = shard.search(
        ShardSearchRequest(body="quick", top_k=10, advanced_query='"brown bear"')
    )
    assert {h.rid for h in resp.paragraph.hits} == {"r3"}
    resp = shard.search(
        ShardSearchRequest(body="quick", top_k=10, advanced_query="quick -fox")
    )
    assert {h.rid for h in resp.paragraph.hits} == {"r2"}
    # document leg honors it too
    resp = shard.search(
        ShardSearchRequest(
            body="quick", top_k=10, document=True, paragraph=False,
            advanced_query="fox",
        )
    )
    assert {h.rid for h in resp.document.hits} == {"r1", "r3"}


def test_search_after_cursor_walks_all_pages(tmp_path):
    s = build_para(tmp_path)
    full = s.search(ParagraphSearchRequest(query="quick", top_k=50)).hits
    assert len(full) >= 3
    # deterministic cursor order
    expected = sorted(full, key=lambda h: (-h.score, h.doc_id))
    walked = []
    cursor = None
    while True:
        req = ParagraphSearchRequest(query="quick", top_k=1, search_after=cursor)
        page = s.search(req).hits
        if not page:
            break
        walked.extend(page)
        last = page[-1]
        cursor = SearchAfter(score=last.score, tie=last.doc_id)
        assert len(walked) <= len(expected) + 1
    assert [h.paragraph_id for h in walked] == [h.paragraph_id for h in expected]


def test_search_after_tie_modes(tmp_path):
    s = build_para(tmp_path)
    full = s.search(ParagraphSearchRequest(query="quick", top_k=50)).hits
    top = sorted(full, key=lambda h: (-h.score, h.doc_id))[0]
    # drop: hits at the cursor score are skipped entirely
    dropped = s.search(
        ParagraphSearchRequest(
            query="quick", top_k=50, search_after=SearchAfter(score=top.score, tie="drop")
        )
    ).hits
    assert all(h.score < top.score for h in dropped)
    # keep: ties at the cursor score remain
    kept = s.search(
        ParagraphSearchRequest(
            query="quick", top_k=50, search_after=SearchAfter(score=top.score, tie="keep")
        )
    ).hits
    assert any(h.score == top.score for h in kept) or all(
        h.score < top.score for h in dropped
    )
