"""The port's text engine (``nucliadb_tpu_torch.index.text_engine``) against
the JAX package's, on the CPU.

Both engines open the same segment files, each through its own package,
and answer the same ``TextQuery``. On the device route (the host WAND tier
off on both sides, ``NDBTPU_TEXT_HOST_TIER=0``) the JAX program runs
through XLA and the port's through ``ops/bm25.py``: ids are equal up to
ties and scores within ``torch_test_helpers.RTOL`` (XLA contracts ``tf + K1 * x`` into an FMA
on the CPU, torch rounds each operation), and matched bitmaps, counts and
per-hit term counts are exactly equal. On the default route both engines
run the same host tier and agree exactly. The fixtures are those of
``tests/test_text_engine.py``, ``test_text_incremental.py`` and
``test_golden_parity.py``.
"""

import numpy as np
import pytest
import torch

from nucliadb_tpu.index.text_engine import builder as jbuilder
from nucliadb_tpu.index.text_engine import engine as jeng
from nucliadb_tpu.index.text_engine import fuzzy as jfuzzy
from nucliadb_tpu.index.text_engine import tokenizer as jtok
from nucliadb_tpu.query_language import LabelAtom, not_
from nucliadb_tpu.types import Seq, SimpleOpenIndex
from nucliadb_tpu_torch.index.text_engine import builder as tbuilder
from nucliadb_tpu_torch.index.text_engine import engine as teng
from nucliadb_tpu_torch.index.text_engine import fuzzy as tfuzzy
from nucliadb_tpu_torch.index.text_engine import host_tier as tht
from nucliadb_tpu_torch.index.text_engine import tokenizer as ttok
from nucliadb_tpu_torch.ops import bm25
from torch_test_helpers import as_port, assert_same_results

DOCS = [
    ("r1/f1", "the quick brown fox jumps over the lazy dog", ["/t/t"]),
    ("r1/f2", "a quick brown cat sleeps", ["/t/t"]),
    ("r2/f1", "the lazy dog sleeps all day", ["/t/a"]),
    ("r3/f1", "foxes are quick and brown animals", ["/t/a"]),
    ("r4/f1", "nothing in common here", ["/t/t"]),
]


@pytest.fixture
def device_route(monkeypatch):
    monkeypatch.setenv("NDBTPU_TEXT_HOST_TIER", "0")


def _write(path, docs, created0=1000, builder=jbuilder):
    entries = [
        builder.DocEntry(key=k, text=t, facets=f, columns={"created": created0 + i})
        for i, (k, t, f) in enumerate(docs)
    ]
    return builder.build_segment(str(path), entries, kind="text").path


def _split(tmp_path, docs, n_segments, name="s"):
    per = -(-len(docs) // n_segments)
    return [
        (_write(tmp_path / f"{name}{s}", docs[s * per : (s + 1) * per]), Seq(s + 1))
        for s in range(n_segments)
        if docs[s * per : (s + 1) * per]
    ]


def _pair(segs, deletions=(), prev=(None, None)):
    """(JAX engine, port engine on the CPU) over the same segment files."""
    je = jeng.DeviceTextEngine(
        [(jbuilder.open_text_segment(p), q) for p, q in segs], deletions, prev=prev[0]
    )
    te = teng.DeviceTextEngine(
        [(tbuilder.open_text_segment(p), as_port(q)) for p, q in segs], as_port(list(deletions)), prev=prev[1],
        device="cpu",
    )
    return je, te


def assert_same_hits(jhits, thits):
    assert len(jhits) == len(thits), ([h.key for h in jhits], [h.key for h in thits])
    if not jhits:
        return
    assert_same_results(
        [[h.score for h in jhits]], [[h.doc_id for h in jhits]],
        [[h.score for h in thits]], [[h.doc_id for h in thits]],
    )
    # keys, attrs and term counts follow the doc ids
    assert {h.doc_id: (h.key, h.attrs, h.term_count) for h in jhits} == {
        h.doc_id: (h.key, h.attrs, h.term_count) for h in thits
    }


def assert_same_matched(jm, tm):
    if isinstance(jm, np.ndarray):
        np.testing.assert_array_equal(np.asarray(tm), jm)
    else:
        assert not isinstance(tm, np.ndarray) and tm.sum() == jm.sum() and len(tm) == len(jm)


def _search_both(je, te, need_matched=True, **kw):
    j = je.search(jeng.TextQuery(**kw), need_matched=need_matched)
    t = te.search(teng.TextQuery(**as_port(kw)), need_matched=need_matched)
    assert_same_hits(j[0], t[0])
    assert_same_matched(j[1], t[1])
    return t


def _batch_both(je, te, kws, need_matched=True):
    jout = je.search_batch([jeng.TextQuery(**kw) for kw in kws], need_matched=need_matched)
    tout = te.search_batch([teng.TextQuery(**as_port(kw)) for kw in kws], need_matched=need_matched)
    assert len(jout) == len(tout) == len(kws)
    for (jh, jm), (th, tm) in zip(jout, tout):
        assert_same_hits(jh, th)
        assert_same_matched(jm, tm)
    return tout


# ---------------------------------------------------------------------------
# host modules: tokenizer, fuzzy, segment files
# ---------------------------------------------------------------------------


def test_tokenizer_and_fuzzy_match_reference():
    texts = ["Hello, World! it's 42", "Ünïcode wörds stay", "x" * 41 + " short", "a_b-c d"]
    for text in texts:
        assert ttok.tokenize(text) == jtok.tokenize(text)
        assert ttok.tokenize_with_positions(text) == jtok.tokenize_with_positions(text)
    assert ttok.strip_diacritics("café") == jtok.strip_diacritics("café")
    vocab = ["quick", "quack", "brown", "browns", "crown", "ceiling", "ab", "café", "flour", "abcde"]
    for d in (1, 2):
        ji, ti = jfuzzy.FuzzyIndex(vocab, max_distance=d), tfuzzy.FuzzyIndex(vocab, max_distance=d)
        for tok in ["quick", "quic", "brown", "cieling", "ab", "cafe", "four", "abc", "zz"]:
            assert ti.expand(tok, d) == ji.expand(tok, d), (tok, d)
    for a, b in [("cieling", "ceiling"), ("ab", "ba"), ("abc", "cba"), ("kitten", "sitting")]:
        for d in (1, 2):
            assert tfuzzy.osa_leq(a, b, d) == jfuzzy.osa_leq(a, b, d)
            assert tfuzzy.levenshtein_leq(a, b, d) == jfuzzy.levenshtein_leq(a, b, d)


def _open_fields(seg):
    return (
        seg.keys, seg.terms, seg.attrs, seg.meta, sorted(seg.facets), sorted(seg.columns),
        [np.asarray(a).tolist() for a in (
            seg.postings_offsets, seg.postings_docs, seg.postings_tfs,
            seg.positions_offsets, seg.positions, seg.dlen,
        )],
        {f: seg.facets[f].tolist() for f in seg.facets},
        {c: seg.columns[c].tolist() for c in seg.columns},
        None if seg.stored_off is None else [seg.stored_text(i) for i in range(seg.n_docs)],
    )


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_segment_files_interchange(tmp_path, writer):
    """A segment written by either package opens in the other with the
    same contents; both packages write the same files."""
    entries = [(k, t, f) for k, t, f in DOCS] + [("r5/f1", "hello world hello", ["/x/y"])]
    metas = {}
    for name, builder in (("jax", jbuilder), ("torch", tbuilder)):
        docs = [builder.DocEntry(key=k, text=t, facets=f, attrs={"i": i}, columns={"created": i})
                for i, (k, t, f) in enumerate(entries)]
        metas[name] = builder.build_segment(str(tmp_path / name), docs, kind="text", store_text=True)
    other = "torch" if writer == "jax" else "jax"
    p = metas[writer].path
    assert _open_fields(tbuilder.open_text_segment(p)) == _open_fields(jbuilder.open_text_segment(p))
    assert _open_fields(tbuilder.open_text_segment(p)) == _open_fields(tbuilder.open_text_segment(metas[other].path))
    # merges of the two agree too
    idx = SimpleOpenIndex(
        segment_list=[(metas[writer], Seq(1)), (metas[other], Seq(2))], deletion_list=[("r1/", Seq(3))],
    )
    jm = jbuilder.merge_text_segments(str(tmp_path / "jm"), idx, kind="text")
    tm = tbuilder.merge_text_segments(str(tmp_path / "tm"), as_port(idx), kind="text")
    assert jm.records == tm.records
    assert _open_fields(tbuilder.open_text_segment(tm.path)) == _open_fields(jbuilder.open_text_segment(jm.path))


# ---------------------------------------------------------------------------
# the device route: tests/test_text_engine.py's fixtures
# ---------------------------------------------------------------------------

QUERIES = {
    "bm25": dict(text="quick brown", top_k=10),
    "lazy_dog": dict(text="lazy dog", top_k=10),
    "and": dict(text="quick dog", top_k=10, all_terms=True),
    "and_unknown": dict(text="quick zzzz", top_k=10, all_terms=True),
    "facet": dict(text="quick", top_k=10, filter=LabelAtom("/t/a")),
    "not_facet": dict(text="quick", top_k=10, filter=not_(LabelAtom("/t/a"))),
    "key_prefix": dict(text="quick", top_k=10, key_prefixes=["r1/"]),
    "fuzzy": dict(text="qick", top_k=10, fuzzy=True),
    "no_fuzzy_typo": dict(text="quikc", top_k=10),
    "phrase_tokens": dict(text="sleeps", top_k=10, phrases=["lazy dog"]),
    "exclusion": dict(text="quick", excluded=["brown"], top_k=10),
    "min_score": dict(text="quick brown", top_k=10, min_score=1.0),
    "top_k_cut": dict(text="quick brown dog", top_k=2),
    "only_faceted": dict(text="sleeps", top_k=10, only_faceted=True),
    "pure_filter": dict(text="", top_k=10, only_faceted=True, filter=LabelAtom("/t/t")),
}


@pytest.mark.parametrize("n_segments", [1, 3])
def test_queries_match_reference(tmp_path, device_route, n_segments):
    je, te = _pair(_split(tmp_path, DOCS, n_segments), deletions=[("r4/", Seq(9))])
    before = dict(bm25.DISPATCHES)
    for name, kw in QUERIES.items():
        _search_both(je, te, **kw)
        _search_both(je, te, need_matched=False, **kw)
    # every query with a known term ran the device program, twice
    dispatching = [n for n in QUERIES if n not in ("pure_filter", "no_fuzzy_typo")]
    assert bm25.DISPATCHES["single"] - before.get("single", 0) == 2 * len(dispatching)
    # batches: the shared-mask path, the per-query-mask path, AND with counts
    kws = [kw for kw in QUERIES.values() if kw["text"].strip() and not kw.get("only_faceted")]
    unfiltered = [kw for kw in kws if not ({"filter", "key_prefixes", "excluded"} & set(kw))]
    _batch_both(je, te, unfiltered)
    _batch_both(je, te, kws)
    _batch_both(je, te, kws, need_matched=False)
    with pytest.raises(ValueError):
        te.search_batch([teng.TextQuery(text="  ")])


def test_batch_equals_single(tmp_path, device_route):
    _, te = _pair(_split(tmp_path, DOCS, 2))
    kws = [QUERIES[n] for n in ("bm25", "lazy_dog", "facet", "and", "exclusion")]
    for kw, (bh, bm) in zip(kws, te.search_batch([teng.TextQuery(**as_port(kw)) for kw in kws])):
        sh, sm = te.search(teng.TextQuery(**as_port(kw)))
        assert [(h.key, h.score) for h in bh] == [(h.key, h.score) for h in sh]
        np.testing.assert_array_equal(bm, sm)


def test_deletions_and_key_prefix_across_segments(tmp_path, device_route):
    seg1 = [(f"mmm{i}/f", "quick fox", []) for i in range(3)]
    seg2 = [(f"aaa{i}/f", "quick dog", []) for i in range(3)]
    segs = [(_write(tmp_path / "s1", seg1), Seq(1)), (_write(tmp_path / "s2", seg2), Seq(2))]
    je, te = _pair(segs, deletions=[("mmm1/", Seq(2))])
    assert te.key_prefix_postings(["aaa1/"]).tolist() == je.key_prefix_postings(["aaa1/"]).tolist()
    for kw in (dict(text="quick", top_k=10, key_prefixes=["aaa0/"]), dict(text="quick", top_k=10)):
        hits, _ = _search_both(je, te, **kw)
    assert all(not h.key.startswith("mmm1/") for h in hits)


def test_fuzzy_expansion_cap(tmp_path, device_route):
    docs = [(f"r{i:03d}/f", " ".join(f"w{j:04d}" for j in range(i, i + 5)), ["/t/t"]) for i in range(400)]
    docs += [(f"hot{i}/f", "w0042 filler", ["/t/t"]) for i in range(50)]
    je, te = _pair(_split(tmp_path, docs, 1))
    assert te.fuzzy_expand("w0041", 1) == je.fuzzy_expand("w0041", 1)
    assert len(te.fuzzy_expand("w0041", 1)) <= teng.MAX_EXPANSIONS
    _batch_both(je, te, [dict(text="w0041", fuzzy=True, top_k=20), dict(text="w0100 w0200", top_k=20)])


def test_host_queries_match_reference(tmp_path, device_route):
    je, te = _pair(_split(tmp_path, DOCS, 2))
    for did in range(te.n_docs):
        for phrase in (["lazy", "dog"], ["dog", "lazy"], ["quick", "brown", "fox"]):
            assert te.phrase_match(did, phrase) == je.phrase_match(did, phrase)
    assert te.phrase_match_many(list(range(te.n_docs)), ["lazy", "dog"]) == je.phrase_match_many(
        list(range(je.n_docs)), ["lazy", "dog"]
    )
    assert te.prefix_terms("qu") == je.prefix_terms("qu")
    assert te.term_df("quick") == je.term_df("quick") and te.idf(2) == je.idf(2)
    assert te.doc_facets() == je.doc_facets()
    assert te.filter_doc_ids(as_port(LabelAtom("/t/t"))).tolist() == je.filter_doc_ids(LabelAtom("/t/t")).tolist()
    q = dict(text="the quick lazy", top_k=5, all_terms=True, fuzzy=True)
    assert te._plan_terms(teng.TextQuery(**as_port(q))) == je._plan_terms(jeng.TextQuery(**q))


# ---------------------------------------------------------------------------
# golden scores (tests/test_golden_parity.py)
# ---------------------------------------------------------------------------

GOLDEN_DOCS = [("d0/f", "the cat sat", []), ("d1/f", "the cat cat meowed loudly", []), ("d2/f", "dogs bark", [])]


@pytest.mark.parametrize("route", ["device", "default"])
def test_golden_scores(tmp_path, monkeypatch, route):
    if route == "device":
        monkeypatch.setenv("NDBTPU_TEXT_HOST_TIER", "0")
    je, te = _pair(_split(tmp_path, GOLDEN_DOCS, 1))
    for text, want in (
        ("cat", {"d0/f": 0.4900511774, "d1/f": 0.5665797174}),
        ("cat sat", {"d0/f": 1.5127167493, "d1/f": 0.5665797174}),
        ("cat cat", {"d0/f": 0.4900511774, "d1/f": 0.5665797174}),
    ):
        hits, _ = _search_both(je, te, text=text, top_k=10)
        got = {h.key: h.score for h in hits}
        assert set(got) == set(want)
        for key, score in want.items():
            np.testing.assert_allclose(got[key], score, rtol=1e-6)
    _search_both(je, te, text="cta", top_k=5, fuzzy=True)


# ---------------------------------------------------------------------------
# incremental refresh and groups (tests/test_text_incremental.py)
# ---------------------------------------------------------------------------

BASE_DOCS = DOCS[:4]
DELTA_DOCS = [
    ("r5/f1", "a quick zebra naps beside the dog", ["/t/t"]),
    ("r6/f1", "quasar zebra observations", ["/t/a"]),
]
INC_QUERIES = [
    dict(text="quick dog", top_k=10),
    dict(text="zebra", top_k=10),
    dict(text="quick zebra", top_k=10, all_terms=True),
    dict(text="quasat", top_k=10, fuzzy=True),
    dict(text="quick", top_k=10, filter=LabelAtom("/t/a")),
    dict(text="sleeps naps", top_k=10),
]


def _same_layout(je, te):
    """Groups, widths, padding, term tiers and score space as the JAX
    engine's."""
    assert te.n_pad == je.n_pad and te.n_docs == je.n_docs
    np.testing.assert_array_equal(te.group_offsets, je.group_offsets)
    assert len(te.groups) == len(je.groups)
    for tg, jg in zip(te.groups, je.groups):
        assert (tg.widths, tg.n_pad, tg.n_docs, tg.sig) == (jg.widths, jg.n_pad, jg.n_docs, jg.sig)
        assert tg.term_info == jg.term_info
        assert [tuple(t.shape) for t, _, _ in tg.tiers_dev] == [tuple(t.shape) for t, _, _ in jg.tiers_dev]
        for (td, tt, tl), (jd, jt, jl) in zip(tg.tiers_dev, jg.tiers_dev):
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        if jg.dense_dev is not None and jg.dense_dev.shape[0] and tg.dense_dev is not None:
            np.testing.assert_array_equal(tg.dense_dev.numpy(), np.asarray(jg.dense_dev))
        else:
            assert tg.dense_dev is None
    np.testing.assert_array_equal(te.base_mask_device().numpy(), np.asarray(je.base_mask_device()))


def test_incremental_matches_reference(tmp_path, device_route):
    s1 = (_write(tmp_path / "s1", BASE_DOCS), Seq(1))
    s2 = (_write(tmp_path / "s2", DELTA_DOCS, created0=2000), Seq(2))
    dels = [("r1/f2", Seq(3))]
    base = _pair([s1])
    base[0].base_mask_device(), base[1].base_mask_device()  # cached: the refresh splices it
    inc = _pair([s1, s2], dels, prev=base)
    full = _pair([s1, s2], dels)
    assert inc[1].reused_groups == inc[0].reused_groups == 1
    assert inc[1].groups[0] is base[1].groups[0]
    _same_layout(*inc)
    for kw in INC_QUERIES:
        _search_both(*inc, **kw)
        t_inc = inc[1].search(teng.TextQuery(**as_port(kw)))
        t_full = full[1].search(teng.TextQuery(**as_port(kw)))
        assert [(h.key, h.score) for h in t_inc[0]] == [(h.key, h.score) for h in t_full[0]]
        np.testing.assert_array_equal(t_inc[1], t_full[1])
    _batch_both(*inc, [kw for kw in INC_QUERIES])
    assert inc[1].has_term("zebra") and inc[1].term_df("quick") == inc[0].term_df("quick")
    assert inc[1].fuzzy_expand("quasat", 1) == inc[0].fuzzy_expand("quasat", 1)


def test_upload_bytes_scale_with_delta(tmp_path, device_route):
    rng = np.random.default_rng(0)
    vocab = [f"w{i:04d}" for i in range(400)]
    big = [(f"rb{i:05d}/f1", " ".join(rng.choice(vocab, size=20)), []) for i in range(3000)]
    delta = [(f"rd{i:05d}/f1", " ".join(rng.choice(vocab, size=20)), []) for i in range(30)]
    s1 = (_write(tmp_path / "s1", big), Seq(1))
    s2 = (_write(tmp_path / "s2", delta), Seq(2))
    before = teng.UPLOAD_BYTES
    base = _pair([s1])
    full_cost = teng.UPLOAD_BYTES - before
    before = teng.UPLOAD_BYTES
    inc = _pair([s1, s2], prev=base)
    inc_cost = teng.UPLOAD_BYTES - before
    assert inc[1].reused_groups == 1
    assert inc_cost < full_cost / 10, (inc_cost, full_cost)
    _same_layout(*inc)
    _batch_both(*inc, [dict(text=f"{vocab[0]} {vocab[1]}", top_k=10), dict(text=vocab[7], top_k=50)])


def test_group_freeze_and_merge_reuse(tmp_path, monkeypatch, device_route):
    for mod in (jeng, teng):
        monkeypatch.setattr(mod, "GROUP_MIN_DOCS", 4)
        monkeypatch.setattr(mod, "FRESH_FREEZE_DOCS", 4)
    rng = np.random.default_rng(2)
    vocab = [f"w{i:03d}" for i in range(100)]

    def docs(prefix, n):
        return [(f"{prefix}{i:03d}/f1", " ".join(rng.choice(vocab, size=12)), []) for i in range(n)]

    runs = [docs(f"r{j}", 5) for j in range(4)]
    segs = [(_write(tmp_path / f"s{j}", d), Seq(j + 1)) for j, d in enumerate(runs)]
    e = _pair(segs[:1])
    for j in range(1, 4):
        e = _pair(segs[: j + 1], prev=e)
    assert len(e[1].groups) == 4 and e[1].reused_groups == e[0].reused_groups == 3
    merged = (_write(tmp_path / "m01", runs[0] + runs[1]), Seq(5))
    em = _pair([merged] + [(p, Seq(i + 3)) for i, (p, _) in enumerate(segs[2:])], prev=e)
    assert em[1].reused_groups == em[0].reused_groups == 2 and len(em[1].groups) == 3
    smalls = [(_write(tmp_path / f"sm{j}", docs(f"q{j}", 3)), Seq(10 + j)) for j in range(3)]
    base_list = [merged] + [(p, Seq(i + 3)) for i, (p, _) in enumerate(segs[2:])]
    e1 = _pair(base_list + smalls[:1], prev=em)
    e2 = _pair(base_list + smalls[:2], prev=e1)
    e3 = _pair(base_list + smalls, prev=e2)
    for pair, n_groups, reused in ((e1, 4, 3), (e2, 4, 3), (e3, 5, 4)):
        assert (len(pair[1].groups), pair[1].reused_groups) == (n_groups, reused)
        _same_layout(*pair)
    kws = [dict(text="w001 w002", top_k=20), dict(text=f"{vocab[11]} {vocab[13]}", top_k=20)]
    _batch_both(*em, kws)
    _batch_both(*e3, kws)
    for h in e3[1].search(teng.TextQuery(text=vocab[1], top_k=5))[0]:
        sidx, soff = e3[1].doc_seg[h.doc_id]
        assert e3[1].segments[sidx].keys[h.doc_id - soff] == h.key


def test_dense_windows_match_reference(tmp_path, monkeypatch, device_route):
    """Dense blocks of a middle group (full widths shrunk) and of the fresh
    group (overlay widths shrunk) window into the score space."""
    for mod in (jeng, teng):
        monkeypatch.setattr(mod, "TIER_WIDTHS", (2, 4))
        monkeypatch.setattr(mod, "TIER_QUERY_CAP", (4, 4))
        monkeypatch.setattr(mod, "FRESH_FREEZE_DOCS", 6)
        monkeypatch.setattr(mod, "OVERLAY_TIER_WIDTHS", (2, 4))
        monkeypatch.setattr(mod, "OVERLAY_QUERY_CAP", (4, 4))
    g0 = [(f"ra{i:03d}/f1", "zebra stripes " + ("zebra " * (i % 3)), []) for i in range(8)]
    g1 = [("rb000/f1", "zebra savanna grass", []), ("rb001/f1", "plain grass", [])]
    g2 = [(f"rc{i:03d}/f1", "zebra herd " + ("grass " * (i % 4)), []) for i in range(5)]
    s0, s1, s2 = ((_write(tmp_path / n, d), Seq(i + 1)) for i, (n, d) in enumerate((("s0", g0), ("s1", g1), ("s2", g2))))
    e0 = _pair([s0])
    e = _pair([s0, s1, s2], prev=e0)
    assert len(e[1].groups) == 2 and e[1].groups[0].dense_dev is not None
    assert e[1].groups[1].dense_dev is not None
    _same_layout(*e)
    kws = [dict(text=t, top_k=16) for t in ("zebra", "zebra grass", "grass", "herd stripes")]
    kws.append(dict(text="zebra grass", top_k=16, all_terms=True))
    for kw in kws:
        _search_both(*e, **kw)
    _batch_both(*e, kws)


def test_adaptive_caps_score_all_terms(tmp_path, device_route):
    rng = np.random.default_rng(1)
    vocab = [f"t{i:03d}" for i in range(60)]
    docs = [(f"r{i:03d}/f1", " ".join(rng.choice(vocab, size=12)), []) for i in range(50)]
    segs = [(_write(tmp_path / "s", docs), Seq(1)), (_write(tmp_path / "s2", [("rall/f1", " ".join(vocab[:40]), [])]), Seq(2))]
    e = _pair(segs)
    _search_both(*e, text=" ".join(vocab[:48]), top_k=50)
    hits, _ = _search_both(*e, text=" ".join(vocab[:40]), top_k=5, all_terms=True)
    assert "rall/f1" in {h.key for h in hits}


# ---------------------------------------------------------------------------
# the two faults of ROADMAP Queue 3
# ---------------------------------------------------------------------------


def test_padded_tier_and_empty_slot_score_as_reference():
    """A tier padded with -1 lanes and an empty (-1) query slot: the JAX
    program drops them (mode="drop"); the port's sends them to its sink
    column. Same scores, counts and matches, no index error."""
    rng = np.random.default_rng(4)
    L = 64
    docs = np.full((3, 8), -1, np.int32)
    docs[0, :5] = [1, 4, 9, 20, 33]
    docs[1, :3] = [4, 5, 60]
    docs[2, :8] = np.arange(10, 18)
    tfs = rng.integers(1, 5, (3, 8)).astype(np.float32)
    dls = rng.integers(1, 30, (3, 8)).astype(np.float32)
    dense = np.zeros((2, 32), np.uint8)
    dense[0, ::3] = 2
    dl = rng.integers(1, 30, 32).astype(np.float32)
    rows = np.array([[0, -1, 1, 0], [2, 1, -1, -1]], np.int32)  # 3 tier slots + 1 dense slot
    idfs = np.array([[1.5, 0.7, 0.9, 0.3], [0.4, 2.0, 1.0, 1.0]], np.float32)
    params = np.array([[12.0, 1.0, -3.0e38], [12.0, 2.0, 0.1]], np.float32)
    mask = np.ones(L, bool)
    mask[33] = False
    caps, tier_counts = (3, 1), (1,)
    jgroups = (((jeng.jnp.asarray(docs), jeng.jnp.asarray(tfs), jeng.jnp.asarray(dls)),), jeng.jnp.asarray(dense), jeng.jnp.asarray(dl)),
    tgroups = (((torch.from_numpy(docs), torch.from_numpy(tfs), torch.from_numpy(dls)),), torch.from_numpy(dense), torch.from_numpy(dl)),
    for with_counts in (False, True):
        js, jic, jm = jeng._bm25_groups_batch(
            jgroups, jeng.jnp.asarray(np.array([0], np.int32)), jeng.jnp.asarray(mask),
            jeng.jnp.asarray(rows), jeng.jnp.asarray(idfs), jeng.jnp.asarray(params), 6, caps, tier_counts,
            shared_mask=True, with_counts=with_counts,
        )
        ts, tic, tm = bm25.bm25_groups_batch(
            tgroups, (0,), torch.from_numpy(mask), torch.from_numpy(rows), torch.from_numpy(idfs),
            torch.from_numpy(params), 6, caps, tier_counts, shared_mask=True, with_counts=with_counts,
        )
        assert_same_results(np.asarray(js), np.asarray(jic)[:, :6], ts.numpy(), tic.numpy()[:, :6])
        np.testing.assert_array_equal(tic.numpy()[:, 6:], np.asarray(jic)[:, 6:])
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_clipped_dense_tf_on_each_route(tmp_path, monkeypatch):
    """A paragraph repeating a dense term 300 times: the device route clips
    its tf at 255 as the JAX device route does, the host route scores the
    exact tf as the JAX host tier does."""
    docs = [(f"r{i:03d}/f", ("common " if i % 4 == 0 else "") + "word " + "filler " * (i % 5), []) for i in range(40)]
    docs.append(("rep/f", "common " * 300, []))
    monkeypatch.setattr(jeng, "TIER_WIDTHS", (4, 8))
    monkeypatch.setattr(teng, "TIER_WIDTHS", (4, 8))
    segs = [(_write(tmp_path / "s", docs), Seq(1))]
    kw = dict(text="common", top_k=20)
    monkeypatch.setenv("NDBTPU_TEXT_HOST_TIER", "0")
    je, te = _pair(segs)
    assert te.groups[0].term_info["common"][0] == -1  # a dense row
    dev, _ = _search_both(je, te, **kw)
    monkeypatch.setenv("NDBTPU_TEXT_HOST_TIER", "1")
    je, te = _pair(segs)
    host, _ = _search_both(je, te, **kw)
    if tht.host_tier_for(te) is not None:
        rep = {h.key: h.score for h in host}["rep/f"]
        assert rep > {h.key: h.score for h in dev}["rep/f"]  # the exact tf scores higher


# ---------------------------------------------------------------------------
# a zipf corpus in several groups, batched, on both routes
# ---------------------------------------------------------------------------


def _zipf_corpus(rng, n, vocab):
    ids = np.minimum(rng.zipf(1.3, size=(n, 12)) - 1, len(vocab) - 1)
    return [" ".join(vocab[j] for j in row) for row in ids]


@pytest.mark.parametrize("route", ["device", "default"])
def test_zipf_batches_match_reference(tmp_path, monkeypatch, route):
    if route == "device":
        monkeypatch.setenv("NDBTPU_TEXT_HOST_TIER", "0")
    for mod in (jeng, teng):
        monkeypatch.setattr(mod, "GROUP_MIN_DOCS", 600)
        monkeypatch.setattr(mod, "TIER_WIDTHS", (8, 32, 128))
    rng = np.random.default_rng(5)
    vocab = [f"v{i:03d}x" for i in range(300)]
    texts = _zipf_corpus(rng, 1500, vocab)
    docs = [(f"r{i:04d}/f", t, ["/l/tenth"] if i % 10 == 0 else []) for i, t in enumerate(texts)]
    segs = [
        (_write(tmp_path / "a", docs[:700]), Seq(1)),
        (_write(tmp_path / "b", docs[700:1400]), Seq(2)),
        (_write(tmp_path / "c", docs[1400:]), Seq(3)),
    ]
    je, te = _pair(segs, deletions=[("r0042/", Seq(4))])
    assert len(te.groups) == 3 and te.groups[0].dense_dev is not None
    q = np.random.default_rng(6)
    kws = []
    for i in range(24):
        a, b = vocab[int(q.integers(0, 60))], vocab[int(q.integers(0, 60))]
        kws.append(dict(text=f"{a} {b} v00{i % 10}y", top_k=20, fuzzy=True))
    ands = [dict(text=f"{vocab[i]} {vocab[i + 1]}", top_k=20, all_terms=True, fuzzy=bool(i % 2)) for i in range(8)]
    # one mixed batch (OR queries under the AND batch's count scatter)
    _batch_both(je, te, kws + ands, need_matched=False)
    filtered = [dict(kw, filter=LabelAtom("/l/tenth")) for kw in kws[:4]]
    filtered += [dict(kws[4], key_prefixes=["r01"]), dict(kws[5], min_score=2.0), dict(kws[6], excluded=[vocab[3]])]
    _batch_both(je, te, filtered)
    for kw in filtered[:1] + ands[:1]:
        _search_both(je, te, **kw)
