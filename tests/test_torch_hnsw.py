"""The port's graph ANN (``nucliadb_tpu_torch.ops.hnsw``) and its ``hnsw``
strategy against the JAX package's, on the CPU.

- **Exact data**: dot similarity over entries k/4 with |k| <= 3 at D = 32,
  so every product and sum is exact in f32 whatever the order. There the
  graph build (adjacency and entry set), the heuristic's kept mask, the
  wave chunks and the beam search (ids and scores: unfiltered, filtered
  with extra trips, with a floor, stitched components) are equal element
  for element.
- **Clustered data** (the cases of ``tests/test_hnsw.py``,
  ``tests/test_vector_hnsw_strategy.py``, the ``hnsw`` cases of
  ``tests/test_vector_matrix.py`` and the dedup case of
  ``tests/test_vector_search.py``): each package's recall against a float64
  oracle, which must agree within 0.01.
- **Segments crossing the packages**: a graph written by either package
  opens in the other without a rebuild and gives the same answers; so does
  a node shard over one metadata file and blob store.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nucliadb_tpu.index.vector.segment as jsegment
import nucliadb_tpu_torch.index.vector.segment as tsegment
from nucliadb_tpu.index import vector as jvector
from nucliadb_tpu.ops import hnsw as jh
from nucliadb_tpu.types import Seq as JSeq, SimpleOpenIndex as JSimpleOpenIndex
from nucliadb_tpu_torch.index import vector as tvector
from nucliadb_tpu_torch.ops import hnsw as th

NEG = float(np.float32(-3.0e38))
RECALL_GAP = 0.01


def exact_data(rng, n, d=32):
    return (rng.integers(-3, 4, (n, d)) / 4).astype(np.float32)


def clustered(rng, n, d, centers=20, noise=0.3, center_vecs=None):
    """tests/test_hnsw.py's data: clustered rows, L2-normalised."""
    if center_vecs is None:
        center_vecs = rng.standard_normal((centers, d)).astype(np.float32)
    v = center_vecs[rng.integers(0, len(center_vecs), n)] + noise * rng.standard_normal((n, d)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32), center_vecs


def padded(v, adj, n_pad):
    n = v.shape[0]
    arena = np.zeros((n_pad, v.shape[1]), np.float32)
    arena[:n] = v
    return arena, np.pad(adj, ((0, n_pad - n), (0, 0)), constant_values=-1)


def both_search(arena, adj, entry, q, mask, k, min_score=NEG, **kw):
    """(JAX ids, JAX scores, port ids, port scores) of one search."""
    js, ji = jh.hnsw_search(
        jnp.asarray(arena), jnp.asarray(adj), jnp.asarray(entry), jnp.asarray(q), jnp.asarray(mask),
        jnp.float32(min_score), k,
        **{key: (jnp.asarray(v) if key == "seg_of" else v) for key, v in kw.items()},
    )
    ts, ti = th.hnsw_search(
        torch.from_numpy(arena), torch.from_numpy(adj), torch.from_numpy(entry), torch.from_numpy(q),
        torch.from_numpy(mask), min_score, k,
        **{key: (torch.from_numpy(v) if key == "seg_of" else v) for key, v in kw.items()},
    )
    return np.asarray(ji), np.asarray(js), ti.numpy(), ts.numpy()


def recall(ids, oracle_scores, k, allowed=None):
    out = []
    for b in range(ids.shape[0]):
        s = oracle_scores[b] if allowed is None else np.where(allowed, oracle_scores[b], -np.inf)
        kk = min(k, int(np.isfinite(s).sum()))
        exact = set(np.argsort(-s)[:kk].tolist())
        out.append(len(exact & {x for x in ids[b].tolist() if x >= 0}) / kk)
    return float(np.mean(out))


# --------------------------------------------------------------------------
# exact data: equal element for element
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n,wave,seed,native",
    [(20, 1024, 0, True), (600, 128, 1, True), (3000, 256, 2, True), (8000, 1024, 4, True), (700, 128, 3, False)],
)
def test_build_graph_equals_jax(n, wave, seed, native, monkeypatch):
    """Adjacency and entry set equal: the bootstrap wave alone (n = 20),
    several chunks of 8 waves with a ragged last wave, a farthest-point
    entry set (up to 256 entries, n <= 7,680) and a random one (n = 8,000),
    and the Python linker in place of the native one."""
    if not native:
        monkeypatch.setattr(jh, "_native", None)
        monkeypatch.setattr(th, "_native", None)
    v = exact_data(np.random.default_rng(seed), n)
    ja, je = jh.build_graph(v, wave=wave, seed=seed)
    builds = th.BUILDS["graph"]
    ta, te = th.build_graph(v, wave=wave, seed=seed, device="cpu")
    assert th.BUILDS["graph"] == builds + 1
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(te, je)
    assert ta.dtype == np.int32 and te.dtype == np.int32


def test_heuristic_select_equals_jax():
    """The kept mask over planted ties (repeated candidate vectors) and
    invalid candidates."""
    rng = np.random.default_rng(4)
    w, c, d = 24, 40, 32
    vecs = exact_data(rng, w * c, d).reshape(w, c, d)
    vecs[:, 7] = vecs[:, 3]  # a repeated candidate
    q = exact_data(rng, w, d)
    scores = np.einsum("wd,wcd->wc", q, vecs).astype(np.float32)
    valid = rng.random((w, c)) > 0.15
    scores = np.where(valid, scores, np.float32(-3.0e38)).astype(np.float32)
    order = np.argsort(-scores, axis=1, kind="stable")
    scores = np.take_along_axis(scores, order, 1)
    vecs = np.take_along_axis(vecs, order[:, :, None], 1)
    valid = np.take_along_axis(valid, order, 1)
    want = np.asarray(jh._heuristic_select(jnp.asarray(scores), jnp.asarray(vecs), jnp.asarray(valid)))
    got = th._heuristic_select(torch.from_numpy(scores), torch.from_numpy(vecs), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def test_waves_chunk_equals_jax():
    """Candidate ids, kept masks and the inserted mask after three waves,
    the last one padded with repeated ids."""
    rng = np.random.default_rng(5)
    n, n_pad, ef = 900, 1024, 40
    arena = np.zeros((n_pad, 32), np.float32)
    arena[:n] = exact_data(rng, n)
    order = rng.permutation(n)
    mask = np.zeros(n_pad, bool)
    mask[order[:200]] = True
    waves = [order[200:328], order[328:456], np.pad(order[456:500], (0, 84), mode="edge")]
    ids = np.stack(waves).astype(np.int32)
    jc, jk, jm = jh._waves_chunk(jnp.asarray(arena), jnp.asarray(mask), jnp.asarray(ids), ef)
    tmask = torch.from_numpy(mask.copy())
    tc, tk = th._waves_chunk(torch.from_numpy(arena), tmask, torch.from_numpy(ids.astype(np.int64)), ef)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jm))


@pytest.fixture(scope="module")
def exact_graph():
    rng = np.random.default_rng(6)
    n, n_pad = 2500, 4096
    v = exact_data(rng, n)
    adj, entry = jh.build_graph(v, wave=256, seed=6)
    arena, adj_p = padded(v, adj, n_pad)
    return v, arena, adj_p, entry, exact_data(rng, 24)


SEARCH_CASES = {
    "unfiltered": dict(k=10),
    "filter_20pct": dict(k=10, select=0.2),
    "filter_3pct": dict(k=10, select=0.03),
    "block_of_5": dict(k=10, block=5),  # fewer than k pass: the loop runs to max_trips
    "small_beam": dict(k=10, select=0.006, ef=8, trips=2, max_trips=9),
    "min_score": dict(k=10, min_score=4.25),
    "k_above_ef": dict(k=64),
}


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_hnsw_search_equals_jax(exact_graph, case):
    """Ids and scores equal, and the port ran as many trips as JAX's loop
    (extra trips under a selective filter, up to ``max_trips``)."""
    v, arena, adj, entry, q = exact_graph
    kw = dict(SEARCH_CASES[case])
    n = v.shape[0]
    rng = np.random.default_rng(7)
    mask = np.zeros(arena.shape[0], bool)
    if "select" in kw:
        mask[:n] = rng.random(n) < kw.pop("select")
    elif "block" in kw:
        mask[100 : 100 + kw.pop("block")] = True
    else:
        mask[:n] = True
    k = kw.pop("k")
    min_score = kw.pop("min_score", NEG)
    th.SEARCHES.clear()
    ji, js, ti, ts = both_search(arena, adj, entry, q, mask, k, min_score, **kw)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)
    trips = th.SEARCHES["trips"]
    if case == "block_of_5":
        assert trips == th.SEARCH_TRIPS_MAX and (ti[:, 5:] == -1).all() and (ti[:, 0] >= 0).all()
    elif case == "small_beam":
        assert 2 < trips <= 9
    else:
        assert trips >= th.SEARCH_TRIPS
    assert th.SEARCHES["search"] == 1
    if case == "min_score":
        assert (ts[ti >= 0] >= 4.25).all() and (ti == -1).any() and (ti >= 0).any()


@pytest.mark.parametrize("select", [1.0, 0.25])
def test_stitched_search_equals_jax(select):
    """Two graphs built apart and stitched (``n_segments = 2``, ``seg_of``):
    per-component beam slots, ids and scores equal."""
    rng = np.random.default_rng(8)
    parts = [exact_data(rng, 700), exact_data(rng, 500)]
    adjs, entries, off = [], [], 0
    for p in parts:
        a, e = jh.build_graph(p, wave=128)
        adjs.append(np.where(a >= 0, a + off, -1))
        entries.append(e + off)
        off += p.shape[0]
    v = np.concatenate(parts)
    arena, adj = padded(v, np.concatenate(adjs).astype(np.int32), 2048)
    seg_of = np.zeros(2048, np.int32)
    seg_of[700:1200] = 1
    mask = np.zeros(2048, bool)
    mask[:1200] = rng.random(1200) < select
    q = exact_data(rng, 12)
    ji, js, ti, ts = both_search(
        arena, adj, np.concatenate(entries).astype(np.int32), q, mask, 10, seg_of=seg_of, n_segments=2
    )
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)


def test_search_without_the_visited_table(exact_graph, monkeypatch):
    """Above the visited table's threshold the port walks without it, as
    the JAX package does past 64 Mi entries: a re-visited node scores the
    same and collapses in the cut, so the answers stay duplicate-free and
    find the query's own row."""
    v, arena, adj, entry, _ = exact_graph
    monkeypatch.setattr(th, "VISITED_MAX", 0)
    q = v[[3, 1500, 2400]]
    mask = np.arange(arena.shape[0]) < v.shape[0]
    ts, ti = th.hnsw_search(
        torch.from_numpy(arena), torch.from_numpy(adj), torch.from_numpy(entry), torch.from_numpy(q),
        torch.from_numpy(mask), NEG, 10,
    )
    oracle = q @ v.T
    for b, row in enumerate(ti.numpy()):
        assert len(set(row.tolist())) == 10
        assert ts.numpy()[b, 0] == oracle[b].max()


# --------------------------------------------------------------------------
# clustered data: recall against a float64 oracle, within 0.01 of JAX's
# --------------------------------------------------------------------------


def test_hnsw_recall_vs_bruteforce(rng):
    """tests/test_hnsw.py:29: recall >= 0.95 on clustered data, in both."""
    n, d, b, k = 2000, 64, 16, 10
    v, centers = clustered(rng, n, d)
    q, _ = clustered(rng, b, d, center_vecs=centers)
    adj, entry = jh.build_graph(v, wave=256, seed=2)
    tadj, tentry = th.build_graph(v, wave=256, seed=2, device="cpu")
    arena, adj_p = padded(v, adj, 2048)
    _, tadj_p = padded(v, tadj, 2048)
    mask = np.arange(2048) < n
    ji, _, _, _ = both_search(arena, adj_p, entry, q, mask, k)
    _, _, ti, _ = both_search(arena, tadj_p, tentry, q, mask, k)
    oracle = q.astype(np.float64) @ v.astype(np.float64).T
    rj, rt = recall(ji, oracle, k), recall(ti, oracle, k)
    assert rt >= 0.95 and abs(rt - rj) <= RECALL_GAP, (rt, rj)


def test_hnsw_filtered_search(rng):
    """tests/test_hnsw.py:90: filtered recall >= 0.9 at 10-50 % selectivity
    and a contiguous block, only mask-passing results, in both (the same
    draws as that test)."""
    n, d = 2000, 32
    v, centers = clustered(rng, n, d)
    adj, entry = th.build_graph(v, wave=256, seed=3, device="cpu")
    arena, adj_p = padded(v, adj, 2048)
    block = np.zeros(n, bool)
    block[:300] = True
    for selectivity in (0.1, 0.2, 0.5, None):
        allowed = block if selectivity is None else rng.random(n) < selectivity
        q, _ = clustered(rng, 8, d, center_vecs=centers)
        mask = np.zeros(2048, bool)
        mask[:n] = allowed
        ji, _, ti, _ = both_search(arena, adj_p, entry, q, mask, 10)
        assert allowed[ti[ti >= 0]].all()
        oracle = q.astype(np.float64) @ v.astype(np.float64).T
        rj, rt = recall(ji, oracle, 10, allowed), recall(ti, oracle, 10, allowed)
        assert rt >= 0.9 and abs(rt - rj) <= RECALL_GAP, (selectivity, rt, rj)


def test_hnsw_no_duplicate_results(rng):
    v, centers = clustered(rng, 300, 16)
    q, _ = clustered(rng, 2, 16, center_vecs=centers)
    adj, entry = th.build_graph(v, wave=128, device="cpu")
    arena, adj_p = padded(v, adj, 512)
    _, _, ti, _ = both_search(arena, adj_p, entry, q, np.arange(512) < 300, 10)
    for row in ti:
        real = [x for x in row.tolist() if x >= 0]
        assert len(real) == len(set(real)) == 10


def test_node_zero_and_last_node_are_retrievable(rng):
    """-1 pads in the visited scatter must neither hide node 0 nor (with no
    padding row) node n_pad - 1: the spare column takes them."""
    v, _ = clustered(rng, 1000, 32)
    adj, entry = th.build_graph(v, wave=256, seed=5, device="cpu")
    arena, adj_p = padded(v, adj, 1024)
    _, _, ti, _ = both_search(arena, adj_p, entry, v[0:1], np.arange(1024) < 1000, 10)
    assert 0 in ti[0].tolist()
    w = rng.standard_normal((256, 32)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    adj, entry = th.build_graph(w, device="cpu")
    _, _, ti, _ = both_search(w, adj, entry, w[255:256], np.ones(256, bool), 5)
    assert int(ti[0, 0]) == 255


def test_default_search_params_scale_with_corpus():
    for n in (50_000, 200_000, 1_000_000):
        assert th.default_search_params(n) == jh.default_search_params(n)
    assert th.default_search_params(1_000_000) == (th.EF_SEARCH_WIDE, th.SEARCH_TRIPS_WIDE)


def test_searcher_graph_path_uses_scaled_default(rng, tmp_path, monkeypatch):
    """tests/test_hnsw.py:190: the index passes the size-scaled regime."""
    seen = {}
    real = th.hnsw_search

    def spy(*args, **kwargs):
        seen.update(ef=kwargs.get("ef"), trips=kwargs.get("trips"))
        return real(*args, **kwargs)

    monkeypatch.setattr(th, "hnsw_search", spy)
    monkeypatch.setattr(th, "EF_WIDE_THRESHOLD", 100)
    v = rng.standard_normal((256, 16)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    cfg = tvector.VectorConfig(dimension=16, flags=["hnsw"])
    meta = tsegment.create_segment(
        str(tmp_path / "seg"), [tvector.Elem(key=f"r/{i:05d}", vectors=v[i : i + 1]) for i in range(256)], cfg,
        device="cpu",
    )
    searcher = tvector.VectorSearcher(cfg, tvector.SimpleOpenIndex(segment_list=[(meta, tvector.Seq(1))]), device="cpu")
    searcher.search(tvector.VectorSearchRequest(vectors=rng.standard_normal((2, 16)).astype(np.float32), top_k=5))
    assert seen == {"ef": th.EF_SEARCH_WIDE, "trips": th.SEARCH_TRIPS_WIDE}


# --------------------------------------------------------------------------
# the hnsw strategy through the vector index
# --------------------------------------------------------------------------


def _segments(mod, tmp, v, cfg, parts, **kw):
    metas, lo = [], 0
    for s, size in enumerate(parts):
        elems = [mod.Elem(key=f"r/{i:05d}", vectors=v[i : i + 1]) for i in range(lo, lo + size)]
        metas.append(mod.create_segment(str(tmp / f"s{s}"), elems, cfg, **kw))
        lo += size
    return metas


def _searchers(tmp_path, v, parts, flags=("hnsw",), similarity="dot"):
    """Both packages' searchers, each over segments its own package wrote."""
    jcfg = jvector.VectorConfig(dimension=v.shape[1], flags=list(flags), similarity=similarity)
    tcfg = tvector.VectorConfig(dimension=v.shape[1], flags=list(flags), similarity=similarity)
    jm = _segments(jsegment, tmp_path / "jax", v, jcfg, parts)
    tm = _segments(tsegment, tmp_path / "port", v, tcfg, parts, device="cpu")
    js = jvector.VectorSearcher(jcfg, JSimpleOpenIndex(segment_list=[(m, JSeq(i + 1)) for i, m in enumerate(jm)]))
    ts = tvector.VectorSearcher(
        tcfg, tvector.SimpleOpenIndex(segment_list=[(m, tvector.Seq(i + 1)) for i, m in enumerate(tm)]), device="cpu"
    )
    return js, ts


def _key_recall(hits, oracle, k):
    return float(np.mean([
        len({f"r/{i:05d}" for i in np.argsort(-oracle[b])[:k]} & {h.key for h in hits[b]}) / k
        for b in range(len(hits))
    ]))


def _strategy_recalls(js, ts, q, oracle, k=10):
    jh_ = js.search(jvector.VectorSearchRequest(vectors=q, top_k=k))
    th_ = ts.search(tvector.VectorSearchRequest(vectors=q, top_k=k))
    return _key_recall(jh_, oracle, k), _key_recall(th_, oracle, k)


def _clustered_rows(rng, n, d, centers, noise=0.3, normalize=True):
    c = rng.standard_normal((centers, d)).astype(np.float32)
    v = c[rng.integers(0, centers, n)] + noise * rng.standard_normal((n, d)).astype(np.float32)
    q = c[rng.integers(0, centers, 4)] + noise * rng.standard_normal((4, d)).astype(np.float32)
    if normalize:
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return v, q


def test_hnsw_strategy_end_to_end(rng, tmp_path):
    """tests/test_vector_hnsw_strategy.py:13, in both packages."""
    v, q = _clustered_rows(rng, 1500, 32, 15)
    js, ts = _searchers(tmp_path, v, [1500])
    assert ts.index.graph is not None and ts.index.graph.n_segments == 1
    assert not ts.index.host_resident()
    rj, rt = _strategy_recalls(js, ts, q, q.astype(np.float64) @ v.astype(np.float64).T)
    assert rt >= 0.9 and abs(rt - rj) <= RECALL_GAP, (rt, rj)


def test_hnsw_graph_persisted_and_stitched(rng, tmp_path):
    """tests/test_vector_hnsw_strategy.py:63: each segment holds its graph
    and the index stitches them (two components) without a build."""
    v, q = _clustered_rows(rng, 800, 32, 10)
    tcfg = tvector.VectorConfig(dimension=32, flags=["hnsw"])
    metas = _segments(tsegment, tmp_path, v, tcfg, [400, 400], device="cpu")
    for meta in metas:
        seg = tsegment.open_segment(meta.path)
        assert seg.hnsw_adj is not None and seg.hnsw_adj.shape[0] == 400 and (seg.hnsw_adj < 400).all()
    builds = th.BUILDS["graph"]
    ts = tvector.VectorSearcher(
        tcfg, tvector.SimpleOpenIndex(segment_list=[(m, tvector.Seq(i + 1)) for i, m in enumerate(metas)]), device="cpu"
    )
    assert th.BUILDS["graph"] == builds and ts.index.graph.n_segments == 2
    # the JAX searcher over the port's segments stitches them too
    jcfg = jvector.VectorConfig(dimension=32, flags=["hnsw"])
    with mock.patch.object(jh, "build_graph", side_effect=AssertionError("rebuilt at load")):
        js = jvector.VectorSearcher(
            jcfg, JSimpleOpenIndex(segment_list=[(m, JSeq(i + 1)) for i, m in enumerate(metas)])
        )
    rj, rt = _strategy_recalls(js, ts, q, q.astype(np.float64) @ v.astype(np.float64).T)
    assert rt >= 0.9 and abs(rt - rj) <= RECALL_GAP, (rt, rj)
    # more than 8 segments: one graph is built over the arena
    nine = _segments(tsegment, tmp_path / "nine", v, tcfg, [80] * 9, device="cpu")
    idx = tvector.SimpleOpenIndex(segment_list=[(m, tvector.Seq(i + 1)) for i, m in enumerate(nine)])
    builds = th.BUILDS["graph"]
    ts = tvector.VectorSearcher(tcfg, idx, device="cpu")
    assert th.BUILDS["graph"] == builds + 1 and ts.index.graph.n_segments == 1


def test_graph_vs_scan_cost_model(rng, tmp_path):
    """tests/test_vector_hnsw_strategy.py:123: under a 5 % filter the scan
    answers (exact top-k, no walk); unfiltered, the graph does."""
    n, d, k = 1500, 32, 10
    v = rng.standard_normal((n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    _, ts = _searchers(tmp_path, v, [n])
    idx = ts.index
    assert idx._use_graph(idx.n_para, k) and not idx._use_graph(n // 20, k)
    mask = np.zeros(n, dtype=bool)
    chosen = rng.choice(n, n // 20, replace=False)
    mask[chosen] = True
    q = v[chosen[:3]] + 0.01 * rng.standard_normal((3, d)).astype(np.float32)
    searches = th.SEARCHES["search"]
    s, i = idx.search(q, k, para_mask=mask)
    assert th.SEARCHES["search"] == searches
    true = q.astype(np.float64) @ v.astype(np.float64).T
    true[:, ~mask] = -np.inf
    for b in range(3):
        assert set(int(x) for x in i[b] if x >= 0) == set(np.argsort(-true[b])[:k].tolist())
    idx.search(q, k)
    assert th.SEARCHES["search"] == searches + 1


@pytest.mark.parametrize("similarity", ["dot", "cosine"])
def test_search_matrix_hnsw(similarity, rng, tmp_path):
    """tests/test_vector_matrix.py's hnsw cases."""
    v, q = _clustered_rows(rng, 1200, 64, 12, normalize=similarity == "dot")
    js, ts = _searchers(tmp_path, v, [1200], similarity=similarity)
    vv, qq = v, q
    if similarity == "cosine":
        vv = v / np.linalg.norm(v, axis=-1, keepdims=True)
        qq = q / np.linalg.norm(q, axis=-1, keepdims=True)
    rj, rt = _strategy_recalls(js, ts, q, qq.astype(np.float64) @ vv.astype(np.float64).T)
    assert rt >= 0.85 and abs(rt - rj) <= RECALL_GAP, (rt, rj)


def test_with_duplicates_dedup_hnsw(rng, tmp_path):
    """tests/test_vector_search.py:330's hnsw case: one copy of a
    duplicated vector by default, every copy with ``with_duplicates``."""
    d = 32
    base = rng.standard_normal((64, d)).astype(np.float32)
    dup = base[0].copy()
    cfg = tvector.VectorConfig(dimension=d, flags=["hnsw"])
    elems = [tvector.Elem(key=f"r{i}/f1/{i}/0-10", vectors=base[i][None]) for i in range(64)]
    elems += [tvector.Elem(key=f"dup{j}/f1/{j}/0-10", vectors=dup[None]) for j in range(3)]
    meta = tsegment.create_segment(str(tmp_path / "s"), elems, cfg, device="cpu")
    searcher = tvector.VectorSearcher(cfg, tvector.SimpleOpenIndex(segment_list=[(meta, tvector.Seq(1))]), device="cpu")
    q = dup + 0.001 * rng.standard_normal(d).astype(np.float32)
    for with_dup, copies in ((False, 1), (True, 4)):
        searches = th.SEARCHES["search"]
        keys = [h.key for h in searcher.search(tvector.VectorSearchRequest(vectors=q, top_k=6, with_duplicates=with_dup))[0]]
        assert th.SEARCHES["search"] == searches + 1
        assert len([k for k in keys if k.startswith(("r0/", "dup"))]) == copies, keys


# --------------------------------------------------------------------------
# segments and node shards crossing the packages
# --------------------------------------------------------------------------


def test_graph_segments_cross_both_ways(tmp_path):
    """On exact data: the packages write byte-identical graph columns for
    the same elems, each opens the other's segments without a build, and
    the answers (unfiltered, 30 % filtered) are equal."""
    rng = np.random.default_rng(9)
    v = exact_data(rng, 1800)
    jcfg = jvector.VectorConfig(dimension=32, flags=["hnsw"])
    tcfg = tvector.VectorConfig(dimension=32, flags=["hnsw"])
    jm = _segments(jsegment, tmp_path / "jax", v, jcfg, [1000, 800])
    tm = _segments(tsegment, tmp_path / "port", v, tcfg, [1000, 800], device="cpu")
    for a, b in zip(jm, tm):
        for column in ("hnsw_adj.npy", "hnsw_entry.npy", "vectors.npy"):
            assert (tmp_path / "jax" / a.path.split("/")[-1] / column).read_bytes() == (
                tmp_path / "port" / b.path.split("/")[-1] / column
            ).read_bytes()
        assert a.index_metadata == b.index_metadata
    q = exact_data(rng, 8)
    allowed = rng.random(1800) < 0.3
    builds = th.BUILDS["graph"]
    port_over_jax = tvector.VectorSearcher(
        tcfg, tvector.SimpleOpenIndex(segment_list=[(as_seg, tvector.Seq(i + 1)) for i, as_seg in enumerate(jm)]),
        device="cpu",
    )
    assert th.BUILDS["graph"] == builds
    with mock.patch.object(jh, "build_graph", side_effect=AssertionError("rebuilt at load")):
        jax_over_port = jvector.VectorSearcher(
            jcfg, JSimpleOpenIndex(segment_list=[(m, JSeq(i + 1)) for i, m in enumerate(tm)])
        )
    for mask in (None, allowed):
        js, ji = jax_over_port.index.search(q, 10, para_mask=mask, with_duplicates=True)
        ts, ti = port_over_jax.index.search(q, 10, para_mask=mask, with_duplicates=True)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts, js)


def test_graph_index_from_reference_state(tmp_path):
    """A JAX index's graph carried across as numpy arrays answers as the
    JAX index does."""
    rng = np.random.default_rng(10)
    v = exact_data(rng, 1200)
    jcfg = jvector.VectorConfig(dimension=32, flags=["hnsw"])
    jm = _segments(jsegment, tmp_path, v, jcfg, [600, 600])
    ref = jvector.VectorSearcher(jcfg, JSimpleOpenIndex(segment_list=[(m, JSeq(i + 1)) for i, m in enumerate(jm)]))
    j = ref.index
    arrays = {
        "vectors": np.asarray(j.vectors), "alive": j.alive, "para_seg": j.para_seg,
        "hnsw_adj": np.asarray(j.graph.adj), "hnsw_entry_ids": np.asarray(j.graph.entry_ids),
        "hnsw_seg_of": np.asarray(j.graph.seg_of), "hnsw_n_segments": j.graph.n_segments,
    }
    idx = tvector.DeviceVectorIndex.from_reference_state(
        tvector.VectorConfig(dimension=32, flags=["hnsw"]), j.keys, j.para_meta, j.labels, j.seg_tags, j.seg_bounds,
        arrays, device="cpu",
    )
    q = exact_data(rng, 8)
    js, ji = j.search(q, 10)
    ts, ti = idx.search(q, 10)
    assert idx.graph.n_segments == 2
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)


def test_node_shard_with_graphs_crosses_both_ways(tmp_path):
    """One sqlite metadata file and one blob store shared by a JAX node and
    a port node, vectorset flagged hnsw: the port opens the JAX indexer's
    segments without a graph build, its worker merges them (one build, on
    the CPU), the JAX searcher opens the merged graph, and every answer
    equals the other package's."""
    from nucliadb_tpu.metadata import MetadataStore
    from nucliadb_tpu.services import EmbeddedNode
    from nucliadb_tpu.shard import ShardSearchRequest
    from nucliadb_tpu.storage import LocalStorage

    import nucliadb_tpu_torch.services as port_services
    from nucliadb_tpu_torch.metadata import MetadataStore as PortMetadataStore
    from nucliadb_tpu_torch.storage import LocalStorage as PortLocalStorage
    from tests.test_services import DIM, embed, make_resource
    from tests.torch_test_helpers import as_port, assert_same_response

    db, blobs = str(tmp_path / "meta.db"), str(tmp_path / "blobs")
    ref = EmbeddedNode(data_dir=str(tmp_path / "jax"), storage=LocalStorage(blobs), metadata=MetadataStore(db))
    port = port_services.EmbeddedNode(
        data_dir=str(tmp_path / "port"), storage=PortLocalStorage(blobs), metadata=PortMetadataStore(db), device="cpu"
    )
    sid = ref.create_shard("kb1", {"m1": jvector.VectorConfig(dimension=DIM, flags=["hnsw"])}, shard_id="s1")
    for i in range(6):
        ref.index(sid, make_resource(f"r{i}", f"document number {i} quick"))
    req = ShardSearchRequest(body="quick number", vector=embed("document number 1 quick"), top_k=10)

    def both_answer_alike():
        for node in (ref, port):
            node.wait_for_sync()
        resp = port.search(sid, as_port(req))
        assert_same_response(resp, ref.search(sid, req))
        return resp

    builds = th.BUILDS["graph"]
    assert both_answer_alike().vector
    assert th.BUILDS["graph"] == builds
    assert port.searcher.shard(sid).vectors["m1"].index.graph.n_segments == 6
    port.tick_background()
    assert th.BUILDS["graph"] == builds + 1  # the merged segment's graph
    with mock.patch.object(jh, "build_graph", side_effect=AssertionError("rebuilt at load")):
        both_answer_alike()
    assert port.searcher.shard(sid).vectors["m1"].index.graph.n_segments == 1
