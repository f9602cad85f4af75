"""The port's IVF (``nucliadb_tpu_torch.ops.ivf``) and its ``ivf`` strategy
against the JAX package's, on the CPU.

- **Exact data** (dot similarity over entries k/4, |k| <= 3): k-means'
  centroids and assignment, ``assign_all``, ``build_ivf``'s tables and
  ``ivf_search``'s ids and scores are equal element for element, at D = 32
  and at D = 1,536, where the int8 estimate runs as two chunks of the
  dimensions. A centroid after a Lloyd step is a mean, no longer a
  multiple of 1/4, so the two packages' f32 sums of its scores round
  differently; the k-means cases therefore draw rows around well-separated
  centres (``clustered_exact``), where no row lies within rounding of two
  centroids. The probe searches take exact centroids.
- **Clustered data** (the cases of ``tests/test_ivf.py``, the ``ivf`` cases
  of ``tests/test_vector_hnsw_strategy.py``, ``tests/test_vector_matrix.py``
  and ``tests/test_vector_search.py``): each package's recall against a
  float64 oracle, which must agree within 0.01.
- **Segments crossing the packages**: centroids written by either package
  open in the other without a k-means and give the same answers; so does a
  node shard over one metadata file and blob store.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nucliadb_tpu.index.vector.segment as jsegment
import nucliadb_tpu_torch.index.vector.segment as tsegment
from nucliadb_tpu.index import vector as jvector
from nucliadb_tpu.ops import ivf as ji
from nucliadb_tpu.types import Seq as JSeq, SimpleOpenIndex as JSimpleOpenIndex
from nucliadb_tpu_torch.index import vector as tvector
from nucliadb_tpu_torch.ops import ivf as ti

NEG = float(np.float32(-3.0e38))
RECALL_GAP = 0.01
FIELDS = ("centroids", "block_codes", "block_scale", "block_ids", "cluster_blocks")


def exact_data(rng, n, d=32):
    return (rng.integers(-3, 4, (n, d)) / 4).astype(np.float32)


def clustered_exact(rng, n, d=32, centers=16):
    """Exact entries around ``centers`` centres in contiguous blocks of
    rows: each entry redrawn with probability 0.15."""
    c = rng.integers(-3, 4, (centers, d))
    rows = c[np.arange(n) * centers // n]
    redraw = rng.random((n, d)) < 0.15
    rows[redraw] = rng.integers(-3, 4, int(redraw.sum()))
    return (rows / 4).astype(np.float32)


def clustered(rng, n, d, centers):
    """tests/test_ivf.py's data."""
    v = centers[rng.integers(0, len(centers), n)] + 0.25 * rng.standard_normal((n, d)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def arena_of(v, n_pad):
    a = np.zeros((n_pad, v.shape[1]), np.float32)
    a[: v.shape[0]] = v
    return a


def both_build(arena, n, **kw):
    jidx = ji.build_ivf(jnp.asarray(arena), n, **{k: (jnp.asarray(v) if k == "centroids" else v) for k, v in kw.items()})
    tidx = ti.build_ivf(torch.from_numpy(arena), n, **{k: (torch.from_numpy(v) if k == "centroids" else v) for k, v in kw.items()})
    return jidx, tidx


def both_search(jidx, tidx, arena, q, mask, k, min_score=NEG, **kw):
    """(JAX ids, JAX scores, port ids, port scores) of one probe search."""
    js, jids = ji.ivf_search(jidx, jnp.asarray(arena), jnp.asarray(q), jnp.asarray(mask), jnp.float32(min_score), k, **kw)
    ts, tids = ti.ivf_search(tidx, torch.from_numpy(arena), torch.from_numpy(q), torch.from_numpy(mask), min_score, k, **kw)
    return np.asarray(jids), np.asarray(js), tids.numpy(), ts.numpy()


def recall(ids, oracle, k):
    return float(np.mean([
        len(set(np.argsort(-oracle[b])[:k].tolist()) & set(ids[b].tolist())) / k for b in range(ids.shape[0])
    ]))


# --------------------------------------------------------------------------
# exact data: equal element for element
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n,n_pad,k_clusters,block,seeded",
    [(3000, 4096, 16, 1024, True), (2000, 2048, 16, 65536, False), (10, 16, 16, 65536, True)],
)
def test_kmeans_equals_jax(n, n_pad, k_clusters, block, seeded):
    """Centroids and assignment equal: four blocks summed in order, one
    block, and fewer rows than clusters (repeated seeds, dead clusters
    keeping their centroids); seeds from the valid rows or strided over the
    padded arena."""
    rng = np.random.default_rng(n)
    arena = arena_of(clustered_exact(rng, n), n_pad)
    seed_idx = ji.ivf_seed_indices(n, k_clusters) if seeded else None
    jc, ja = ji.kmeans(
        jnp.asarray(arena), jnp.arange(n_pad) < n, k_clusters, block=block,
        seed_idx=None if seed_idx is None else jnp.asarray(seed_idx),
    )
    runs = ti.KMEANS["kmeans"]
    tc, ta = ti.kmeans(torch.from_numpy(arena), torch.arange(n_pad) < n, k_clusters, block=block, seed_idx=seed_idx)
    assert ti.KMEANS["kmeans"] == runs + 1
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ti.ivf_seed_indices(n, k_clusters), ji.ivf_seed_indices(n, k_clusters))


def test_assign_all_equals_jax():
    rng = np.random.default_rng(11)
    arena = arena_of(exact_data(rng, 4000), 4096)
    centroids = exact_data(rng, 48)
    centroids[5] = centroids[9]  # equal centroids: the first maximum wins
    want = ji.assign_all(jnp.asarray(arena), jnp.asarray(centroids), block=1024)
    got = ti.assign_all(torch.from_numpy(arena), torch.from_numpy(centroids), block=1024)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not (got.numpy() == 9).any()


@pytest.mark.parametrize("given", [False, True])
def test_build_ivf_equals_jax(given):
    """The blocked int8 tables and the block size, after k-means (default
    cluster count) or from given centroids (one assignment pass: no
    k-means runs)."""
    rng = np.random.default_rng(12)
    n, n_pad = 3000, 4096
    arena = arena_of(clustered_exact(rng, n), n_pad)
    kw = {"centroids": exact_data(rng, 64)} if given else {"k_clusters": 16, "block": 32}
    runs = ti.KMEANS["kmeans"]
    jidx, tidx = both_build(arena, n, **kw)
    assert ti.KMEANS["kmeans"] == runs + (0 if given else 1)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tidx, f).numpy(), np.asarray(getattr(jidx, f)), err_msg=f)
    assert tidx.block == jidx.block and tidx.block_codes.dtype == torch.int8


IVF_CASES = {
    "unfiltered": dict(),
    "filter_30pct": dict(select=0.3),
    "min_score": dict(min_score=4.0),
    "ragged_batch": dict(b=13),  # the last chunk of 8 padded
    "nprobe_above_k": dict(nprobe=100),
    "wide_k": dict(k=40, nprobe=4),
    "d1536": dict(d=1536),  # the int8 dot in two chunks of the dimensions
}


@pytest.mark.parametrize("case", sorted(IVF_CASES))
def test_ivf_search_equals_jax(case):
    kw = dict(IVF_CASES[case])
    d, b, k = kw.pop("d", 32), kw.pop("b", 16), kw.pop("k", 10)
    rng = np.random.default_rng(13)
    n, n_pad = 2500, 4096
    arena = arena_of(exact_data(rng, n, d), n_pad)
    q = exact_data(rng, b, d)
    mask = np.zeros(n_pad, bool)
    mask[:n] = rng.random(n) < kw.pop("select", 1.1)
    min_score = kw.pop("min_score", NEG)
    jidx, tidx = both_build(arena, n, centroids=exact_data(rng, 32, d))
    searches = ti.SEARCHES["search"]
    jids, js, tids, ts = both_search(jidx, tidx, arena, q, mask, k, min_score, **kw)
    assert ti.SEARCHES["search"] == searches + 1
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(ts, js)
    assert mask[tids[tids >= 0]].all() and (tids >= 0).any()
    if case == "min_score":
        assert (ts[tids >= 0] >= 4.0).all() and (tids == -1).any()


def test_int8_bdot_is_exact_past_one_chunk():
    """The chunked estimate equals the int64 dot at D = 3,000 (three chunks)
    with codes at the edges of the int8 range."""
    rng = np.random.default_rng(14)
    qi = rng.integers(-127, 128, (3, 3000)).astype(np.int8)
    codes = rng.integers(-127, 128, (3, 50, 3000)).astype(np.int8)
    codes[0, 0] = 127
    qi[0] = 127
    got = ti._int8_bdot(torch.from_numpy(qi), torch.from_numpy(codes))
    want = np.einsum("cd,cxd->cx", qi.astype(np.int64), codes.astype(np.int64))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# clustered data: recall against a float64 oracle, within 0.01 of JAX's
# --------------------------------------------------------------------------


def test_kmeans_converges(rng):
    """tests/test_ivf.py:15, in both."""
    d = 32
    centers = rng.standard_normal((8, d)).astype(np.float32) * 3
    v = clustered(rng, 1024, d, centers)
    jc, ja = ji.kmeans(jnp.asarray(v), jnp.ones(1024, bool), 16, iters=8)
    tc, ta = ti.kmeans(torch.from_numpy(v), torch.ones(1024, dtype=torch.bool), 16, iters=8)
    for c, a in ((np.asarray(jc), np.asarray(ja)), (tc.numpy(), ta.numpy())):
        assert (np.argmax(v @ c.T, -1) == a).mean() > 0.99
    assert (ta.numpy() == np.asarray(ja)).mean() > 0.99


def test_ivf_recall(rng):
    """tests/test_ivf.py:27: recall >= 0.9 at nprobe 8, in both."""
    n, d, b, k = 4096, 64, 8, 10
    centers = rng.standard_normal((30, d)).astype(np.float32)
    v = clustered(rng, n, d, centers)
    q = clustered(rng, b, d, centers)
    jidx, tidx = both_build(v, n, k_clusters=64)
    jids, _, tids, _ = both_search(jidx, tidx, v, q, np.ones(n, bool), k, nprobe=8)
    oracle = q.astype(np.float64) @ v.astype(np.float64).T
    rj, rt = recall(jids, oracle, k), recall(tids, oracle, k)
    assert rt >= 0.9 and abs(rt - rj) <= RECALL_GAP, (rt, rj)


def test_ivf_mask_and_padding(rng):
    """tests/test_ivf.py:45: a mask over the first 100 of 1,000 valid rows
    in a padded arena."""
    n, d = 1000, 32
    centers = rng.standard_normal((5, d)).astype(np.float32)
    v = arena_of(clustered(rng, n, d, centers), 1024)
    jidx, tidx = both_build(v, n, k_clusters=16)
    mask = np.zeros(1024, bool)
    mask[:100] = True
    q = clustered(rng, 3, d, centers)
    jids, _, tids, _ = both_search(jidx, tidx, v, q, mask, 5, nprobe=16)
    for ids in (jids, tids):
        assert ((ids < 100) | (ids == -1)).all() and (ids >= 0).any()


# --------------------------------------------------------------------------
# the ivf strategy through the vector index
# --------------------------------------------------------------------------


def _segments(mod, tmp, v, cfg, parts, **kw):
    metas, lo = [], 0
    for s, size in enumerate(parts):
        elems = [mod.Elem(key=f"r/{i:05d}", vectors=v[i : i + 1]) for i in range(lo, lo + size)]
        metas.append(mod.create_segment(str(tmp / f"s{s}"), elems, cfg, **kw))
        lo += size
    return metas


def _searchers(tmp_path, v, parts, similarity="dot"):
    """Both packages' searchers, each over segments its own package wrote."""
    jcfg = jvector.VectorConfig(dimension=v.shape[1], flags=["ivf"], similarity=similarity)
    tcfg = tvector.VectorConfig(dimension=v.shape[1], flags=["ivf"], similarity=similarity)
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
    jhits = js.search(jvector.VectorSearchRequest(vectors=q, top_k=k))
    thits = ts.search(tvector.VectorSearchRequest(vectors=q, top_k=k))
    return _key_recall(jhits, oracle, k), _key_recall(thits, oracle, k)


def _clustered_rows(rng, n, d, centers, normalize=True):
    c = rng.standard_normal((centers, d)).astype(np.float32)
    v = c[rng.integers(0, centers, n)] + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    q = c[rng.integers(0, centers, 4)] + 0.3 * rng.standard_normal((4, d)).astype(np.float32)
    if normalize:
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return v, q


def test_ivf_strategy_end_to_end(rng, tmp_path):
    """tests/test_vector_hnsw_strategy.py:42, in both packages."""
    v, q = _clustered_rows(rng, 1500, 32, 15)
    js, ts = _searchers(tmp_path, v, [1500])
    assert ts.index.ivf is not None and not ts.index.host_resident()
    rj, rt = _strategy_recalls(js, ts, q, q.astype(np.float64) @ v.astype(np.float64).T)
    assert rt >= 0.9 and abs(rt - rj) <= RECALL_GAP, (rt, rj)


def test_ivf_centroids_persisted_and_reused(rng, tmp_path):
    """tests/test_ivf.py:68: a segment holds its centroids, and an index
    whose biggest segment covers at least a quarter of the rows reuses them
    (no k-means at load); under a quarter it runs k-means."""
    n, d, k = 1600, 32, 10
    centers = rng.standard_normal((12, d)).astype(np.float32)
    v = centers[rng.integers(0, 12, n)] + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    cfg = tvector.VectorConfig(dimension=d, flags=["ivf"])
    cut = 3 * n // 4
    metas = _segments(tsegment, tmp_path, v, cfg, [cut, n - cut], device="cpu")
    assert (tmp_path / "s0" / "ivf_centroids.npy").exists()
    assert tsegment.open_segment(metas[0].path).ivf_centroids is not None
    runs = ti.KMEANS["kmeans"]
    ts = tvector.VectorSearcher(
        cfg, tvector.SimpleOpenIndex(segment_list=[(metas[0], tvector.Seq(1)), (metas[1], tvector.Seq(2))]),
        device="cpu",
    )
    assert ti.KMEANS["kmeans"] == runs and ts.index.ivf is not None
    with mock.patch.object(ji, "kmeans", side_effect=AssertionError("kmeans at load")):
        js = jvector.VectorSearcher(
            jvector.VectorConfig(dimension=d, flags=["ivf"]),
            JSimpleOpenIndex(segment_list=[(metas[0], JSeq(1)), (metas[1], JSeq(2))]),
        )
    q = centers[rng.integers(0, 12, 4)] + 0.3 * rng.standard_normal((4, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    rj, rt = _strategy_recalls(js, ts, q, q.astype(np.float64) @ v.astype(np.float64).T, k)
    assert rt >= 0.9 and abs(rt - rj) <= RECALL_GAP, (rt, rj)
    small = _segments(tsegment, tmp_path / "small", v, cfg, [300, 1300], device="cpu")
    no_centroids = _segments(tsegment, tmp_path / "flat", v, tvector.VectorConfig(dimension=d), [1500], device="cpu")
    runs = ti.KMEANS["kmeans"]
    tvector.VectorSearcher(
        cfg, tvector.SimpleOpenIndex(segment_list=[(small[0], tvector.Seq(1)), (no_centroids[0], tvector.Seq(2))]),
        device="cpu",
    )
    assert ti.KMEANS["kmeans"] == runs + 1


@pytest.mark.parametrize("similarity", ["dot", "cosine"])
def test_search_matrix_ivf(similarity, rng, tmp_path):
    """tests/test_vector_matrix.py's ivf cases."""
    v, q = _clustered_rows(rng, 1200, 64, 12, normalize=similarity == "dot")
    js, ts = _searchers(tmp_path, v, [1200], similarity=similarity)
    vv, qq = v, q
    if similarity == "cosine":
        vv = v / np.linalg.norm(v, axis=-1, keepdims=True)
        qq = q / np.linalg.norm(q, axis=-1, keepdims=True)
    rj, rt = _strategy_recalls(js, ts, q, qq.astype(np.float64) @ vv.astype(np.float64).T)
    assert rt >= 0.85 and abs(rt - rj) <= RECALL_GAP, (rt, rj)


def test_with_duplicates_dedup_ivf(rng, tmp_path):
    """tests/test_vector_search.py:330's ivf case."""
    d = 32
    base = rng.standard_normal((64, d)).astype(np.float32)
    dup = base[0].copy()
    cfg = tvector.VectorConfig(dimension=d, flags=["ivf"])
    elems = [tvector.Elem(key=f"r{i}/f1/{i}/0-10", vectors=base[i][None]) for i in range(64)]
    elems += [tvector.Elem(key=f"dup{j}/f1/{j}/0-10", vectors=dup[None]) for j in range(3)]
    meta = tsegment.create_segment(str(tmp_path / "s"), elems, cfg, device="cpu")
    searcher = tvector.VectorSearcher(cfg, tvector.SimpleOpenIndex(segment_list=[(meta, tvector.Seq(1))]), device="cpu")
    q = dup + 0.001 * rng.standard_normal(d).astype(np.float32)
    for with_dup, copies in ((False, 1), (True, 4)):
        searches = ti.SEARCHES["search"]
        keys = [h.key for h in searcher.search(tvector.VectorSearchRequest(vectors=q, top_k=6, with_duplicates=with_dup))[0]]
        assert ti.SEARCHES["search"] == searches + 1
        assert len([k for k in keys if k.startswith(("r0/", "dup"))]) == copies, keys


# --------------------------------------------------------------------------
# segments and node shards crossing the packages
# --------------------------------------------------------------------------


def test_ivf_segments_cross_both_ways(tmp_path):
    """On exact data: byte-identical centroid columns for the same elems,
    each package opens the other's segments without a k-means, and the
    answers (unfiltered, 30 % filtered, deduplicated) are equal."""
    rng = np.random.default_rng(15)
    v = clustered_exact(rng, 1800)
    jcfg = jvector.VectorConfig(dimension=32, flags=["ivf"])
    tcfg = tvector.VectorConfig(dimension=32, flags=["ivf"])
    jm = _segments(jsegment, tmp_path / "jax", v, jcfg, [1200, 600])
    tm = _segments(tsegment, tmp_path / "port", v, tcfg, [1200, 600], device="cpu")
    for s in ("s0", "s1"):
        for column in ("ivf_centroids.npy", "vectors.npy", "meta.json"):
            assert (tmp_path / "jax" / s / column).read_bytes() == (tmp_path / "port" / s / column).read_bytes()
    runs = ti.KMEANS["kmeans"]
    port_over_jax = tvector.VectorSearcher(
        tcfg, tvector.SimpleOpenIndex(segment_list=[(m, tvector.Seq(i + 1)) for i, m in enumerate(jm)]), device="cpu"
    )
    assert ti.KMEANS["kmeans"] == runs
    with mock.patch.object(ji, "kmeans", side_effect=AssertionError("kmeans at load")):
        jax_over_port = jvector.VectorSearcher(jcfg, JSimpleOpenIndex(segment_list=[(m, JSeq(i + 1)) for i, m in enumerate(tm)]))
    q = exact_data(rng, 8)
    allowed = rng.random(1800) < 0.3
    for mask, dup in ((None, True), (allowed, True), (None, False)):
        js, jids = jax_over_port.index.search(q, 10, para_mask=mask, with_duplicates=dup)
        ts, tids = port_over_jax.index.search(q, 10, para_mask=mask, with_duplicates=dup)
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_array_equal(ts, js)


def test_ivf_index_from_reference_state(tmp_path):
    """A JAX index's IVF layout carried across as numpy arrays answers as
    the JAX index does."""
    rng = np.random.default_rng(16)
    v = clustered_exact(rng, 1200)
    jcfg = jvector.VectorConfig(dimension=32, flags=["ivf"])
    jm = _segments(jsegment, tmp_path, v, jcfg, [1200])
    j = jvector.VectorSearcher(jcfg, JSimpleOpenIndex(segment_list=[(jm[0], JSeq(1))])).index
    arrays = {"vectors": np.asarray(j.vectors), "alive": j.alive, "para_seg": j.para_seg}
    arrays.update({f"ivf_{f}": np.asarray(getattr(j.ivf, f)) for f in FIELDS})
    arrays["ivf_block"] = j.ivf.block
    idx = tvector.DeviceVectorIndex.from_reference_state(
        tvector.VectorConfig(dimension=32, flags=["ivf"]), j.keys, j.para_meta, j.labels, j.seg_tags, j.seg_bounds,
        arrays, device="cpu",
    )
    q = exact_data(rng, 8)
    js, jids = j.search(q, 10)
    ts, tids = idx.search(q, 10)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(ts, js)


def test_node_shard_with_centroids_crosses_both_ways(tmp_path):
    """A JAX node and a port node over one metadata file and blob store,
    vectorset flagged ivf: the port opens the JAX indexer's segments, its
    worker merges them (one k-means, on the CPU), the JAX searcher opens the
    merged segment's centroids, and every answer equals the other's."""
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
    sid = ref.create_shard("kb1", {"m1": jvector.VectorConfig(dimension=DIM, flags=["ivf"])}, shard_id="s1")
    for i in range(6):
        ref.index(sid, make_resource(f"r{i}", f"document number {i} quick"))
    req = ShardSearchRequest(body="quick number", vector=embed("document number 1 quick"), top_k=10)

    def both_answer_alike():
        for node in (ref, port):
            node.wait_for_sync()
        resp = port.search(sid, as_port(req))
        assert_same_response(resp, ref.search(sid, req))
        return resp

    assert both_answer_alike().vector
    runs = ti.KMEANS["kmeans"]
    port.tick_background()
    assert ti.KMEANS["kmeans"] == runs + 1  # the merged segment's centroids
    both_answer_alike()
    assert ti.KMEANS["kmeans"] == runs + 1  # the port's reload reuses them
