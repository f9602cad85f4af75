"""The port's mesh-sharded indexes (``nucliadb_tpu_torch.parallel``)
against the JAX package's, on the CPU.

``tests/test_parallel.py``'s five tests on both packages, with the same
seeded numpy inputs: the JAX package on its 8-device virtual CPU mesh
(``tests/conftest.py``), the port on a mesh of 8 members that repeats the
one CPU (``make_mesh(8, query_axis=2, device="cpu")``). Exact cuts equal
the JAX package's and the global oracle's ids, scores within
``torch_test_helpers.RTOL`` (1e-5); the quantized index reaches the same
recall bar (0.95) and the JAX package's ids up to ties; the hybrid index's
fused RRF cut equals the JAX package's id for id (its scores are sums of
``1 / (60 + rank)``, the same f32 operations in both).
"""

import os

import numpy as np
import pytest

from nucliadb_tpu.parallel import MeshHybridIndex as JMeshHybridIndex
from nucliadb_tpu.parallel import MeshShardedVectorIndex as JMeshShardedVectorIndex
from nucliadb_tpu.parallel import make_mesh as jmake_mesh
from nucliadb_tpu_torch.parallel import MeshHybridIndex, MeshShardedVectorIndex, make_mesh
from torch_test_helpers import RTOL, assert_same_results


@pytest.fixture(scope="module")
def meshes():
    return jmake_mesh(8, query_axis=2), make_mesh(8, query_axis=2, device="cpu")


def test_mesh_shape(meshes):
    jmesh, mesh = meshes
    assert mesh.shape == dict(jmesh.shape) == {"shard": 4, "query": 2}
    assert all(d.type == "cpu" for d in mesh.devices.reshape(-1))


def test_sharded_exact_matches_global(meshes):
    jmesh, mesh = meshes
    rng = np.random.default_rng(0)
    n, d, b, k = 1000, 32, 4, 7
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    s, i = MeshShardedVectorIndex(vecs, mesh).search(q, k)
    js, ji = JMeshShardedVectorIndex(vecs, jmesh).search(q, k)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, rtol=RTOL)
    ref = q @ vecs.T
    for bi in range(b):
        order = np.argsort(-ref[bi])[:k]
        assert i[bi].tolist() == order.tolist()
        np.testing.assert_allclose(s[bi], ref[bi][order], rtol=1e-4)


def test_sharded_quantized_recall(meshes):
    jmesh, mesh = meshes
    rng = np.random.default_rng(1)
    n, d, b, k = 4096, 64, 4, 10
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    idx = MeshShardedVectorIndex(vecs, mesh, quantize=True)
    assert idx.quantized and len(idx.codes) == 4
    s, i = idx.search(q, k)
    js, ji = JMeshShardedVectorIndex(vecs, jmesh, quantize=True).search(q, k)
    assert_same_results(js, ji, s, i)
    ref = q @ vecs.T
    recalls = []
    for bi in range(b):
        exact = set(np.argsort(-ref[bi])[:k].tolist())
        recalls.append(len(exact & set(i[bi].tolist())) / k)
    assert np.mean(recalls) >= 0.95


def test_sharded_padding_not_returned(meshes):
    jmesh, mesh = meshes
    rng = np.random.default_rng(2)
    n, d = 999, 16  # not divisible by 4 shards
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    idx = MeshShardedVectorIndex(vecs, mesh)
    assert idx.per_shard == 250 and idx.n_pad == 1000
    q = rng.standard_normal((3, d)).astype(np.float32)  # not divisible by the query axis
    s, i = idx.search(q, 5)
    assert i.shape == (3, 5) and (i < n).all() and (i >= 0).all()
    js, ji = JMeshShardedVectorIndex(vecs, jmesh).search(q, 5)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, rtol=RTOL)


def _hybrid_shards(tmp_path, n_shards, rng, d=32, per=12):
    """tests/test_parallel.py's hybrid corpus: per shard, normalised
    vectors and one text segment (built once, opened by both packages)."""
    from nucliadb_tpu.index.text_engine.builder import DocEntry, build_segment

    words = ["fox", "dog", "cat", "owl", "bee", "elk"]
    shards = []
    for s in range(n_shards):
        vecs = rng.standard_normal((per, d)).astype(np.float32)
        vecs /= np.linalg.norm(vecs, axis=-1, keepdims=True)
        entries = [
            DocEntry(key=f"r{s}_{j}/f", text=" ".join(words[(s + j + t) % len(words)] for t in range(4)))
            for j in range(per)
        ]
        meta = build_segment(os.path.join(str(tmp_path), f"s{s}"), entries, kind="text")
        shards.append((vecs, meta.path))
    return shards


def test_mesh_hybrid_one_program(meshes, tmp_path):
    """Hybrid search per shard (int8 candidates, exact rerank, BM25) with
    both all-gather merges and RRF on the device: the fused cut equals the
    JAX package's, and a Python RRF over the global exact vector ranks and
    the merged BM25 cut (the JAX test's oracle)."""
    from nucliadb_tpu.index.text_engine import TextQuery as JTextQuery
    from nucliadb_tpu.index.text_engine.builder import open_text_segment as jopen
    from nucliadb_tpu.index.text_engine.engine import DeviceTextEngine as JDeviceTextEngine
    from nucliadb_tpu.types import Seq as JSeq
    from nucliadb_tpu_torch.index.text_engine import TextQuery
    from nucliadb_tpu_torch.index.text_engine.builder import open_text_segment
    from nucliadb_tpu_torch.index.text_engine.engine import DeviceTextEngine
    from nucliadb_tpu_torch.types import Seq

    jmesh, mesh = meshes
    rng = np.random.default_rng(7)
    n_shards, k = mesh.shape["shard"], 5
    shards = _hybrid_shards(tmp_path, n_shards, rng)
    idx = MeshHybridIndex(
        [(v, DeviceTextEngine([(open_text_segment(p), Seq(1))], device="cpu")) for v, p in shards], mesh
    )
    jidx = JMeshHybridIndex([(v, JDeviceTextEngine([(jopen(p), JSeq(1))])) for v, p in shards], jmesh)
    assert idx.n_docs == jidx.n_docs == n_shards * 12
    assert idx.per_shard == jidx.per_shard

    all_vecs = [v for v, _ in shards]
    q = all_vecs[2][3:6]  # three queries (the query axis pads to 4), aligned with known records
    ts, ti = idx.search(q, TextQuery(text="fox dog", top_k=k), k)
    jts, jti = jidx.search(q, JTextQuery(text="fox dog", top_k=k), k)
    assert ts.shape == (3, k) and ti.shape == (3, k)
    np.testing.assert_array_equal(ti, jti)
    np.testing.assert_array_equal(ts, jts)

    # the merged keyword cut equals the JAX package's
    bs, bm_ids = idx.text.search(TextQuery(text="fox dog", top_k=k))
    jbs, jbm_ids = jidx.text.search(JTextQuery(text="fox dog", top_k=k))
    assert_same_results(jbs[None], jbm_ids[None], bs[None], bm_ids[None])

    per = idx.per_shard
    V = np.concatenate([np.pad(v, ((0, per - v.shape[0]), (0, 0))) for v in all_vecs])
    valid = np.zeros(V.shape[0], bool)
    for s_i in range(n_shards):
        valid[s_i * per : s_i * per + all_vecs[s_i].shape[0]] = True
    exact = q @ V.T
    exact[:, ~valid] = -np.inf
    vec_ids = np.argsort(-exact, axis=1)[:, :k]
    bm_global = []
    for gid in bm_ids:
        shard = int(np.searchsorted(idx.text.offsets, gid, side="right") - 1)
        bm_global.append(shard * per + (int(gid) - idx.text.offsets[shard]))

    def rrf(va, vb):
        scores = {}
        for r, gid in enumerate(va):
            scores[gid] = scores.get(gid, 0.0) + 1.0 / (60.0 + r)
        for r, gid in enumerate(vb):
            scores[gid] = scores.get(gid, 0.0) + 1.0 / (60.0 + r)
        return sorted(scores, key=lambda g: (-scores[g], list(scores).index(g)))[:k]

    expect0 = rrf([int(x) for x in vec_ids[0]], bm_global)
    assert set(int(x) for x in ti[0] if x >= 0) == set(expect0), (ti[0], expect0)
    assert 2 * per + 3 in ti[0]  # the query's own record makes the fused cut
    for gid in ti.flatten():
        if gid >= 0:
            assert idx.key(int(gid)) == jidx.key(int(gid))
