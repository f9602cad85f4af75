"""Port ops (nucliadb_tpu_torch.ops) against their JAX counterparts.

Inputs are made with numpy from a seed; the same arrays go through both
packages on the CPU. Tolerances: top-k ids and int8 codes/estimates must be
equal (same arithmetic, same tie order); f32 matmul scores within rtol 1e-5
(the sums run in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nucliadb_tpu.ops import distance as jdist
from nucliadb_tpu.ops import quant as jquant
from nucliadb_tpu.ops import topk as jtopk
from nucliadb_tpu_torch.ops import distance as tdist
from nucliadb_tpu_torch.ops import quant as tquant
from nucliadb_tpu_torch.ops import topk as ttopk


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _scores_with_ties(rng, b, n):
    # few distinct values -> many planted ties across the row
    return rng.integers(-4, 5, (b, n)).astype(np.float32) * np.float32(0.25)


TOPK_CASES = {
    "plain": dict(n=64, k=10, mask=False, floor=None),
    "mask": dict(n=64, k=10, mask=True, floor=None),
    "floor": dict(n=64, k=10, mask=False, floor=0.5),
    "mask_floor": dict(n=64, k=12, mask=True, floor=-0.25),
    "k_gt_n": dict(n=6, k=9, mask=True, floor=None),
    "all_masked": dict(n=16, k=4, mask="none", floor=None),
}


@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_masked_topk_matches_jax(case):
    cfg = TOPK_CASES[case]
    rng = np.random.default_rng(1)
    scores = _scores_with_ties(rng, 5, cfg["n"])
    mask = None
    if cfg["mask"] == "none":
        mask = np.zeros(cfg["n"], bool)
    elif cfg["mask"]:
        mask = rng.random(cfg["n"]) > 0.3
    js, ji = jtopk.masked_topk(
        jnp.asarray(scores), cfg["k"],
        mask=None if mask is None else jnp.asarray(mask), min_score=cfg["floor"],
    )
    ts, ti = ttopk.masked_topk(
        _t(scores), cfg["k"], mask=None if mask is None else _t(mask),
        min_score=cfg["floor"],
    )
    assert ts.shape == (5, cfg["k"]) and ti.shape == (5, cfg["k"])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _long_axis_ties(rng, b, n, k):
    """BM25-like rows: few distinct scores, a planted run of 3k equal
    scores straddling the k-th place, a few scores above it, a masked
    stretch inside the run, and rows where fewer than k entries survive
    the per-row floor."""
    s = rng.integers(0, 4, (b, n)).astype(np.float32) * np.float32(0.125)
    for row in range(b):
        run = rng.choice(n, 3 * k, replace=False)
        s[row, run] = 2.0
        s[row, rng.choice(n, k // 2, replace=False)] = 3.0
    mask = np.ones(n, bool)
    mask[n // 3 : n // 3 + 40] = False
    floor = np.full((b, 1), -1.0, np.float32)
    floor[1] = 2.5  # only the k // 2 entries at 3.0 pass: -1 padding
    floor[2] = 9.0  # nothing passes
    return s, mask, floor


@pytest.mark.parametrize("k", [1, 20, 64])
def test_masked_topk_long_axis_ties_match_jax(k):
    """The select path (k * 16 <= N) keeps lax.top_k's order: scores
    descending, the lower index first among equal scores."""
    rng = np.random.default_rng(3)
    s, mask, floor = _long_axis_ties(rng, 6, 4096, k)
    js, ji = jtopk.masked_topk(jnp.asarray(s), k, mask=jnp.asarray(mask), min_score=jnp.asarray(floor))
    ts, ti = ttopk.masked_topk(_t(s), k, mask=_t(mask), min_score=_t(floor))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ti.numpy()[2] == -1).all() and (ti.numpy()[1] >= 0).sum() == k // 2
    # one row, no floor: the 1-D form
    js, ji = jtopk.masked_topk(jnp.asarray(s[0]), k)
    ts, ti = ttopk.masked_topk(_t(s[0]), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_duplicate_id_mask_matches_jax():
    rng = np.random.default_rng(2)
    ids = rng.integers(-1, 6, (7, 12)).astype(np.int32)
    want = np.asarray(jtopk.duplicate_id_mask(jnp.asarray(ids)))
    got = ttopk.duplicate_id_mask(_t(ids)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("similarity", ["dot", "cosine"])
def test_prepare_query_and_scores_matmul(similarity):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((6, 48)).astype(np.float32)
    v = rng.standard_normal((100, 48)).astype(np.float32)
    jq = jdist.prepare_query(jnp.asarray(q), similarity)
    tq = tdist.prepare_query(_t(q), similarity)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-6, atol=1e-7)
    js = jdist.scores_matmul(jq, jnp.asarray(v))
    ts = tdist.scores_matmul(tq, _t(v))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("similarity", ["dot", "cosine"])
def test_exact_scan_topk_matches_jax(similarity):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((5, 32)).astype(np.float32)
    v = rng.standard_normal((300, 32)).astype(np.float32)
    mask = rng.random(300) > 0.2
    js, ji = jdist.exact_scan_topk(
        jnp.asarray(q), jnp.asarray(v), 10, mask=jnp.asarray(mask),
        min_score=-1.0, similarity=similarity,
    )
    ts, ti = tdist.exact_scan_topk(
        _t(q), _t(v), 10, mask=_t(mask), min_score=-1.0, similarity=similarity
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)


@pytest.mark.parametrize("similarity", ["dot", "cosine"])
def test_exact_rerank_matches_jax(similarity):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((4, 32)).astype(np.float32)
    v = rng.standard_normal((200, 32)).astype(np.float32)
    cand = rng.integers(-1, 200, (4, 30)).astype(np.int32)
    js, ji = jdist.exact_rerank(
        jnp.asarray(q), jnp.asarray(v), jnp.asarray(cand), 8, similarity=similarity
    )
    ts, ti = tdist.exact_rerank(_t(q), _t(v), _t(cand), 8, similarity=similarity)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)


def _encode_inputs(rng):
    v = rng.standard_normal((64, 96)).astype(np.float32)
    v[3] = 0.0  # zero row: scale floor 1e-12 / 127
    v[4] = np.linspace(-1.0, 1.0, 96, dtype=np.float32)
    # exact half-way codes: |x| / s lands on k + 0.5 (round half to even)
    v[5] = (np.arange(96) % 9 - 4).astype(np.float32) * 0.5
    v[5, 0] = 63.5
    return v


def test_int8_encode_bit_identical():
    v = _encode_inputs(np.random.default_rng(6))
    jc = jquant.Int8Codes.encode(jnp.asarray(v))
    tc = tquant.Int8Codes.encode(_t(v))
    np.testing.assert_array_equal(tc.codes.numpy(), np.asarray(jc.codes))
    np.testing.assert_array_equal(
        tc.scale.numpy().view(np.int32), np.asarray(jc.scale).view(np.int32)
    )


def test_int8_estimate_scores_bit_identical():
    rng = np.random.default_rng(7)
    v = _encode_inputs(rng)
    q = rng.standard_normal((6, 96)).astype(np.float32)
    jc = jquant.Int8Codes.encode(jnp.asarray(v))
    tc = tquant.Int8Codes.encode(_t(v))
    je = np.asarray(jquant.int8_estimate_scores(jc, jnp.asarray(q)))
    te = tquant.int8_estimate_scores(tc, _t(q)).numpy()
    np.testing.assert_array_equal(te.view(np.int32), je.view(np.int32))


@pytest.mark.parametrize("d", [64, 1024, 1536])
def test_int8_dot_is_exact(d):
    """The plain int8 dot runs as f32 products over blocks of at most 1024
    dimensions; every block sum is exact, so the result equals int64 math,
    including the extremes of the code range."""
    rng = np.random.default_rng(8)
    a = rng.integers(-128, 128, (5, d)).astype(np.int8)
    b = rng.integers(-128, 128, (7, d)).astype(np.int8)
    a[0] = -128
    b[0] = -128
    b[1] = 127
    want = a.astype(np.int64) @ b.astype(np.int64).T
    got = tquant.int8_dot(_t(a), _t(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_scan_candidates_matches_jax():
    """Off the kernel route the port takes an exact top-c; on the CPU the
    JAX package's approx_max_k is exact too, so the ids agree."""
    rng = np.random.default_rng(9)
    v = rng.standard_normal((500, 64)).astype(np.float32)
    q = rng.standard_normal((4, 64)).astype(np.float32)
    mask = rng.random(500) > 0.25
    jc = jquant.Int8Codes.encode(jnp.asarray(v))
    tc = tquant.Int8Codes.encode(_t(v))
    js, ji = jquant.int8_scan_candidates(jc, jnp.asarray(q), 10, mask=jnp.asarray(mask))
    ts, ti = tquant.int8_scan_candidates(tc, _t(q), 10, mask=_t(mask))
    assert ti.shape == (4, tquant.int8_rerank_budget(10))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tquant.int8_rerank_budget(10) == jquant.int8_rerank_budget(10)
    assert tquant.int8_rerank_budget(1000) == jquant.int8_rerank_budget(1000)
