"""The yardstick: the bound's arithmetic against hand values, the plain
reference against brute force, and the data made from the seed."""

import numpy as np
import pytest
import torch

from benchmark import bounds, corpus
from benchmark.reference import vector as reference


@pytest.mark.parametrize(
    "b, n, d, want, binds",
    [
        # 2 * 2048 * 1,048,576 * 768 int8 operations at 1,979 TOP/s
        (2048, 1048576, 768, 1.666768511029813, "operations"),
        # the same at the 1M rows of the corpus
        (2048, 1000000, 768, 1.58955432036382, "operations"),
        # B = 8: the codes' bytes at 3.35 TB/s bind
        (8, 1048576, 768, 0.24196661492537314, "bytes"),
    ],
)
def test_int8_bound_against_hand_values(b, n, d, want, binds):
    ms, what = bounds.int8_bound_ms(b, n, d, 256, 2)
    assert ms == pytest.approx(want, rel=1e-12) and what == binds


def _brute(rows, q, ok, k, sim):
    r = rows.astype(np.float64)
    qq = q.astype(np.float64)
    if sim == "cosine":
        r = r / np.linalg.norm(r, axis=1, keepdims=True)
        qq = qq / np.linalg.norm(qq, axis=1, keepdims=True)
    s = np.where(ok[None, :], qq @ r.T, -np.inf)
    ids = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(s, ids, 1)


@pytest.mark.parametrize("sim", ["cosine", "dot"])
def test_reference_against_brute_force(sim):
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((3000, 32)).astype(np.float32)
    q = rng.standard_normal((24, 32)).astype(np.float32)
    ok = rng.random(3000) > 0.3
    ids, scores = reference.exact_topk(
        torch.from_numpy(rows), torch.from_numpy(q), torch.from_numpy(ok), 10, sim, block_rows=700, block_queries=7
    )
    want_ids, want_s = _brute(rows, q, ok, 10, sim)
    assert np.array_equal(ids.numpy(), want_ids)
    assert np.allclose(scores.numpy(), want_s, atol=1e-5)
    exact = reference.exact_scores(torch.from_numpy(rows), torch.from_numpy(q), ids, sim).numpy()
    assert np.allclose(exact, want_s, atol=1e-12)


def test_reference_drops_repeated_vectors_and_pads():
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((50, 8)).astype(np.float32)
    q = rows[:2].copy()
    rows[7] = rows[0]  # a duplicate of query 0's best row, ranked second
    ok = np.zeros(50, bool)
    ok[[0, 7, 9, 11]] = True
    ids, scores = reference.exact_topk(torch.from_numpy(rows), torch.from_numpy(q), torch.from_numpy(ok), 5, "dot")
    assert ids[0, 0] == 0 and 7 not in ids[0].tolist()
    assert (ids[:, 3:] == -1).all() and torch.isinf(scores[:, 3:]).all()


def test_matmul_precision_restores():
    before = torch.backends.cuda.matmul.allow_tf32
    with reference.matmul_precision(not before):
        assert torch.backends.cuda.matmul.allow_tf32 is (not before)
    assert torch.backends.cuda.matmul.allow_tf32 is before


def test_data_depends_on_the_seed_only():
    seed = 2**33 + 5
    whole = corpus.rows(seed, 300000, 16, "cpu")
    part = corpus.fill_rows(torch.empty(140000, 16), seed, 300000)
    assert torch.equal(whole[:140000], part)
    assert torch.allclose(whole.norm(dim=1), torch.ones(300000), atol=1e-5)
    q = corpus.queries(seed, 16, 0, 70000, "cpu")
    assert torch.equal(corpus.queries(seed, 16, 65530, 10, "cpu"), q[65530:65540])
    assert not torch.equal(corpus.queries(seed + 1, 16, 0, 10, "cpu"), q[:10])
    assert not torch.equal(corpus.queries(seed, 16, 0, 10, "cpu", corpus.WARMUP), q[:10])
    assert np.array_equal(corpus.query_pool(seed, 16, 70000, "cpu"), q.numpy())


def test_keys_labels_and_deletions():
    assert corpus.key_of(123456) == "r012345/f/6/0-10"
    assert all(corpus.row_of(corpus.key_of(i)) == i for i in (0, 9, 10, 999999))
    assert corpus.row_of("r012345/f/6/0-11") == -1 and corpus.row_of("x") == -1
    alive = corpus.alive(1000000, 100)
    assert alive.sum() == 990000 and not alive[370:380].any() and alive[369] and alive[380]
    assert corpus.labelled(1000000, 10).sum() == 100000
