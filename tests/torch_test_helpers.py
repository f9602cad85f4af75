"""Inputs and checks shared by the port's CPU and CUDA tests (numpy only,
so the CUDA tests run where jax is not installed)."""

import numpy as np

# f32 sums taken in another order (another BLAS, the card) differ by a few
# ulps; scores compare within this, and ids inside runs of reference scores
# this close compare as sets
RTOL = 1e-5


def _quantize(q):
    qs = np.maximum(np.abs(q).max(-1), 1e-12) / 127.0
    return np.clip(np.round(q / qs[:, None]), -127, 127).astype(np.int8)


def _top2_oracle(rng, slots):
    """tests/test_pallas_scan.py:107 — random codes, every 7th masked."""
    n, d, b = 4096, 128, 24
    codes = rng.integers(-127, 128, (n, d)).astype(np.int8)
    scale = rng.uniform(0.5, 1.5, n).astype(np.float32)
    mask = np.ones(n, bool)
    mask[::7] = False
    q = _quantize(rng.standard_normal((b, d)).astype(np.float32))
    return q, codes, scale, mask


def _pair_collisions(rng, slots):
    """tests/test_pallas_scan.py:152 — the true top-10 planted as pairs
    (j, j + slots) that share slot j."""
    n, d, b = 4096, 128, 8
    codes = rng.integers(-40, 40, (n, d)).astype(np.int8)
    q = _quantize(rng.standard_normal((b, d)).astype(np.float32))
    for j in range(5):
        for pid in (j * 31, j * 31 + slots):
            codes[pid] = np.clip(np.sign(q[0]) * 90, -127, 127).astype(np.int8)
    return q, codes, np.ones(n, np.float32), np.ones(n, bool)


def _all_masked(rng, slots):
    """tests/test_pallas_scan.py:203 — nothing eligible."""
    n, d, b = 4096, 128, 8
    codes = np.ones((n, d), np.int8)
    q = _quantize(np.ones((b, d), np.float32))
    return q, codes, np.ones(n, np.float32), np.zeros(n, bool)


def _planted_ties(rng, slots):
    """Duplicate code rows (equal scores) at ids in the same slot and across
    slots and column blocks, plus a fully masked block of 2048 columns."""
    n, d, b = 6144, 128, 12
    codes = rng.integers(-127, 128, (n, d)).astype(np.int8)
    scale = rng.uniform(0.5, 1.5, n).astype(np.float32)
    mask = rng.random(n) > 0.1
    mask[2048:4096] = False
    hot = np.clip(rng.standard_normal(d) * 200, -127, 127).astype(np.int8)
    # same slot: 5, 5 + S, 5 + 3S, 5 + 5000 // S * S; across slots: 6, 700
    same_slot = [5, 5 + slots, 5 + 3 * slots, 5 + (5000 // slots) * slots]
    for pid in same_slot + [6, 700, 4100]:
        codes[pid] = hot
        scale[pid] = 1.0
        mask[pid] = True
    q = np.tile(hot, (b, 1))
    q[1::2] = _quantize(rng.standard_normal((b // 2, d)).astype(np.float32))
    return q, codes, scale, mask


CASES = {
    "top2_oracle": _top2_oracle,
    "pair_collisions": _pair_collisions,
    "all_masked": _all_masked,
    "planted_ties": _planted_ties,
}


def assert_same_results(ref_s, ref_i, got_s, got_i):
    """Row by row: equal ids, scores within RTOL; inside a run of reference
    scores that lie within RTOL of each other, equal id sets."""
    ref_s, got_s = np.asarray(ref_s, np.float64), np.asarray(got_s, np.float64)
    ref_i, got_i = np.asarray(ref_i, np.int64), np.asarray(got_i, np.int64)
    assert ref_i.shape == got_i.shape
    np.testing.assert_array_equal(got_i < 0, ref_i < 0)
    valid = ref_i >= 0
    np.testing.assert_allclose(got_s[valid], ref_s[valid], rtol=RTOL, atol=1e-6)
    for row in range(ref_i.shape[0]):
        n = int(valid[row].sum())
        start = 0
        for pos in range(1, n + 1):
            if pos == n or not np.isclose(ref_s[row, pos], ref_s[row, pos - 1], rtol=RTOL, atol=1e-6):
                want = set(ref_i[row, start:pos].tolist())
                assert set(got_i[row, start:pos].tolist()) == want, (row, start, pos)
                start = pos
