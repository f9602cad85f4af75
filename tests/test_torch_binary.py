"""Binary (sign-code) half of the port against the JAX package, on the CPU.

The same numpy inputs go through ``nucliadb_tpu.ops.quant`` /
``pallas_scan.binary_scan_slots(..., interpret=True)`` and their
counterparts in ``nucliadb_tpu_torch.ops``. Tolerances:

- exact: packed bits, ``popcnt``, query planes, ``qmin`` and the popcount
  bit dot (integer work);
- within ``RTOL`` (1e-5): the f32 scalars ``scale``, ``resid``, ``qstep``,
  ``qsum`` and the slot scores. The port copies XLA's compiled arithmetic
  but sums in another order, and XLA contracts ``a * b + c`` into an FMA;
- estimates within ``RTOL`` of the largest |estimate| of their row: an
  estimate is a difference of two terms, so its error is relative to the
  terms, not to the (possibly tiny) result;
- slot ids equal except where the two best scores of a slot lie within
  ``RTOL`` of each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nucliadb_tpu.ops import pallas_scan
from nucliadb_tpu.ops import quant as jquant
from nucliadb_tpu_torch.ops import binary_scan, slot_scan
from nucliadb_tpu_torch.ops import quant as tquant
from torch_test_helpers import RTOL


def _t(x):
    return torch.from_numpy(np.array(x))


def _words(x):
    """A JAX uint32 array as the port's int32 bit patterns."""
    return _t(np.asarray(x).view(np.int32))


def _vectors(rng, n=512, d=128):
    v = rng.standard_normal((n, d)).astype(np.float32)
    v[3] = 0.0  # no positive dim: zero code, scale 0
    v[4] = np.abs(v[4])  # all dims positive: every bit set, sign bit included
    v[5, ::2] = 0.0  # exact zeros count as negative (v > 0)
    return v


def test_popcount_counts_every_bit_pattern():
    rng = np.random.default_rng(30)
    x = rng.integers(-(2**31), 2**31, 4096, dtype=np.int64).astype(np.int32)
    x[:6] = [0, -1, -(2**31), 2**31 - 1, 1, -2]
    want = np.array([bin(int(v) & 0xFFFFFFFF).count("1") for v in x], np.int32)
    got = tquant.popcount(_t(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_pack_bits_matches_jax():
    rng = np.random.default_rng(31)
    bits = rng.random((3, 5, 96)) > 0.5
    bits[0, 0] = True  # every word 0xFFFFFFFF
    want = np.asarray(jquant.pack_bits(jnp.asarray(bits)))
    got = tquant.pack_bits(_t(bits))
    assert got.dtype == torch.int32 and got.shape == (3, 5, 3)
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))


def test_binary_encode_matches_jax():
    v = _vectors(np.random.default_rng(32))
    jc = jquant.BinaryCodes.encode(jnp.asarray(v))
    tc = tquant.BinaryCodes.encode(_t(v))
    assert tc.dim == jc.dim == 128 and tc.n_vectors == jc.n_vectors
    np.testing.assert_array_equal(tc.codes_t.numpy(), np.asarray(jc.codes_t).view(np.int32))
    np.testing.assert_array_equal(tc.popcnt.numpy(), np.asarray(jc.popcnt))
    for name in ("scale", "resid"):
        np.testing.assert_allclose(
            getattr(tc, name).numpy(), np.asarray(getattr(jc, name)), rtol=RTOL, atol=1e-6
        )
    assert tc.popcnt[4] == 128 and tc.popcnt[3] == 0


def test_binary_encode_in_row_chunks(monkeypatch):
    """Encoding in row chunks gives the codes of one pass."""
    v = _t(_vectors(np.random.default_rng(33)))
    whole = tquant.BinaryCodes.encode(v)
    monkeypatch.setattr(tquant, "_ENCODE_ROWS", 100)
    chunked = tquant.BinaryCodes.encode(v)
    for name in ("codes_t", "scale", "resid", "popcnt"):
        assert torch.equal(getattr(chunked, name), getattr(whole, name)), name


def _queries(rng, b=6, d=128):
    q = rng.standard_normal((b, d)).astype(np.float32)
    q[1] = 0.25  # constant query: qstep floors at 1e-12
    return q


def test_query_planes_match_jax():
    q = _queries(np.random.default_rng(34))
    # XLA's arithmetic: / 15 compiles to * f32(1/15) inside a program
    jp, jmin, jstep, jsum = jax.jit(jquant.quantize_query_planes)(jnp.asarray(q))
    tp, tmin, tstep, tsum = tquant.quantize_query_planes(_t(q))
    assert tp.shape == (6, tquant.QUERY_BITS, 4) and tp.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp).view(np.int32))
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(jmin))
    np.testing.assert_allclose(tstep.numpy(), np.asarray(jstep), rtol=RTOL)
    np.testing.assert_allclose(tsum.numpy(), np.asarray(jsum), rtol=RTOL, atol=1e-5)
    assert (tquant.EPSILON, tquant.BINARY_RERANK_FACTOR, tquant.QUERY_BITS) == (
        jquant.EPSILON, jquant.BINARY_RERANK_FACTOR, jquant.QUERY_BITS,
    )


def test_bit_dot_batch_matches_jax():
    rng = np.random.default_rng(35)
    v, q = _vectors(rng), _queries(rng)
    jc = jquant.BinaryCodes.encode(jnp.asarray(v))
    jplanes = jax.jit(jquant.quantize_query_planes)(jnp.asarray(q))[0]
    want = np.asarray(jquant._bit_dot_batch(jc.codes_t, jplanes))
    got = tquant._bit_dot_batch(_words(jc.codes_t), _words(jplanes))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _row_close(got, want):
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= RTOL * scale).all()


def test_binary_estimate_scores_match_jax():
    rng = np.random.default_rng(36)
    v, q = _vectors(rng), _queries(rng)
    je, jb = jax.jit(jquant.binary_estimate_scores)(
        jquant.BinaryCodes.encode(jnp.asarray(v)), jnp.asarray(q)
    )
    te, tb = tquant.binary_estimate_scores(tquant.BinaryCodes.encode(_t(v)), _t(q))
    _row_close(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_binary_scan_candidates_match_jax(masked, monkeypatch):
    """The port's chunked exact top-c against ``approx_max_k`` (exact on the
    CPU): the same candidates, in the same order."""
    rng = np.random.default_rng(37)
    v = rng.standard_normal((3000, 64)).astype(np.float32)
    q = rng.standard_normal((4, 64)).astype(np.float32)
    mask = rng.random(3000) > 0.3 if masked else None
    js, ji = jquant.binary_scan_candidates(
        jquant.BinaryCodes.encode(jnp.asarray(v)), jnp.asarray(q), 5,
        mask=None if mask is None else jnp.asarray(mask),
    )
    monkeypatch.setattr(tquant, "_SCAN_ELEMS", 4 * 1024)  # three column chunks
    ts, ti = tquant.binary_scan_candidates(
        tquant.BinaryCodes.encode(_t(v)), _t(q), 5, mask=None if mask is None else _t(mask)
    )
    assert ti.shape == (4, tquant.binary_rerank_budget(5)) == (4, 500)
    js, ji = np.asarray(js), np.asarray(ji)
    np.testing.assert_allclose(ts.numpy(), js, rtol=RTOL, atol=1e-5)
    # ids equal away from near-ties of the optimistic score
    near = np.isclose(js[:, :-1], js[:, 1:], rtol=RTOL, atol=1e-5)
    tied = np.zeros_like(ji, bool)
    tied[:, :-1] |= near
    tied[:, 1:] |= near
    np.testing.assert_array_equal(ti.numpy()[~tied], ji[~tied])
    if masked:
        assert mask[ti.numpy()[ti.numpy() >= 0]].all()
    assert tquant.binary_rerank_budget(30) == jquant.binary_rerank_budget(30) == 2000


def _slot_inputs(rng, n=2048, d=128, b=8, slots=256):
    """JAX's own codes and query parameters; a masked range; planted equal
    columns in one slot and across slots."""
    v = rng.standard_normal((n, d)).astype(np.float32)
    for pid in (100, 100 + slots, 100 + 3 * slots, 101, 1500):
        v[pid % n] = v[100]
    mask = np.ones(n, bool)
    mask[:64] = False
    mask[512:1024] = False
    q = rng.standard_normal((b, d)).astype(np.float32)
    q[2] = v[100]
    jc = jquant.BinaryCodes.encode(jnp.asarray(v))
    planes, qmin, qstep, qsum = jquant.quantize_query_planes(jnp.asarray(q))
    qnorm = jnp.linalg.norm(jnp.asarray(q), axis=-1)
    jargs = (planes, qmin, qstep, qsum, qnorm, jc.codes_t, jc.scale, jc.popcnt, jc.resid, jnp.asarray(mask))
    targs = (_words(planes), *map(_t, (qmin, qstep, qsum, qnorm)), _words(jc.codes_t),
             *map(_t, (jc.scale, jc.popcnt, jc.resid)), _t(mask))
    return jargs, targs


@pytest.mark.parametrize("slots", [256, 512])
def test_plain_binary_slot_scan_matches_pallas(slots):
    jargs, targs = _slot_inputs(np.random.default_rng(38), slots=slots)
    js, ji = pallas_scan.binary_scan_slots(
        *jargs, dim=128, block_n=512, slots=slots, interpret=True
    )
    js, ji = np.asarray(js), np.asarray(ji)
    launches = dict(binary_scan.LAUNCHES)
    ts, ti = binary_scan.binary_scan_slots(*targs, dim=128, block_n=512, slots=slots)
    assert dict(binary_scan.LAUNCHES) == launches  # CPU tensors: the plain version
    assert ts.shape == (8, slots) and ti.dtype == torch.int32
    ts, ti = ts.numpy(), ti.numpy()
    empty = ji < 0
    np.testing.assert_array_equal(ti < 0, empty)
    assert (ts[empty] == slot_scan.NEG_INF).all() and (js[empty] == pallas_scan.NEG_INF).all()
    np.testing.assert_allclose(ts[~empty], js[~empty], rtol=RTOL)
    # a slot's winner may differ only when its runner-up is within RTOL:
    # recompute every column's score from the plain estimates
    est, bound = tquant.binary_estimates(*targs[:-1], 128)
    opt = np.where(targs[-1].numpy(), (est + bound).numpy(), -np.inf)
    n = opt.shape[1]
    for row, slot in zip(*np.nonzero(ti != ji)):
        cols = np.arange(slot, n, slots)
        best = np.sort(opt[row, cols])[::-1]
        assert np.isclose(best[0], best[1], rtol=RTOL), (row, slot)
    # masked columns never surface; a planted tie keeps the lower id
    assert not np.isin(ti, np.r_[0:64, 512:1024]).any()
    assert ti[2, 100] == 100 and ti[2, 101] == 101
    # the plain table holds, per slot, the max of the plain scores
    np.testing.assert_array_equal(ts, opt.reshape(8, -1, slots).max(axis=1).astype(np.float32)
                                  .clip(min=slot_scan.NEG_INF))


@pytest.mark.parametrize("b", [1, 8, 32, 64, 96, 128, 256, 1024])
def test_binary_gates_match_jax(b):
    for n in (2048, 4096, 8192, 16384, 24576, 1048576, 786432, 1000000, 1536):
        for slots in (None, 256, 1024):
            assert binary_scan.binary_block_for(n, b, slots) == pallas_scan.binary_block_for(
                n, b, slots
            ), (n, b, slots)
        for d in (64, 128, 768, 96):
            for block_n in (None, 512, binary_scan.binary_block_for(n, b)):
                assert binary_scan.binary_eligible(n, d, False, block_n) == pallas_scan.binary_eligible(
                    n, d, False, block_n
                ), (n, d, block_n)
            assert not binary_scan.binary_eligible(n, d, True)
    assert binary_scan.BINARY_BLOCK_N == pallas_scan.BINARY_BLOCK_N


def test_binary_kernel_input_checks_raise():
    _, targs = _slot_inputs(np.random.default_rng(39), n=1024, b=4)
    planes, qmin, qstep, qsum, qnorm, codes_t, scale, popcnt, resid, mask = targs
    qp, cols = (qmin, qstep, qsum, qnorm), (scale, popcnt, resid)
    check = binary_scan._check_kernel_inputs
    check(planes, qp, codes_t, cols, mask, 128, 256)  # accepted
    check(planes, qp, codes_t, cols, mask, 128, 1024)  # four slot groups
    bad = [
        (planes.float(), qp, codes_t, cols, mask, 128, 256),  # dtype
        (planes[:, :3].contiguous(), qp, codes_t, cols, mask, 128, 256),  # 3 planes
        (planes, qp, codes_t[:3].contiguous(), cols, mask, 128, 256),  # W disagrees
        (planes, qp, codes_t, cols, mask, 96, 256),  # dim != 32 W
        (planes, (qmin[:2].contiguous(), qstep, qsum, qnorm), codes_t, cols, mask, 128, 256),
        (planes, qp, codes_t, (scale.double(), popcnt, resid), mask, 128, 256),
        (planes, qp, codes_t, cols, mask[:100].contiguous(), 128, 256),
        (planes, qp, codes_t, cols, mask, 128, 100),  # slots not a multiple of 32
        (planes, qp, codes_t, cols, mask, 128, 2048),  # more than 4 slot groups
        (planes, qp, codes_t[:, :1000].contiguous(), cols, mask, 128, 256),  # N % S
        (planes, qp, codes_t.t().contiguous().t(), cols, mask, 128, 256),  # not contiguous
    ]
    for args in bad:
        with pytest.raises((ValueError, TypeError)):
            check(*args)
