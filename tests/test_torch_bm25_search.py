"""The single-arena BM25 program and the mesh merges of the port against
the JAX package's, on the CPU.

``_bm25_search``/``_bm25_search_batch`` (``index/text_engine/engine.py``)
run over the same arrays in both packages: a solo-group engine's tiers and
dense block through ``_device_inputs``/``fixed_caps``, and a synthetic
arena with an overlay dense block whose window runs past the end of the
score space (``lax.dynamic_slice`` clamps its start; the port reproduces
the clamp). Ids are equal up to ties and scores within
``torch_test_helpers.RTOL`` (1e-5, the tolerance of the ported group
program's tests: XLA fuses ``tf + K1 * x`` on the CPU, torch rounds each
operation); matched bitmaps, match counts and per-hit term counts are
exactly equal. ``rrf_merge`` and ``sharded_topk_allgather`` are cuts of
exactly tied scores, so there ids must be equal, in order, and scores equal
bit for bit (the same f32 operations in both packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from nucliadb_tpu.index.text_engine import builder as jbuilder
from nucliadb_tpu.index.text_engine import engine as jeng
from nucliadb_tpu.ops import fusion as jfusion
from nucliadb_tpu.ops import topk as jtopk
from nucliadb_tpu.types import Seq
from nucliadb_tpu_torch.index.text_engine import builder as tbuilder
from nucliadb_tpu_torch.index.text_engine import engine as teng
from nucliadb_tpu_torch.ops import bm25, fusion, topk
from torch_test_helpers import as_port, assert_same_results

WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf", "hotel"]


def _engines(tmp_path, monkeypatch, n_docs=60, seed=0):
    """(JAX engine, port engine) over one segment of ``n_docs`` paragraphs,
    with tier widths shrunk so that "alpha" (in every other paragraph) is a
    dense column."""
    for mod in (jeng, teng):
        monkeypatch.setattr(mod, "TIER_WIDTHS", (2, 4, 8, 16))
        monkeypatch.setattr(mod, "TIER_QUERY_CAP", (4, 4, 2, 2))
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(n_docs):
        words = list(rng.choice(WORDS[1:], size=int(rng.integers(2, 8))))
        if i % 2 == 0:
            words += ["alpha"] * int(rng.integers(1, 4))
        entries.append(jbuilder.DocEntry(key=f"r{i:03d}/t/t/0-9", text=" ".join(words)))
    path = jbuilder.build_segment(str(tmp_path / "s"), entries, kind="text").path
    je = jeng.DeviceTextEngine([(jbuilder.open_text_segment(path), Seq(1))])
    te = teng.DeviceTextEngine([(tbuilder.open_text_segment(path), as_port(Seq(1)))], device="cpu")
    return je, te


QUERIES = [
    dict(text="alpha bravo", top_k=10),
    dict(text="alpha charlie delta", top_k=7, all_terms=True),
    dict(text="golf hotel echo", top_k=25),
    dict(text="bravo", top_k=5, min_score=0.5),
]


def test_solo_views_and_fixed_inputs_match_reference(tmp_path, monkeypatch):
    je, te = _engines(tmp_path, monkeypatch)
    assert te.fixed_caps() == je.fixed_caps()
    assert te.term_info == je.term_info and te.terms_sorted == je.terms_sorted
    assert te.term_info["alpha"][0] == -1  # a dense row
    np.testing.assert_array_equal(te.dense_tf.numpy(), np.asarray(je.dense_tf))
    np.testing.assert_array_equal(te.dlen.numpy(), np.asarray(je.dlen))
    assert len(te.tiers) == len(je.tiers)
    for kw in QUERIES:
        jin = je._device_inputs(jeng.TextQuery(**kw))
        tin = te._device_inputs(teng.TextQuery(**kw))
        for a, b in zip(jin, tin):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def _search_both(je, te, kw, with_counts):
    rows, idfs, params, mask = je._device_inputs(jeng.TextQuery(**kw))
    k = kw["top_k"]
    js, jic, jm = jeng._bm25_search(
        tuple(je.tiers), je.dense_tf, None, je.dlen, jnp.asarray(mask), jnp.asarray(rows),
        jnp.asarray(idfs), jnp.asarray(params), k, je.fixed_caps(), 0, with_counts,
    )
    before = bm25.DISPATCHES["arena"]
    ts, tic, tm = teng._bm25_search(
        te.tiers, te.dense_tf, None, te.dlen, torch.from_numpy(mask), torch.from_numpy(rows),
        torch.from_numpy(idfs), torch.from_numpy(params), k, te.fixed_caps(), 0, with_counts,
    )
    assert bm25.DISPATCHES["arena"] == before + 1
    return (np.asarray(js), np.asarray(jic), np.asarray(jm)), (ts.numpy(), tic.numpy(), tm.numpy())


@pytest.mark.parametrize("with_counts", [True, False])
def test_bm25_search_matches_reference(tmp_path, monkeypatch, with_counts):
    je, te = _engines(tmp_path, monkeypatch)
    for kw in QUERIES:
        (js, jic, jm), (ts, tic, tm) = _search_both(je, te, kw, with_counts)
        k = kw["top_k"]
        assert ts.shape == js.shape and tic.shape == jic.shape
        assert_same_results(js[None], jic[None, :k], ts[None], tic[None, :k])
        np.testing.assert_array_equal(tm, jm)
        # the per-hit term counts ride after the ids (-1 without counts)
        got = dict(zip(tic[:k].tolist(), tic[k:].tolist()))
        want = dict(zip(jic[:k].tolist(), jic[k:].tolist()))
        assert got == want


def _overlay_arena(rng, n_pad=64, opad=16):
    """A synthetic arena: two posting tiers of global doc ids (padded with
    -1), a base dense block and an overlay dense block of ``opad``
    columns."""
    def tier(t, w):
        docs = np.full((t, w), -1, np.int32)
        for r in range(t):
            n = int(rng.integers(1, w + 1))
            docs[r, :n] = np.sort(rng.choice(n_pad - 4, n, replace=False))
        tfs = np.where(docs >= 0, rng.integers(1, 6, (t, w)), 0).astype(np.float32)
        dls = rng.integers(1, 40, (t, w)).astype(np.float32)
        return docs, tfs, dls

    tiers = (tier(4, 4), tier(3, 8))
    dense = rng.integers(0, 3, (3, n_pad)).astype(np.uint8)
    odense = rng.integers(0, 4, (2, opad)).astype(np.uint8)
    dlen = rng.integers(1, 40, n_pad).astype(np.float32)
    caps = (3, 2, 2, 2)  # tier 0, tier 1, base dense, overlay dense
    return tiers, dense, odense, dlen, caps


def _arena_queries(rng, n_q, caps, n_pad):
    rows = np.stack([
        np.concatenate([
            rng.integers(-1, 4, caps[0]), rng.integers(-1, 3, caps[1]),
            rng.integers(-1, 3, caps[2]), rng.integers(-1, 2, caps[3]),
        ]).astype(np.int32)
        for _ in range(n_q)
    ])
    idfs = rng.uniform(0.2, 2.5, rows.shape).astype(np.float32)
    params = np.stack([
        np.array([12.0, float(rng.integers(1, 3)), -3.0e38 if q % 2 else 0.3], np.float32)
        for q in range(n_q)
    ])
    masks = rng.random((n_q, n_pad)) > 0.15
    return rows, idfs, params, masks


@pytest.mark.parametrize("odense_base", [8, 48, 56, 63])
def test_overlay_window_clamps_as_reference(odense_base):
    """An overlay window starting near the end of the score space: at 56 and
    63 it would run past n_pad = 64, and ``dynamic_slice`` moves its start
    back to n_pad - opad = 48 (Python slicing would cut it short)."""
    rng = np.random.default_rng(odense_base)
    tiers, dense, odense, dlen, caps = _overlay_arena(rng)
    rows, idfs, params, masks = _arena_queries(rng, 3, caps, 64)
    jt = tuple(tuple(jnp.asarray(a) for a in t) for t in tiers)
    tt = tuple(tuple(torch.from_numpy(a) for a in t) for t in tiers)
    for q in range(rows.shape[0]):
        for with_counts in (True, False):
            js, jic, jm = jeng._bm25_search(
                jt, jnp.asarray(dense), jnp.asarray(odense), jnp.asarray(dlen), jnp.asarray(masks[q]),
                jnp.asarray(rows[q]), jnp.asarray(idfs[q]), jnp.asarray(params[q]), 12, caps, odense_base,
                with_counts,
            )
            ts, tic, tm = teng._bm25_search(
                tt, torch.from_numpy(dense), torch.from_numpy(odense), torch.from_numpy(dlen),
                torch.from_numpy(masks[q]), torch.from_numpy(rows[q]), torch.from_numpy(idfs[q]),
                torch.from_numpy(params[q]), 12, caps, odense_base, with_counts,
            )
            jic = np.asarray(jic)
            assert_same_results(np.asarray(js)[None], jic[None, :12], ts.numpy()[None], tic.numpy()[None, :12])
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
            assert dict(zip(tic.numpy()[:12], tic.numpy()[12:])) == dict(zip(jic[:12], jic[12:]))


@pytest.mark.parametrize("shared_mask,count_only", [(True, False), (False, False), (False, True)])
def test_bm25_search_batch_matches_reference(shared_mask, count_only):
    rng = np.random.default_rng(11)
    tiers, dense, odense, dlen, caps = _overlay_arena(rng)
    rows, idfs, params, masks = _arena_queries(rng, 5, caps, 64)
    mask = masks[0] if shared_mask else masks
    js, jic, jm = jeng._bm25_search_batch(
        tuple(tuple(jnp.asarray(a) for a in t) for t in tiers), jnp.asarray(dense), jnp.asarray(odense),
        jnp.asarray(dlen), jnp.asarray(mask), jnp.asarray(rows), jnp.asarray(idfs), jnp.asarray(params),
        9, caps, 56, shared_mask=shared_mask, count_only=count_only,
    )
    before = bm25.DISPATCHES["arena_batch"]
    ts, tic, tm = teng._bm25_search_batch(
        tuple(tuple(torch.from_numpy(a) for a in t) for t in tiers), torch.from_numpy(dense),
        torch.from_numpy(odense), torch.from_numpy(dlen), torch.from_numpy(mask), torch.from_numpy(rows),
        torch.from_numpy(idfs), torch.from_numpy(params), 9, caps, 56,
        shared_mask=shared_mask, count_only=count_only,
    )
    assert bm25.DISPATCHES["arena_batch"] == before + 1
    jic = np.asarray(jic)
    assert_same_results(np.asarray(js), jic[:, :9], ts.numpy(), tic.numpy()[:, :9])
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    # each row equals its single-query program
    for q in range(rows.shape[0]):
        s1, ic1, _ = teng._bm25_search(
            tuple(tuple(torch.from_numpy(a) for a in t) for t in tiers), torch.from_numpy(dense),
            torch.from_numpy(odense), torch.from_numpy(dlen), torch.from_numpy(masks[0] if shared_mask else masks[q]),
            torch.from_numpy(rows[q]), torch.from_numpy(idfs[q]), torch.from_numpy(params[q]), 9, caps, 56,
        )
        np.testing.assert_array_equal(s1.numpy(), ts.numpy()[q])
        np.testing.assert_array_equal(ic1.numpy(), tic.numpy()[q])
    with pytest.raises(ValueError, match="shared_mask"):
        teng._bm25_search_batch(
            tuple(tuple(torch.from_numpy(a) for a in t) for t in tiers), torch.from_numpy(dense), None,
            torch.from_numpy(dlen), torch.from_numpy(masks), torch.from_numpy(rows), torch.from_numpy(idfs),
            torch.from_numpy(params), 9, caps, 0, shared_mask=True,
        )


RRF_CASES = {
    # every id in one list only: rank r of a ties rank r of b exactly
    "tied_ranks": (np.array([[1, 2, 3, 4], [9, 8, 7, 6]]), np.array([[11, 12, 13, 14], [19, 18, 17, 16]]), 6, 1.0, 1.0),
    # shared ids (a first-occurrence dedup) and -1 pads in both lists
    "shared_and_pads": (np.array([[5, 3, -1, -1], [2, 4, 6, 8]]), np.array([[3, 7, 5, -1], [8, -1, -1, -1]]), 5, 1.0, 1.0),
    # k above the candidates: padded to [B, k]
    "short_lists": (np.array([[0, 1], [-1, -1]]), np.array([[2], [3]]), 7, 1.0, 1.0),
    # boosts that make ranks of the two lists tie across positions
    "boosted": (np.array([[10, 20, 30, 40, 50]]), np.array([[60, 70, 80, 90, 10]]), 8, 2.0, 0.5),
}


@pytest.mark.parametrize("case", sorted(RRF_CASES))
def test_rrf_merge_matches_reference(case):
    a, b, k, boost_a, boost_b = RRF_CASES[case]
    js, ji = jfusion.rrf_merge(jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32), k, boost_a=boost_a, boost_b=boost_b)
    ts, ti = fusion.rrf_merge(torch.from_numpy(a), torch.from_numpy(b), k, boost_a=boost_a, boost_b=boost_b)
    assert ts.shape == (a.shape[0], k) and fusion.RRF_K == jfusion.RRF_K
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _jax_allgather(scores, ids, k):
    """The JAX package's ``sharded_topk_allgather`` inside a shard_map over
    a 4-device ``shard`` axis (the members' cuts side by side on axis -1)."""
    n = len(scores)
    mesh = JMesh(np.array(jax.devices()[:n]), ("shard",))
    fn = shard_map(
        lambda s, i: jtopk.sharded_topk_allgather(s, i, k, "shard"),
        mesh=mesh, in_specs=(P(None, "shard"), P(None, "shard")), out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(jnp.asarray(np.concatenate(scores, -1)), jnp.asarray(np.concatenate(ids, -1)))


def test_sharded_topk_allgather_ties_across_members():
    """Equal scores on several members, empty (-1) slots and a row with
    fewer valid entries than k: the earlier member wins a tie, as under
    ``lax.top_k`` over the tiled all-gather."""
    rng = np.random.default_rng(5)
    b, k, n = 3, 4, 4
    scores, ids = [], []
    for m in range(n):
        s = np.sort(rng.choice(np.array([0.5, 0.25, 0.125, 1.0], np.float32), (b, k)), axis=-1)[:, ::-1].copy()
        s[2, 0] = 0.5  # row 2: one valid entry a member, the same score on each
        s[2, 1:] = jtopk.NEG_INF
        i = (np.arange(k) + 100 * m)[None].repeat(b, 0).astype(np.int32)
        i[2, 1:] = -1
        scores.append(s)
        ids.append(i)
    js, ji = _jax_allgather(scores, ids, k)
    ts, ti = topk.sharded_topk_allgather(
        [torch.from_numpy(s) for s in scores], [torch.from_numpy(i) for i in ids], k,
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ti.numpy()[2].tolist() == [0, 100, 200, 300]  # member order among the ties
