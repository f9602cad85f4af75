"""The port's vector index (nucliadb_tpu_torch.index.vector) against the JAX
package's, on the CPU, on the same segment files.

- Segments written by either package read back identically in the other.
- The host tier and ``_search_exact``: the port's ``VectorSearcher`` against
  the JAX ``VectorSearcher``.
- The int8 route: on the CPU the JAX package sends int8 candidates to
  ``approx_max_k``, so its reference is the TPU route rebuilt from the
  package's own functions, with the Pallas kernel in interpret mode.

Ids must be equal and scores agree within rtol 1e-5 (f32 sums in another
order); where reference scores lie within that tolerance of each other,
only the set of ids in that run must agree.
"""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nucliadb_tpu.index.vector.device as jdevice
import nucliadb_tpu.index.vector.segment as jsegment
import nucliadb_tpu_torch.index.vector.device as tdevice
import nucliadb_tpu_torch.index.vector.segment as tsegment
from nucliadb_tpu.index import vector as jvector
from nucliadb_tpu.ops import pallas_scan
from nucliadb_tpu.ops.distance import prepare_query
from nucliadb_tpu.query_language import FacetPrefixAtom, KeyPrefixAtom, LabelAtom, not_
from nucliadb_tpu.types import FieldId, PrefilterResult, Seq, SimpleOpenIndex
from nucliadb_tpu_torch.index import vector as tvector
from nucliadb_tpu_torch.ops import slot_scan
from torch_test_helpers import assert_same_results

DIM = 64


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


def _elems(mod, rng, n, d, start, dup=None):
    elems = []
    for i in range(n):
        gid = start + i
        v = rng.standard_normal((1, d)).astype(np.float32)
        lab = ["/l/ls/even"] if gid % 2 == 0 else ["/l/ls/odd"]
        meta = {"field": "f1", "split": None, "position": {"start": 0, "end": 10}}
        elems.append(mod.Elem(key=f"r{gid % 5}/f1/{gid}/0-10", vectors=v, labels=lab, metadata=meta))
    if dup is not None:
        for j in range(3):
            elems.append(mod.Elem(key=f"dup{j}/f1/{j}/0-10", vectors=dup[None], labels=["/l/ls/even"]))
    return elems


def _assert_same_hits(ref_hits, got_hits):
    assert len(ref_hits) == len(got_hits)
    for ref, got in zip(ref_hits, got_hits):
        keys = {h.key: i for i, h in enumerate(ref)}
        ids_ref = np.arange(len(ref))[None]
        ids_got = np.array([[keys.get(h.key, -2 - i) for i, h in enumerate(got)]])
        assert_same_results(
            [[h.score for h in ref]], ids_ref, [[h.score for h in got]], ids_got
        )
        for h in got:
            r = ref[keys[h.key]]
            assert sorted(h.labels) == sorted(r.labels) and h.metadata == r.metadata


# --------------------------------------------------------------------------
# segment files
# --------------------------------------------------------------------------


def _segment_fields(seg):
    return (
        np.asarray(seg.vectors), np.asarray(seg.vec_para), seg.keys,
        {k: v.tolist() for k, v in seg.labels.items()}, seg.para_meta, seg.tags,
        seg.config.to_dict(), seg.n_paragraphs,
    )


@pytest.mark.parametrize("similarity", ["dot", "cosine"])
def test_segments_read_back_across_packages(tmp_path, similarity):
    rng = np.random.default_rng(20)
    dup = rng.standard_normal(DIM).astype(np.float32)
    elems = _elems(jsegment, rng, 50, DIM, 0, dup=dup)
    jcfg = jvector.VectorConfig(dimension=DIM, similarity=similarity)
    tcfg = tvector.VectorConfig(dimension=DIM, similarity=similarity)
    jmeta = jsegment.create_segment(str(tmp_path / "j"), elems, jcfg, tags=["hidden"])
    telems = [tsegment.Elem(e.key, e.vectors, e.labels, e.metadata) for e in elems]
    tmeta = tsegment.create_segment(str(tmp_path / "t"), telems, tcfg, tags=["hidden"])
    assert tmeta.records == jmeta.records and tmeta.index_metadata == jmeta.index_metadata
    # the same files, byte for byte
    for name in sorted(os.listdir(tmp_path / "j")):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    # each package reads the other's segment identically
    for path in (tmp_path / "j", tmp_path / "t"):
        want = _segment_fields(jsegment.open_segment(str(path)))
        got = _segment_fields(tsegment.open_segment(str(path)))
        for w, g in zip(want, got):
            if isinstance(w, np.ndarray):
                np.testing.assert_array_equal(g, w)
            else:
                assert g == w


def test_config_dict_round_trip_matches_jax():
    for kw in (
        dict(dimension=8),
        dict(dimension=64, similarity="cosine", normalize_vectors=True),
        dict(dimension=32, quantization="binary", flags=["bf16"]),
        dict(dimension=33, quantization="binary"),  # falls back to int8
        dict(dimension=16, cardinality="multi", quantization="none"),
    ):
        jc, tc = jvector.VectorConfig(**kw), tvector.VectorConfig(**kw)
        assert tc.to_dict() == jc.to_dict()
        assert tvector.VectorConfig.from_dict(jc.to_dict()).to_dict() == jc.to_dict()
        assert jvector.VectorConfig.from_dict(tc.to_dict()).to_dict() == tc.to_dict()
        assert tc.normalize == jc.normalize


def test_unported_configurations_raise(tmp_path):
    rng = np.random.default_rng(21)
    elems = _elems(tsegment, rng, 10, DIM, 0)
    for flag in ("hnsw", "ivf"):
        with pytest.raises(NotImplementedError):
            tsegment.create_segment(str(tmp_path / flag), elems, tvector.VectorConfig(DIM, flags=[flag]))
    meta = tsegment.create_segment(str(tmp_path / "s"), elems, tvector.VectorConfig(DIM))
    idx = SimpleOpenIndex(segment_list=[(meta, Seq(1))])
    for cfg in (
        tvector.VectorConfig(DIM, cardinality="multi"),
        tvector.VectorConfig(DIM, quantization="binary"),
        tvector.VectorConfig(DIM, flags=["pallas"]),
    ):
        with pytest.raises(NotImplementedError):
            tvector.VectorSearcher(cfg, idx, device="cpu")
    with mock.patch.dict(os.environ, {"NDBTPU_VECTOR_ARENA_BUDGET": "1000"}):
        with pytest.raises(NotImplementedError):
            tvector.VectorSearcher(tvector.VectorConfig(DIM), idx, device="cpu")


# --------------------------------------------------------------------------
# host tier and _search_exact against the JAX VectorSearcher
# --------------------------------------------------------------------------


def _open_index(tmp_path, similarity, rng, d=DIM, sizes=(80, 80, 40)):
    """Three segments (the last hidden), a duplicated vector, and a
    deletion of prefix r3/ that applies to the first segment only."""
    cfg = jvector.VectorConfig(dimension=d, similarity=similarity)
    dup = rng.standard_normal(d).astype(np.float32)
    segs, start = [], 0
    for s, n in enumerate(sizes):
        elems = _elems(jsegment, rng, n, d, start, dup=dup if s == 1 else None)
        if s == 0:
            elems.append(jsegment.Elem(key="r0/f1/first/0-10", vectors=dup[None], labels=[]))
        meta = jsegment.create_segment(
            str(tmp_path / f"s{s}"), elems, cfg, tags=["hidden"] if s == 2 else []
        )
        segs.append((meta, Seq(s + 1)))
        start += n
    open_index = SimpleOpenIndex(segment_list=segs, deletion_list=[("r3/", Seq(2))])
    return open_index, dup


def _requests(similarity, dup, rng):
    q = np.stack(
        [dup + 0.01 * rng.standard_normal(DIM).astype(np.float32)]
        + [rng.standard_normal(DIM).astype(np.float32) for _ in range(2)]
    )
    floor = 1.0 if similarity == "dot" else 0.05
    return {
        "plain": dict(vectors=q, top_k=10),
        "single": dict(vectors=q[1], top_k=5),
        "label": dict(vectors=q, top_k=10, filter=LabelAtom("/l/ls/even")),
        "not_label": dict(vectors=q, top_k=10, filter=not_(LabelAtom("/l/ls/even"))),
        "facet": dict(vectors=q, top_k=10, filter=FacetPrefixAtom("/l/ls")),
        "key_prefix_atom": dict(vectors=q, top_k=50, filter=KeyPrefixAtom(("r1/",))),
        "prefilter": dict(vectors=q, top_k=50, field_filter=PrefilterResult.some([FieldId("r1", "f1")])),
        "prefilter_none": dict(vectors=q, top_k=5, field_filter=PrefilterResult.none()),
        "prefilter_or": dict(
            vectors=q, top_k=20, filter=LabelAtom("/l/ls/odd"),
            field_filter=PrefilterResult.some([FieldId("r2", "f1")]), filter_operator="or",
        ),
        "key_prefixes": dict(vectors=q, top_k=20, key_prefixes=["r2/f1"]),
        "min_score": dict(vectors=q, top_k=30, min_score=floor),
        "with_duplicates": dict(vectors=q, top_k=10, with_duplicates=True),
        "include_hidden": dict(vectors=q, top_k=10, include_hidden=True),
        "k_beyond_rows": dict(vectors=q, top_k=300, with_duplicates=True),
    }


_SEARCHERS: dict = {}


@pytest.fixture(scope="module")
def searchers(tmp_path_factory):
    def get(similarity, tier):
        key = (similarity, tier)
        if key not in _SEARCHERS:
            rng = np.random.default_rng(22)
            open_index, dup = _open_index(tmp_path_factory.mktemp(f"{similarity}{tier}"), similarity, rng)
            elems = 0 if tier == "exact" else tdevice.HOST_SCAN_ELEMS
            with mock.patch.object(jdevice, "HOST_SCAN_ELEMS", elems), mock.patch.object(
                tdevice, "HOST_SCAN_ELEMS", elems
            ):
                cfg = jvector.VectorConfig(dimension=DIM, similarity=similarity)
                js = jvector.VectorSearcher(cfg, open_index)
                ts = tvector.VectorSearcher(
                    tvector.VectorConfig.from_dict(cfg.to_dict()), open_index, device="cpu"
                )
            assert (ts.index._host_arena is None) == (tier == "exact")
            _SEARCHERS[key] = (js, ts, _requests(similarity, dup, rng))
        return _SEARCHERS[key]

    yield get
    _SEARCHERS.clear()


REQUESTS = sorted(_requests("dot", np.zeros(DIM, np.float32), np.random.default_rng(0)))


@pytest.mark.parametrize("request_name", REQUESTS)
@pytest.mark.parametrize("similarity", ["dot", "cosine"])
@pytest.mark.parametrize("tier", ["host", "exact"])
def test_searcher_matches_jax(searchers, tier, similarity, request_name):
    js, ts, requests = searchers(similarity, tier)
    kw = requests[request_name]
    ref = js.search(jvector.VectorSearchRequest(**kw))
    got = ts.search(tvector.VectorSearchRequest(**kw))
    _assert_same_hits(ref, got)
    if request_name == "prefilter_none":
        assert got == [[] for _ in got]
    if request_name in ("plain", "with_duplicates"):
        dups = [h.key for h in got[0] if h.key.startswith("dup") or h.key == "r0/f1/first/0-10"]
        assert len(dups) == (1 if request_name == "plain" else 4)


# --------------------------------------------------------------------------
# the int8 route against the rebuilt JAX TPU route
# --------------------------------------------------------------------------

INT8_DIM = 128


def _jax_tpu_route(jidx, q, k, mask, min_score, dedup):
    """device.py:_search_int8 as the TPU runs it (:929-945), on the CPU:
    prepare_query, query quantisation, the resident2 Pallas kernel in
    interpret mode, lax.top_k over the slot table, the NEG_INF/2 cut and
    _rerank_and_cut."""
    sim = jidx.config.similarity.value
    b_pad = jdevice.bucket(q.shape[0], minimum=8)
    qp = np.zeros((b_pad, q.shape[1]), np.float32)
    qp[: q.shape[0]] = q
    qj = prepare_query(jnp.asarray(qp), sim)
    qs = jnp.maximum(jnp.max(jnp.abs(qj), axis=-1), 1e-12) / 127.0
    qc = jnp.clip(jnp.round(qj / qs[:, None]), -127, 127).astype(jnp.int8)
    slot_s, slot_i = pallas_scan.int8_scan_slots_resident2(
        qc, jidx.codes.codes, jidx.codes.scale, jnp.asarray(mask), interpret=True
    )
    budget = jdevice.quant.int8_rerank_budget(k)
    assert budget <= 2 * pallas_scan.RESIDENT2_SLOTS
    top_s, pos = jax.lax.top_k(slot_s, min(budget, slot_s.shape[-1]))
    cand = jnp.where(
        top_s > pallas_scan.NEG_INF / 2, jnp.take_along_axis(slot_i, pos, axis=-1), -1
    )
    ms = jnp.float32(jdevice.NEG_INF if min_score is None else min_score)
    s, i = jdevice._rerank_and_cut(jidx.vectors, qj, cand, ms, k, dedup=dedup)
    return np.asarray(s)[: q.shape[0]], np.asarray(i)[: q.shape[0]]


_INT8: dict = {}


@pytest.fixture(scope="module")
def int8_searchers(tmp_path_factory):
    """Both packages over the same 3,000 x 128 corpus (p_pad 4096) with the
    exact-scan threshold lowered to 256, so the int8 route and the slot-scan
    gate hold."""

    def get(similarity):
        if similarity not in _INT8:
            rng = np.random.default_rng(23)
            open_index, dup = _open_index(
                tmp_path_factory.mktemp(f"int8{similarity}"), similarity, rng,
                d=INT8_DIM, sizes=(1500, 1200, 300),
            )
            cfg = jvector.VectorConfig(dimension=INT8_DIM, similarity=similarity)
            with mock.patch.object(jdevice, "EXACT_SCAN_THRESHOLD", 256), mock.patch.object(
                tdevice, "EXACT_SCAN_THRESHOLD", 256
            ):
                js = jvector.VectorSearcher(cfg, open_index)
                ts = tvector.VectorSearcher(
                    tvector.VectorConfig.from_dict(cfg.to_dict()), open_index, device="cpu"
                )
            q = np.stack(
                [dup + 0.01 * rng.standard_normal(INT8_DIM).astype(np.float32)]
                + [rng.standard_normal(INT8_DIM).astype(np.float32) for _ in range(4)]
            )
            _INT8[similarity] = (js, ts, open_index, q)
        return _INT8[similarity]

    yield get
    _INT8.clear()


@pytest.mark.parametrize("similarity", ["dot", "cosine"])
def test_int8_arena_and_codes_bit_identical(int8_searchers, similarity):
    js, ts, _, _ = int8_searchers(similarity)
    j, t = js.index, ts.index
    assert t.p_pad == j.p_pad == 4096 and t.n_para == j.n_para
    assert t.codes is not None and isinstance(j.codes, jdevice.quant.Int8Codes)
    np.testing.assert_array_equal(t.vectors.numpy().view(np.int32), np.asarray(j.vectors).view(np.int32))
    np.testing.assert_array_equal(t.codes.codes.numpy(), np.asarray(j.codes.codes))
    np.testing.assert_array_equal(
        t.codes.scale.numpy().view(np.int32), np.asarray(j.codes.scale).view(np.int32)
    )
    np.testing.assert_array_equal(t.base_mask(), j.base_mask())
    assert t.keys == j.keys and t.seg_bounds == j.seg_bounds


INT8_REQUESTS = {
    "plain": dict(top_k=10),
    "label": dict(top_k=10, filter=LabelAtom("/l/ls/even")),
    "min_score": dict(top_k=20, min_score=0.0),
    "key_prefixes": dict(top_k=10, key_prefixes=["r4/"]),
}


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("request_name", sorted(INT8_REQUESTS))
@pytest.mark.parametrize("similarity", ["dot", "cosine"])
def test_int8_route_matches_rebuilt_tpu_route(int8_searchers, similarity, request_name, dedup):
    js, ts, _, q = int8_searchers(similarity)
    kw = dict(INT8_REQUESTS[request_name], with_duplicates=not dedup)
    jreq = jvector.VectorSearchRequest(vectors=q, **kw)
    treq = tvector.VectorSearchRequest(vectors=q, **kw)
    jmask, tmask = js._build_mask(jreq), ts._build_mask(treq)
    if jmask is None:
        assert tmask is None
    else:
        np.testing.assert_array_equal(tmask, jmask)
    full = js.index.base_mask()
    if jmask is not None:
        full[: js.index.n_para] &= jmask
    ref_s, ref_i = _jax_tpu_route(js.index, q, kw["top_k"], full, kw.get("min_score"), dedup)

    calls = []
    real = slot_scan.int8_scan_slots_resident2

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    with mock.patch.object(slot_scan, "int8_scan_slots_resident2", spy):
        got_s, got_i = ts.index.search(
            q, kw["top_k"], para_mask=tmask, min_score=kw.get("min_score"),
            with_duplicates=not dedup,
        )
        hits = ts.search(treq)
    assert calls == [(8, INT8_DIM)] * 2  # the slot-scan route, b_pad 8
    assert_same_results(ref_s, ref_i, got_s, got_i)
    assert [[h.key for h in row] for row in hits] == [
        [ts.index.keys[i] for i in row if i >= 0] for row in got_i
    ]
    if request_name == "plain":
        dups = [h.key for h in hits[0] if h.key.startswith("dup") or h.key == "r0/f1/first/0-10"]
        assert len(dups) == (1 if dedup else 4)


def _reference_state(jidx):
    arrays = dict(
        vectors=np.asarray(jidx.vectors), alive=jidx.alive, para_seg=jidx.para_seg,
    )
    if jidx.codes is not None:
        arrays.update(codes=np.asarray(jidx.codes.codes), scale=np.asarray(jidx.codes.scale))
    return (jidx.keys, jidx.para_meta, jidx.labels, jidx.seg_tags, jidx.seg_bounds, arrays)


@pytest.mark.parametrize("similarity", ["dot", "cosine"])
def test_from_reference_state_matches_own_build(int8_searchers, similarity):
    js, ts, _, q = int8_searchers(similarity)
    cfg = tvector.VectorConfig.from_dict(js.config.to_dict())
    idx = tdevice.DeviceVectorIndex.from_reference_state(
        cfg, *_reference_state(js.index), device="cpu"
    )
    assert idx.codes is not None and idx.p_pad == ts.index.p_pad
    mask = js.index.label_postings("/l/ls/odd")
    pm = np.zeros(idx.n_para, bool)
    pm[mask] = True
    for kwargs in (dict(), dict(para_mask=pm), dict(with_duplicates=False, min_score=0.0)):
        want = ts.index.search(q, 10, **kwargs)
        got = idx.search(q, 10, **kwargs)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    assert [h.key for h in idx.hits(*[a[0] for a in got])] == [
        h.key for h in ts.index.hits(*[a[0] for a in want])
    ]


@pytest.mark.parametrize("threshold", [256, None])
def test_incremental_prev_build_equals_full_build(tmp_path, threshold):
    """A refresh that appends a segment and a deletion writes the delta into
    the previous arena (and its codes) in place; the result equals a full
    build, and the previous index still answers as before."""
    rng = np.random.default_rng(24)
    cfg = tvector.VectorConfig(dimension=INT8_DIM)
    metas = []
    for s, n in enumerate((1200, 900, 500)):
        elems = _elems(tsegment, rng, n, INT8_DIM, s * 2000)
        metas.append((tsegment.create_segment(str(tmp_path / f"s{s}"), elems, cfg), Seq(s + 1)))
    q = rng.standard_normal((3, INT8_DIM)).astype(np.float32)
    patch = threshold if threshold is not None else tdevice.EXACT_SCAN_THRESHOLD
    with mock.patch.object(tdevice, "EXACT_SCAN_THRESHOLD", patch):
        a = tvector.VectorSearcher(cfg, SimpleOpenIndex(segment_list=metas[:2]), device="cpu")
        before = a.index.search(q, 10)
        grown = SimpleOpenIndex(segment_list=metas, deletion_list=[("r2/", Seq(4))])
        b = tvector.VectorSearcher(cfg, grown, prev=a, device="cpu")
        full = tvector.VectorSearcher(cfg, grown, device="cpu")
        # a's tail went to b; another successor of a builds from scratch
        c = tvector.VectorSearcher(cfg, grown, prev=a, device="cpu")
    assert b.index.vectors is a.index.vectors
    assert c.index.vectors is not a.index.vectors
    assert (b.index.codes is not None) == (threshold is not None)
    for other in (full, c):
        assert torch.equal(b.index.vectors, other.index.vectors)
        if threshold is not None:
            assert torch.equal(b.index.codes.codes, other.index.codes.codes)
            assert torch.equal(b.index.codes.scale, other.index.codes.scale)
        for dedup in (True, False):
            got = b.index.search(q, 10, with_duplicates=not dedup)
            want = other.index.search(q, 10, with_duplicates=not dedup)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], want[0])
    after = a.index.search(q, 10)
    np.testing.assert_array_equal(after[1], before[1])
    np.testing.assert_array_equal(after[0], before[0])


@pytest.mark.parametrize("route", ["exact", "int8"])
def test_bf16_arena_matches_jax(tmp_path, route):
    """Flag "bf16": the arena is stored in bfloat16 (no host tier); scores
    accumulate in f32 in both packages."""
    rng = np.random.default_rng(25)
    open_index, dup = _open_index(tmp_path, "dot", rng, d=INT8_DIM, sizes=(1500, 1200, 300))
    cfg = jvector.VectorConfig(dimension=INT8_DIM, flags=["bf16"])
    threshold = 256 if route == "int8" else jdevice.EXACT_SCAN_THRESHOLD
    with mock.patch.object(jdevice, "EXACT_SCAN_THRESHOLD", threshold), mock.patch.object(
        tdevice, "EXACT_SCAN_THRESHOLD", threshold
    ):
        js = jvector.VectorSearcher(cfg, open_index)
        ts = tvector.VectorSearcher(tvector.VectorConfig.from_dict(cfg.to_dict()), open_index, device="cpu")
    assert ts.index.vectors.dtype == torch.bfloat16 and ts.index._host_arena is None
    np.testing.assert_array_equal(
        ts.index.vectors.float().numpy(), np.asarray(js.index.vectors).astype(np.float32)
    )
    q = np.stack([dup] + [rng.standard_normal(INT8_DIM).astype(np.float32) for _ in range(3)])
    for dedup in (True, False):
        got = ts.index.search(q, 10, with_duplicates=not dedup)
        if route == "int8":
            full = js.index.base_mask()
            ref = _jax_tpu_route(js.index, q, 10, full, None, dedup)
        else:
            ref = js.index.search(q, 10, with_duplicates=not dedup)
        assert_same_results(ref[0], ref[1], got[0], got[1])


@pytest.mark.parametrize("similarity", ["dot", "cosine"])
def test_exact_dedup_cut_and_duplicate_mask_match_jax(similarity):
    """The rescore + Fssc cut over given candidates (the ivf/hnsw dedup leg
    in the JAX package) and its duplicate mask, on rows with planted
    copies and -1 candidates."""
    rng = np.random.default_rng(26)
    vectors = rng.standard_normal((300, 32)).astype(np.float32)
    vectors[10:14] = vectors[3]  # four more copies of row 3
    q = rng.standard_normal((4, 32)).astype(np.float32)
    q[0] = vectors[3] + 0.01 * q[0]
    cand = rng.integers(-1, 300, (4, 40)).astype(np.int32)
    cand[:, :6] = [3, 10, 11, 12, 13, -1]
    ms = -1.0e30
    js, ji = jdevice._exact_dedup_cut(
        jnp.asarray(vectors), jnp.asarray(q), jnp.asarray(cand), jnp.float32(ms), 8, similarity
    )
    ts, ti = tdevice._exact_dedup_cut(
        torch.from_numpy(vectors), torch.from_numpy(q), torch.from_numpy(cand), ms, 8, similarity
    )
    assert_same_results(np.asarray(js), np.asarray(ji), ts.numpy(), ti.numpy())
    assert len({3, 10, 11, 12, 13} & set(ti[0].tolist())) == 1
    rows = vectors[np.maximum(cand, 0)]
    valid = cand >= 0
    want = np.asarray(jdevice._duplicate_mask(jnp.asarray(rows), jnp.asarray(valid)))
    got = tdevice._duplicate_mask(torch.from_numpy(rows), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)
