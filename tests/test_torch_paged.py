"""The port's beyond-HBM paged tiers against the JAX package's, on the CPU.

``NDBTPU_VECTOR_ARENA_BUDGET`` caps the device bytes of one index; above
it the f32 arena stays in host memory and the index opens in the
``host_rerank`` tier (int8 codes on the device, encoded on the host) or the
``stream`` tier (chunked exact scans of the host arena). Every scenario of
``tests/test_beyond_hbm.py`` runs on both packages over the same segment
files: the tiers must be the same, ids equal and scores within the
helpers' ``RTOL`` (1e-5), and the port's paged codes equal the JAX
package's ``_host_int8_encode`` bit for bit.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nucliadb_tpu.index.vector.device as jdevice
import nucliadb_tpu_torch.index.vector.device as tdevice
from nucliadb_tpu.index import vector as jvector
from nucliadb_tpu.index.vector.config import Quantization
from nucliadb_tpu.index.vector.segment import create_segment
from nucliadb_tpu.ops import pallas_scan
from nucliadb_tpu.ops.distance import prepare_query
from nucliadb_tpu.query_language import LabelAtom
from nucliadb_tpu.types import Seq, SimpleOpenIndex
from nucliadb_tpu_torch.index import vector as tvector
from nucliadb_tpu_torch.ops import quant as tquant
from nucliadb_tpu_torch.ops import slot_scan
from tests.test_beyond_hbm import CODE_BYTES, D, N, VEC_BYTES
from tests.torch_test_helpers import as_port, assert_same_results

BUDGET = "NDBTPU_VECTOR_ARENA_BUDGET"


def _build(tmp_path, rng, d=D, n=N, quantization=Quantization.INT8, dup_rows=0, flags=()):
    """test_beyond_hbm.py's corpus: n rows, labels even/odd, a deletion of
    prefix r7/, the first ``dup_rows`` rows copies of row 0."""
    cfg = jvector.VectorConfig(dimension=d, similarity="dot", quantization=quantization, flags=list(flags))
    base = rng.standard_normal((n, d)).astype(np.float32)
    if dup_rows:
        base[:dup_rows] = base[0]
    elems = [
        jvector.Elem(key=f"r{i}/f/{i}/0-10", vectors=base[i : i + 1],
                     labels=["/l/t/even"] if i % 2 == 0 else ["/l/t/odd"])
        for i in range(n)
    ]
    meta = create_segment(str(tmp_path / "seg"), elems, cfg)
    oi = SimpleOpenIndex(segment_list=[(meta, Seq(1))], deletion_list=[("r7/", Seq(2))])
    return cfg, oi, base


def _open_both(cfg, oi, budget, monkeypatch):
    if budget:
        monkeypatch.setenv(BUDGET, str(budget))
    else:
        monkeypatch.delenv(BUDGET, raising=False)
    js = jvector.VectorSearcher(cfg, oi)
    ts = tvector.VectorSearcher(tvector.VectorConfig.from_dict(cfg.to_dict()), as_port(oi), device="cpu")
    monkeypatch.delenv(BUDGET, raising=False)
    return js, ts


def _same_hits(want, got):
    assert len(want) == len(got)
    for w_row, g_row in zip(want, got):
        keys = {h.key: i for i, h in enumerate(w_row)}
        ids_got = [[keys.get(h.key, -2 - i) for i, h in enumerate(g_row)]]
        assert_same_results([[h.score for h in w_row]], [list(range(len(w_row)))],
                            [[h.score for h in g_row]], ids_got)


CASES = {
    "plain": dict(top_k=10),
    "label": dict(top_k=10, filter=LabelAtom("/l/t/even")),
    "min_score": dict(top_k=7, min_score=0.5),
    "with_duplicates": dict(top_k=10, with_duplicates=True),
    "k_beyond_candidates": dict(top_k=60, with_duplicates=True),
}


@pytest.mark.parametrize("budget,tier", [
    (0, None),
    (CODE_BYTES + VEC_BYTES // 4, "host_rerank"),
    (CODE_BYTES // 4, "stream"),
    (512 * D * 4, "stream"),
])
def test_paged_tiers_match_jax(tmp_path, monkeypatch, budget, tier):
    """tests/test_beyond_hbm.py::test_paged_tiers_match_resident on both
    packages: the same tier, the JAX package's answers, and (as there) the
    unbudgeted resident index's ids; r7/ (deleted) never comes back."""
    rng = np.random.default_rng(42)
    cfg, oi, vecs = _build(tmp_path, rng)
    js, ts = _open_both(cfg, oi, budget, monkeypatch)
    _, resident = _open_both(cfg, oi, 0, monkeypatch)
    assert js.index.paging == ts.index.paging == tier
    assert ts.index.host_resident() == (tier is None)
    if tier is not None:
        assert ts.index.vectors is None and ts.index.ivf is None and ts.index.graph is None
        np.testing.assert_array_equal(ts.index.vectors_host, js.index.vectors_host)
    if tier == "stream":
        assert ts.index.chunk_rows == js.index.chunk_rows and ts.index.codes is None
    queries = rng.standard_normal((5, D)).astype(np.float32)
    for name, case in CASES.items():
        want = js.search(jvector.VectorSearchRequest(vectors=queries, **case))
        got = ts.search(tvector.VectorSearchRequest(vectors=queries, **as_port(case)))
        _same_hits(want, got)
        if name != "k_beyond_candidates":
            res = resident.search(tvector.VectorSearchRequest(vectors=queries, **as_port(case)))
            assert [[h.key for h in r] for r in got] == [[h.key for h in r] for r in res], name
    hits = ts.search(tvector.VectorSearchRequest(vectors=vecs[7][None], top_k=5))[0]
    assert hits and not any(h.key.startswith("r7/") for h in hits)


def test_stream_tier_dedup_and_chunking(tmp_path, monkeypatch):
    """tests/test_beyond_hbm.py::test_stream_tier_dedup_and_chunking on
    both packages: chunks smaller than the arena, and the Fssc dedup of four
    identical rows across the chunked merge."""
    rng = np.random.default_rng(7)
    cfg, oi, vecs = _build(tmp_path, rng, dup_rows=4)
    js, ts = _open_both(cfg, oi, 512 * D * 4, monkeypatch)
    assert ts.index.paging == js.index.paging == "stream"
    assert ts.index.chunk_rows == js.index.chunk_rows < ts.index.p_pad
    q = vecs[0][None]
    for with_duplicates, n_dups in ((False, 1), (True, 4)):
        req = dict(vectors=q, top_k=6, with_duplicates=with_duplicates)
        got = ts.search(tvector.VectorSearchRequest(**req))
        _same_hits(js.search(jvector.VectorSearchRequest(**req)), got)
        assert sum(np.array_equal(vecs[int(h.key.split("/")[2])], vecs[0]) for h in got[0]) == n_dups


@pytest.mark.parametrize("delta,tier", [(1, "host_rerank"), (-1, "stream")])
def test_host_rerank_capacity_math(tmp_path, monkeypatch, delta, tier):
    """tests/test_beyond_hbm.py::test_host_rerank_capacity_math on both
    packages: a budget one byte above the codes' bytes selects host_rerank,
    one below falls to stream."""
    cfg, oi, _ = _build(tmp_path, np.random.default_rng(3))
    js, ts = _open_both(cfg, oi, CODE_BYTES + delta, monkeypatch)
    assert ts.index.paging == js.index.paging == tier


@pytest.mark.parametrize("quantization,flags,budget", [
    ("int8", ["bf16"], CODE_BYTES + VEC_BYTES // 2 - 1),  # bf16 rows take 2 bytes
    ("int8", ["bf16"], CODE_BYTES + VEC_BYTES // 2),  # fits: resident
    ("binary", [], CODE_BYTES + VEC_BYTES // 2),  # no int8 codes: stream
    ("int8", ["hnsw"], CODE_BYTES + 1),
    ("int8", ["ivf"], CODE_BYTES // 4),
])
def test_tier_choice_matches_jax(tmp_path, monkeypatch, quantization, flags, budget):
    """The tier both packages pick for other configurations; a paged index
    flagged hnsw or ivf builds neither, as in the JAX package."""
    cfg, oi, _ = _build(tmp_path, np.random.default_rng(5), quantization=quantization, flags=flags)
    js, ts = _open_both(cfg, oi, budget, monkeypatch)
    assert ts.index.paging == js.index.paging
    if ts.index.paging is not None:
        assert ts.index.graph is None and ts.index.ivf is None
    q = np.random.default_rng(6).standard_normal((3, D)).astype(np.float32)
    _same_hits(js.search(jvector.VectorSearchRequest(vectors=q, top_k=10)),
               ts.search(tvector.VectorSearchRequest(vectors=q, top_k=10)))


def test_host_int8_encode_bit_for_bit(tmp_path, monkeypatch):
    """The paged codes are the JAX package's ``_host_int8_encode``'s, bit
    for bit: a true division by 127 and by the scale. The resident encoder
    multiplies by f32(1/127) as the JAX package's compiled encoder does,
    and its scales differ in the last bit on some rows: each route keeps
    its own arithmetic."""
    rng = np.random.default_rng(8)
    arena = rng.standard_normal((4096, 64)).astype(np.float32) * rng.uniform(1e-3, 1e3, (4096, 1)).astype(np.float32)
    arena[5] = 0.0
    arena[6, :3] = 1e-30
    want_c, want_s = jdevice._host_int8_encode(arena)
    got_c, got_s = tdevice._host_int8_encode(arena)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_s.view(np.int32), want_s.view(np.int32))
    _, prod_s = tquant.quantize_rows(torch.from_numpy(arena))
    assert (prod_s.numpy().view(np.int32) != want_s.view(np.int32)).any()

    cfg, oi, _ = _build(tmp_path, np.random.default_rng(9))
    js, ts = _open_both(cfg, oi, CODE_BYTES + 1, monkeypatch)
    np.testing.assert_array_equal(ts.index.codes.codes.numpy(), np.asarray(js.index.codes.codes))
    np.testing.assert_array_equal(
        ts.index.codes.scale.numpy().view(np.int32), np.asarray(js.index.codes.scale).view(np.int32)
    )


def _jax_host_rerank_tpu_route(jidx, q, k, mask, min_score, dedup):
    """The JAX package's host_rerank as the TPU runs it (``device.py:661-666``
    with the gate of ``:928-933``), on the CPU: the resident2 Pallas kernel
    in interpret mode over the host-encoded codes, ``lax.top_k`` over its
    slot table, one fetch, ``_host_rerank_cut``."""
    b_pad = jdevice.bucket(q.shape[0], minimum=8)
    qp = np.zeros((b_pad, q.shape[1]), np.float32)
    qp[: q.shape[0]] = q
    qj = prepare_query(jnp.asarray(qp), jidx.config.similarity.value)
    qs = jnp.maximum(jnp.max(jnp.abs(qj), axis=-1), 1e-12) / 127.0
    qc = jnp.clip(jnp.round(qj / qs[:, None]), -127, 127).astype(jnp.int8)
    slot_s, slot_i = pallas_scan.int8_scan_slots_resident2(
        qc, jidx.codes.codes, jidx.codes.scale, jnp.asarray(mask), interpret=True
    )
    top_s, pos = jax.lax.top_k(slot_s, min(jdevice.quant.int8_rerank_budget(k), slot_s.shape[-1]))
    cand = jnp.where(top_s > pallas_scan.NEG_INF / 2, jnp.take_along_axis(slot_i, pos, axis=-1), -1)
    s, i = jidx._host_rerank_cut(np.asarray(qj), np.asarray(cand), k, min_score, dedup)
    return s[: q.shape[0]], i[: q.shape[0]]


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("min_score", [None, 0.0])
def test_host_rerank_takes_the_top2_slot_scan(tmp_path, monkeypatch, dedup, min_score):
    """At a width the slot scan takes (D = 128, p_pad 4096), host_rerank's
    candidates come from ``int8_scan_slots_resident2`` (its plain version
    on the CPU; the CUDA kernel on the card), and the answers equal the JAX
    package's TPU route rebuilt with the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(10)
    cfg, oi, vecs = _build(tmp_path, rng, d=128, n=3000, dup_rows=3)
    budget = 4096 * (128 + 4) + 1
    js, ts = _open_both(cfg, oi, budget, monkeypatch)
    assert js.index.paging == ts.index.paging == "host_rerank"
    q = np.concatenate([vecs[:1] + 0.01, rng.standard_normal((4, 128)).astype(np.float32)])
    mask = js.index.base_mask()
    mask[::3] = False
    calls = []
    real = slot_scan.int8_scan_slots_resident2

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    with mock.patch.object(slot_scan, "int8_scan_slots_resident2", spy):
        got_s, got_i = ts.index.search(q, 10, para_mask=mask, min_score=min_score, with_duplicates=not dedup)
    assert calls == [(8, 128)]
    want_s, want_i = _jax_host_rerank_tpu_route(js.index, q, 10, mask, min_score, dedup)
    assert_same_results(want_s, want_i, got_s, got_i)


@pytest.mark.parametrize("budget", [CODE_BYTES + 1, CODE_BYTES // 4])
def test_from_reference_state_paged(tmp_path, monkeypatch, budget):
    """A paged index carried across from the JAX package's buffers answers
    as the JAX index does."""
    rng = np.random.default_rng(11)
    cfg, oi, _ = _build(tmp_path, rng, dup_rows=3)
    js, _ = _open_both(cfg, oi, budget, monkeypatch)
    j = js.index
    arrays = dict(paging=j.paging, vectors_host=j.vectors_host, alive=j.alive, para_seg=j.para_seg)
    if j.paging == "host_rerank":
        arrays.update(codes=np.asarray(j.codes.codes), scale=np.asarray(j.codes.scale))
    else:
        arrays.update(chunk_rows=j.chunk_rows)
    idx = tdevice.DeviceVectorIndex.from_reference_state(
        tvector.VectorConfig.from_dict(cfg.to_dict()), j.keys, j.para_meta, j.labels, j.seg_tags,
        j.seg_bounds, arrays, device="cpu",
    )
    assert idx.paging == j.paging and not idx.host_resident()
    q = rng.standard_normal((3, D)).astype(np.float32)
    for kw in (dict(), dict(with_duplicates=False, min_score=0.5)):
        want = j.search(q, 10, **kw)
        got = idx.search(q, 10, **kw)
        assert_same_results(*want, *got)


def test_paged_prev_is_never_extended(tmp_path, monkeypatch):
    """A refresh over a paged index builds its arena anew (the paged arena
    has no device prefix to extend), and answers as a fresh build."""
    rng = np.random.default_rng(12)
    cfg, oi, _ = _build(tmp_path, rng)
    tcfg = tvector.VectorConfig.from_dict(cfg.to_dict())
    monkeypatch.setenv(BUDGET, str(CODE_BYTES + 1))
    paged = tvector.VectorSearcher(tcfg, as_port(oi), device="cpu")
    monkeypatch.delenv(BUDGET)
    refreshed = tvector.VectorSearcher(tcfg, as_port(oi), prev=paged, device="cpu")
    fresh = tvector.VectorSearcher(tcfg, as_port(oi), device="cpu")
    assert refreshed.index.paging is None and not paged.index._extended
    q = rng.standard_normal((2, D)).astype(np.float32)
    req = tvector.VectorSearchRequest(vectors=q, top_k=10)
    assert [[h.key for h in r] for r in refreshed.search(req)] == [[h.key for h in r] for r in fresh.search(req)]
