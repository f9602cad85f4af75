"""The ``pallas``-flag int8 route and the binary-code routes of the port's
vector index against the JAX package's, on the CPU, on the same segment
files.

Both packages' block, slot and exact-scan constants are shrunk so that a
3,000 x 128 corpus (p_pad 4096) takes the routes; the JAX package runs its
Pallas kernels in interpret mode on the CPU. Each request must take the
same route in both packages:

- int8 + ``pallas``: ``_search_int8_pallas`` (top-1 slot scan);
- binary + ``pallas``, bucketed batch <= 64: ``_search_binary_pallas``
  (popcount slot scan);
- binary, batch > 64: ``_search_binary`` (exact top-c of the optimistic
  estimates, chunked in the port).

Results compare with ``assert_same_results``: ids equal and scores within
rtol 1e-5, id sets inside runs of near-equal reference scores. The int8
slot tables are bit-identical in the two packages; the binary ones agree
within rtol 1e-5 (``tests/test_torch_binary.py``), which the final exact
rerank absorbs on this corpus.
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

import nucliadb_tpu.index.vector.device as jdevice
import nucliadb_tpu.index.vector.segment as jsegment
import nucliadb_tpu_torch.index.vector.device as tdevice
from nucliadb_tpu.index import vector as jvector
from nucliadb_tpu.ops import pallas_scan
from nucliadb_tpu.query_language import LabelAtom
from nucliadb_tpu.types import Seq, SimpleOpenIndex
from nucliadb_tpu_torch.index import vector as tvector
from nucliadb_tpu_torch.ops import binary_scan, slot_scan
from torch_test_helpers import RTOL, as_port, assert_same_results

DIM = 128
ROUTES = ("_search_int8", "_search_int8_pallas", "_search_binary", "_search_binary_pallas")


@pytest.fixture(scope="module", autouse=True)
def small_blocks():
    """The JAX test's shrunk blocks (tests/test_pallas_scan.py:243-245) on
    both sides, and the exact-scan threshold below the corpus."""
    with contextlib.ExitStack() as stack:
        for mod, name, value in (
            (jdevice, "EXACT_SCAN_THRESHOLD", 256),
            (tdevice, "EXACT_SCAN_THRESHOLD", 256),
            (pallas_scan, "BLOCK_N", 512),
            (pallas_scan, "SLOTS", 256),
            (pallas_scan, "BINARY_BLOCK_N", 512),
            (slot_scan, "BLOCK_N", 512),
            (slot_scan, "SLOTS", 256),
            (binary_scan, "BINARY_BLOCK_N", 512),
        ):
            stack.enter_context(mock.patch.object(mod, name, value))
        yield


def _open_index(tmp_path, cfg, rng, sizes=(1500, 1200, 300)):
    """Three segments of labelled paragraphs, a vector stored four times,
    and a deletion of prefix r3/ that applies to the first segment."""
    dup = rng.standard_normal(DIM).astype(np.float32)
    segs, start = [], 0
    for s, n in enumerate(sizes):
        elems = [
            jsegment.Elem(
                key=f"r{gid % 5}/f1/{gid}/0-10",
                vectors=rng.standard_normal((1, DIM)).astype(np.float32),
                labels=["/l/ls/even" if gid % 2 == 0 else "/l/ls/odd"],
            )
            for gid in range(start, start + n)
        ]
        if s == 1:
            elems += [jsegment.Elem(key=f"dup{j}/f1/{j}/0-10", vectors=dup[None]) for j in range(3)]
        if s == 0:
            elems.append(jsegment.Elem(key="r0/f1/first/0-10", vectors=dup[None]))
        segs.append((jsegment.create_segment(str(tmp_path / f"s{s}"), elems, cfg), Seq(s + 1)))
        start += n
    return SimpleOpenIndex(segment_list=segs, deletion_list=[("r3/", Seq(2))]), dup


_SEARCHERS: dict = {}


@pytest.fixture(scope="module")
def searchers(tmp_path_factory):
    def get(quantization, similarity):
        key = (quantization, similarity)
        if key not in _SEARCHERS:
            rng = np.random.default_rng(40)
            cfg = jvector.VectorConfig(
                dimension=DIM, similarity=similarity, quantization=quantization, flags=["pallas"]
            )
            open_index, dup = _open_index(tmp_path_factory.mktemp(f"{quantization}{similarity}"), cfg, rng)
            js = jvector.VectorSearcher(cfg, open_index)
            ts = tvector.VectorSearcher(
                tvector.VectorConfig.from_dict(cfg.to_dict()), as_port(open_index), device="cpu"
            )
            q = rng.standard_normal((100, DIM)).astype(np.float32)
            q[0] = dup + 0.01 * q[0]
            _SEARCHERS[key] = (js, ts, q)
        return _SEARCHERS[key]

    yield get
    _SEARCHERS.clear()


REQUESTS = {
    "plain": dict(n_queries=5, top_k=10),
    "label": dict(n_queries=5, top_k=10, filter=LabelAtom("/l/ls/even")),
    "min_score": dict(n_queries=5, top_k=20, min_score=0.0),
    "batch_over_64": dict(n_queries=100, top_k=10),
}


def _expected_route(quantization, n_queries):
    if quantization == "int8":
        return "_search_int8_pallas"
    return "_search_binary_pallas" if n_queries <= 64 else "_search_binary"


@contextlib.contextmanager
def _route_spy(module, taken):
    with contextlib.ExitStack() as stack:
        for name in ROUTES:
            real = getattr(module, name)

            def spy(*args, _name=name, _real=real, **kwargs):
                taken.append(_name)
                return _real(*args, **kwargs)

            stack.enter_context(mock.patch.object(module, name, spy))
        yield


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("request_name", sorted(REQUESTS))
@pytest.mark.parametrize("similarity", ["dot", "cosine"])
@pytest.mark.parametrize("quantization", ["int8", "binary"])
def test_route_matches_jax(searchers, quantization, similarity, request_name, dedup):
    js, ts, queries = searchers(quantization, similarity)
    kw = dict(REQUESTS[request_name])
    q = queries[: kw.pop("n_queries")]
    kw["with_duplicates"] = not dedup
    if similarity == "cosine" and "min_score" in kw:
        kw["min_score"] = 0.05
    jreq = jvector.VectorSearchRequest(vectors=q, **kw)
    treq = tvector.VectorSearchRequest(vectors=q, **as_port(kw))
    jmask, tmask = js._build_mask(jreq), ts._build_mask(treq)
    if jmask is None:
        assert tmask is None
    else:
        np.testing.assert_array_equal(tmask, jmask)
    search_kw = dict(min_score=kw.get("min_score"), with_duplicates=not dedup)
    jroutes, troutes = [], []
    with _route_spy(jdevice, jroutes):
        ref_s, ref_i = js.index.search(q, kw["top_k"], para_mask=jmask, **search_kw)
    launches = (dict(slot_scan.LAUNCHES), dict(binary_scan.LAUNCHES))
    with _route_spy(tdevice, troutes):
        got_s, got_i = ts.index.search(q, kw["top_k"], para_mask=tmask, **search_kw)
        hits = ts.search(treq)
    want = _expected_route(quantization, q.shape[0])
    assert jroutes == [want] and troutes == [want] * 2
    assert (dict(slot_scan.LAUNCHES), dict(binary_scan.LAUNCHES)) == launches  # plain versions
    assert_same_results(ref_s, ref_i, got_s, got_i)
    assert [[h.key for h in row] for row in hits] == [
        [ts.index.keys[i] for i in row if i >= 0] for row in got_i
    ]
    if request_name == "plain":
        dups = [h.key for h in hits[0] if h.key.startswith("dup") or h.key == "r0/f1/first/0-10"]
        assert len(dups) == (1 if dedup else 4)
    if request_name == "label":
        assert all("/l/ls/even" in h.labels for row in hits for h in row)


@pytest.mark.parametrize("similarity", ["dot", "cosine"])
def test_binary_codes_match_jax(searchers, similarity):
    js, ts, _ = searchers("binary", similarity)
    j, t = js.index.codes, ts.index.codes
    assert isinstance(t, tdevice.quant.BinaryCodes) and isinstance(j, jdevice.quant.BinaryCodes)
    assert ts.index.p_pad == js.index.p_pad == 4096 and t.dim == j.dim == DIM
    np.testing.assert_array_equal(t.codes_t.numpy(), np.asarray(j.codes_t).view(np.int32))
    np.testing.assert_array_equal(t.popcnt.numpy(), np.asarray(j.popcnt))
    for name in ("scale", "resid"):
        np.testing.assert_allclose(
            getattr(t, name).numpy(), np.asarray(getattr(j, name)), rtol=RTOL, atol=1e-6
        )


def _reference_state(jidx):
    codes = jidx.codes
    arrays = dict(
        vectors=np.asarray(jidx.vectors), alive=jidx.alive, para_seg=jidx.para_seg,
        codes_t=np.asarray(codes.codes_t), bin_scale=np.asarray(codes.scale),
        resid=np.asarray(codes.resid), popcnt=np.asarray(codes.popcnt),
    )
    return (jidx.keys, jidx.para_meta, jidx.labels, jidx.seg_tags, jidx.seg_bounds, arrays)


@pytest.mark.parametrize("n_queries", [5, 100])
def test_from_reference_state_binary_answers_as_jax(searchers, n_queries):
    """An index carrying a JAX index's binary codes (u32 words taken as
    int32) answers as the JAX index does, on both binary routes."""
    js, ts, queries = searchers("binary", "dot")
    q = queries[:n_queries]
    cfg = tvector.VectorConfig.from_dict(js.config.to_dict())
    idx = tdevice.DeviceVectorIndex.from_reference_state(
        cfg, *_reference_state(js.index), device="cpu"
    )
    assert isinstance(idx.codes, tdevice.quant.BinaryCodes) and idx.codes.dim == DIM
    np.testing.assert_array_equal(
        idx.codes.codes_t.numpy(), np.asarray(js.index.codes.codes_t).view(np.int32)
    )
    pm = np.zeros(idx.n_para, bool)
    pm[js.index.label_postings("/l/ls/odd")] = True
    for kwargs in (dict(), dict(para_mask=pm), dict(with_duplicates=False, min_score=0.0)):
        want = js.index.search(q, 10, **kwargs)
        got = idx.search(q, 10, **kwargs)
        assert_same_results(want[0], want[1], got[0], got[1])


def test_binary_incremental_refresh_equals_full_build(tmp_path):
    """A refresh writes the delta into the previous arena in place and
    re-encodes the whole arena, as the JAX package does: its codes equal a
    full build's, and the previous index still answers as before."""
    rng = np.random.default_rng(41)
    cfg = tvector.VectorConfig(dimension=DIM, quantization="binary", flags=["pallas"])
    metas = []
    for s, n in enumerate((1200, 900, 500)):
        elems = [
            tvector.Elem(key=f"r{s}/f/{i}", vectors=rng.standard_normal((1, DIM)).astype(np.float32))
            for i in range(n)
        ]
        metas.append((tvector.create_segment(str(tmp_path / f"s{s}"), elems, cfg), tvector.Seq(s + 1)))
    q = rng.standard_normal((3, DIM)).astype(np.float32)
    a = tvector.VectorSearcher(cfg, tvector.SimpleOpenIndex(segment_list=metas[:2]), device="cpu")
    before = a.index.search(q, 10)
    grown = tvector.SimpleOpenIndex(segment_list=metas, deletion_list=[("r1/", tvector.Seq(4))])
    b = tvector.VectorSearcher(cfg, grown, prev=a, device="cpu")
    full = tvector.VectorSearcher(cfg, grown, device="cpu")
    assert b.index.vectors is a.index.vectors and b.index.codes is not a.index.codes
    for name in ("codes_t", "scale", "resid", "popcnt"):
        assert torch.equal(getattr(b.index.codes, name), getattr(full.index.codes, name)), name
    for dedup in (True, False):
        got = b.index.search(q, 10, with_duplicates=not dedup)
        want = full.index.search(q, 10, with_duplicates=not dedup)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    after = a.index.search(q, 10)
    np.testing.assert_array_equal(after[1], before[1])
    np.testing.assert_array_equal(after[0], before[0])
