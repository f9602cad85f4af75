"""The port's MULTI cardinality (multivector MaxSim) against the JAX
package's, on the CPU.

- ``_maxsim_core`` against the jitted ``_search_maxsim`` on the same
  arena: B 1-3, M 1-4, 50 paragraphs, m_max 1-8, d 16, dot and cosine,
  masks, ``min_score`` and the slot-block dedup. Data exact in f32 (small
  integers over powers of two) gives equal ids and scores element for
  element; random data equal ids and scores within 1e-5.
- The index: ``tests/test_vector_search.py::test_multivector_maxsim`` and
  ``tests/test_vector_segment.py::test_multivector_elem`` on the port, the
  multi-shard fixture of ``tests/test_mesh_serving.py`` searched shard by
  shard on both packages with both query shapes, ``from_reference_state``.
- The node: ``resource_elems`` of one ``ResourceDoc``, a MULTI shard
  indexed, merged, synced and searched through both packages'
  ``EmbeddedNode``; a ``[M, D]`` vector in a shard request.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nucliadb_tpu.index.vector.device as jdevice
import nucliadb_tpu_torch.index.vector.device as tdevice
import nucliadb_tpu_torch.services as port_services
from nucliadb_tpu.index import vector as jvector
from nucliadb_tpu.index.vector.config import VectorCardinality
from nucliadb_tpu.index.vector.segment import create_segment
from nucliadb_tpu.models.internal import IndexParagraph, ResourceDoc, TextInformation, VectorSentence
from nucliadb_tpu.services import EmbeddedNode
from nucliadb_tpu.shard import ShardSearchRequest
from nucliadb_tpu.storage import MemoryStorage
from nucliadb_tpu.types import Seq, SimpleOpenIndex
from nucliadb_tpu_torch.index import vector as tvector
from nucliadb_tpu_torch.index.vector import segment as tsegment
from nucliadb_tpu_torch.storage import MemoryStorage as PortMemoryStorage
from tests.torch_test_helpers import as_port, assert_same_response, assert_same_results

D = 16
N_PARA = 50
P_PAD = 64


def _arena(rng, m_max, exact, dups=True):
    """[P_PAD * m_max, D] slots and m_count: paragraph p holds m_count[p]
    vectors, zero-padded; the pads (p >= 50) none. Paragraphs 11 and 12
    repeat 10's whole block; 13 holds 10's first vectors but one fewer (a
    different block)."""
    m_count = np.zeros(P_PAD, np.int32)
    m_count[:N_PARA] = rng.integers(1, m_max + 1, N_PARA)
    vectors = np.zeros((P_PAD * m_max, D), np.float32)
    for p in range(N_PARA):
        if exact:
            v = rng.integers(-4, 5, (m_count[p], D)).astype(np.float32) / 4
        else:
            v = rng.standard_normal((m_count[p], D)).astype(np.float32)
        vectors[p * m_max : p * m_max + m_count[p]] = v
    if dups and m_max > 1:
        m_count[10] = m_max
        block = vectors[10 * m_max : 11 * m_max]
        block[:] = rng.integers(-4, 5, block.shape) / 4 if exact else rng.standard_normal(block.shape)
        for p in (11, 12):
            m_count[p] = m_max
            vectors[p * m_max : (p + 1) * m_max] = block
        m_count[13] = m_max - 1
        vectors[13 * m_max : 14 * m_max] = 0
        vectors[13 * m_max : 14 * m_max - 1] = block[:-1]
    return vectors, m_count


def _queries(rng, b, m, exact, near=None):
    if exact:
        q = rng.integers(-4, 5, (b, m, D)).astype(np.float32) / 8
    else:
        q = rng.standard_normal((b, m, D)).astype(np.float32)
    if near is not None:
        q[0, : near.shape[0]] = near[: q.shape[1]]
    if m > 1:
        q[-1, -1] = 0.0  # a padding row of the query
    return q


CORE_CASES = [
    # (similarity, exact, b, m, m_max)
    ("dot", True, 1, 1, 1),
    ("dot", True, 2, 3, 4),
    ("dot", True, 3, 4, 8),
    ("dot", True, 3, 2, 6),
    ("dot", False, 2, 4, 8),
    ("dot", False, 1, 2, 3),
    ("cosine", False, 3, 3, 4),
    ("cosine", False, 2, 1, 8),
]


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("floor", [False, True])
@pytest.mark.parametrize("case", CORE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_maxsim_core_matches_jax(case, floor, dedup):
    similarity, exact, b, m, m_max = case
    rng = np.random.default_rng(CORE_CASES.index(case))
    vectors, m_count = _arena(rng, m_max, exact)
    q = _queries(rng, b, m, exact, near=vectors[10 * m_max : 11 * m_max])
    qmask = np.abs(q).sum(-1) > 0
    mask = np.zeros(P_PAD, bool)
    mask[:N_PARA] = rng.random(N_PARA) > 0.2
    mask[10:14] = True
    min_score = float(np.float32(np.quantile(rng.standard_normal(100), 0.3))) if floor else jdevice.NEG_INF
    k = 7
    want = jdevice._search_maxsim(
        *map(jnp.asarray, (vectors, m_count, q, qmask, mask, np.float32(min_score))),
        k, m_max, similarity, dedup=dedup,
    )
    want = tuple(np.asarray(a) for a in want)
    got = tdevice._maxsim_core(
        torch.from_numpy(vectors), torch.from_numpy(m_count), torch.from_numpy(q),
        torch.from_numpy(qmask), torch.from_numpy(mask), float(np.float32(min_score)), k, m_max,
        similarity, dedup,
    )
    got = tuple(t.numpy() for t in got)
    if exact:
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    else:
        assert_same_results(want[0], want[1], got[0], got[1])
    if dedup and m_max > 1:
        # 10, 11 and 12 hold one block: at most one of them is kept; 13 is
        # another block
        for row in got[1]:
            assert len({10, 11, 12} & set(row.tolist())) <= 1


# --------------------------------------------------------------------------
# the index
# --------------------------------------------------------------------------


def _multi_cfg(mod, d=D, **kw):
    return mod.VectorConfig(dimension=d, cardinality="multi", **kw)


def test_multivector_maxsim(tmp_path):
    """tests/test_vector_search.py::test_multivector_maxsim on the port: the
    reference's MaxSim (sum over query vectors of the best paragraph
    vector), ranked."""
    rng = np.random.default_rng(0)
    d = 8
    docs = {
        "r1/f1/0-10": rng.standard_normal((3, d)).astype(np.float32),
        "r1/f1/10-20": rng.standard_normal((4, d)).astype(np.float32),
        "r2/f1/0-10": rng.standard_normal((2, d)).astype(np.float32),
    }
    cfg = _multi_cfg(tvector, d)
    meta = tsegment.create_segment(str(tmp_path / "s"), [tvector.Elem(key=k, vectors=v) for k, v in docs.items()], cfg)
    searcher = tvector.VectorSearcher(cfg, tvector.SimpleOpenIndex(segment_list=[(meta, tvector.Seq(1))]), device="cpu")
    q = rng.standard_normal((2, d)).astype(np.float32)
    hits = searcher.search(tvector.VectorSearchRequest(vectors=q[None], top_k=3))[0]
    expected = {k: sum(float(np.max(v @ q[m])) for m in range(2)) for k, v in docs.items()}
    got = {h.key: h.score for h in hits}
    for k, s in got.items():
        np.testing.assert_allclose(s, expected[k], rtol=1e-4)
    assert list(got) == sorted(expected, key=lambda k: -expected[k])


def test_multivector_elem(tmp_path):
    """tests/test_vector_segment.py::test_multivector_elem on the port, and
    the same segment files as the JAX package's."""
    rng = np.random.default_rng(0)
    vecs = [rng.standard_normal((3, 8)).astype(np.float32), rng.standard_normal((2, 8)).astype(np.float32)]
    for mod, name in ((tsegment, "t"), (jvector, "j")):
        elems = [mod.Elem(key="r1/f1/0-10", vectors=vecs[0]), mod.Elem(key="r1/f1/10-20", vectors=vecs[1])]
        meta = mod.create_segment(str(tmp_path / name), elems, _multi_cfg(tvector if mod is tsegment else jvector, 8))
        seg = tsegment.open_segment(meta.path)
        assert seg.n_paragraphs == 2 and seg.vectors.shape[0] == 5
        assert seg.vec_para.tolist() == [0, 0, 0, 1, 1]
    for f in ("vectors.npy", "vec_para.npy", "keys.msgpack"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()


def _build_multi_shard(tmp_path, rng, name, n, d, m_hi, with_deletions, hidden):
    """tests/test_mesh_serving.py's multivector shard: 1-2 segments of 1..m_hi
    vectors a paragraph, optional deletions; here the second segment may
    be hidden. Written by the JAX package; both packages open the files."""
    cfg = jvector.VectorConfig(dimension=d, similarity="dot", cardinality=VectorCardinality.MULTI)
    n_segments = int(rng.integers(1, 3))
    per = -(-n // n_segments)
    segs, gid = [], 0
    for s in range(n_segments):
        elems = []
        for _ in range(min(per, n - gid)):
            m = int(rng.integers(1, m_hi + 1))
            v = rng.standard_normal((m, d)).astype(np.float32)
            elems.append(jvector.Elem(key=f"{name}-r{gid % 7}/f1/{gid}/0-10", vectors=v, labels=[f"/l/{gid % 3}"]))
            gid += 1
        tags = ["hidden"] if hidden and s == 1 else []
        meta = create_segment(str(tmp_path / f"{name}-m{s}"), elems, cfg, tags=tags)
        segs.append((meta, Seq(s + 1)))
    deletions = [(f"{name}-r3/", Seq(n_segments + 1))] if with_deletions else []
    oi = SimpleOpenIndex(segment_list=segs, deletion_list=deletions)
    js = jvector.VectorSearcher(cfg, oi)
    ts = tvector.VectorSearcher(tvector.VectorConfig.from_dict(cfg.to_dict()), as_port(oi), device="cpu")
    return js, ts


@pytest.mark.parametrize("seed", [0, 1])
def test_multivector_shards_match_jax(tmp_path, seed):
    """The multi-shard fixture of tests/test_mesh_serving.py, shard by shard:
    uneven shards, different m_max, deletions, hidden segments, masks,
    label filters, min_score, dedup, [B, D] and [B, M, D] queries."""
    rng = np.random.default_rng(100 + seed)
    d = 16
    shards = [
        _build_multi_shard(tmp_path, rng, f"mv{i}", int(rng.integers(6, 60)), d,
                           m_hi=int(rng.integers(1, 5)), with_deletions=(i % 2 == 0), hidden=(i == 1))
        for i in range(4)
    ]
    for js, ts in shards:
        assert ts.index.m_max == js.index.m_max and ts.index.p_pad == js.index.p_pad
        np.testing.assert_array_equal(ts.index.vectors.numpy(), np.asarray(js.index.vectors))
        np.testing.assert_array_equal(ts.index.m_count.numpy(), np.asarray(js.index.m_count))
        assert not ts.index.host_resident() and ts.index.codes is None
    for trial in range(6):
        k = int(rng.integers(1, 12))
        b = int(rng.integers(1, 4))
        if trial % 2:
            q = rng.standard_normal((b, int(rng.integers(1, 4)), d)).astype(np.float32)
        else:
            q = rng.standard_normal((b, d)).astype(np.float32)
        min_score = float(rng.standard_normal()) if rng.random() < 0.3 else None
        dedup = bool(rng.random() < 0.5)
        for js, ts in shards:
            mask = rng.random(js.index.n_para) < 0.6 if rng.random() < 0.4 else None
            want = js.index.search(q, k, para_mask=mask, min_score=min_score, with_duplicates=not dedup)
            got = ts.index.search(q, k, para_mask=mask, min_score=min_score, with_duplicates=not dedup)
            assert_same_results(*want, *got)
            for kw in (dict(), dict(include_hidden=True), dict(filter=as_port(jvector.LabelAtom("/l/1")))):
                jkw = {**kw, "filter": jvector.LabelAtom("/l/1")} if "filter" in kw else kw
                want_h = js.search(jvector.VectorSearchRequest(vectors=q, top_k=k, **jkw))
                got_h = ts.search(tvector.VectorSearchRequest(vectors=q, top_k=k, **kw))
                assert [[h.key for h in r] for r in got_h] == [[h.key for h in r] for r in want_h]
                for gr, wr in zip(got_h, want_h):
                    np.testing.assert_allclose([h.score for h in gr], [h.score for h in wr], rtol=1e-5, atol=1e-6)


def _single_index(tmp_path, rng, d=D, flags=(), n=40, negate=False):
    """One MULTI segment written by the port, 1..5 vectors a paragraph,
    labels, paragraphs 0 and 1 one block (a duplicate)."""
    elems = []
    for i in range(n):
        v = rng.standard_normal((int(rng.integers(1, 6)), d)).astype(np.float32)
        if negate:
            v = -np.abs(v)
        elems.append(tvector.Elem(key=f"r{i % 4}/f1/{i}/0-10", vectors=v, labels=["/l/even"] if i % 2 == 0 else []))
    elems[1] = tvector.Elem(key=elems[1].key, vectors=elems[0].vectors, labels=[])
    cfg = _multi_cfg(tvector, d, flags=list(flags))
    meta = tsegment.create_segment(str(tmp_path / "seg"), elems, cfg, device="cpu")
    oi = tvector.SimpleOpenIndex(segment_list=[(meta, tvector.Seq(1))])
    return cfg, oi, elems


def test_pad_paragraphs_never_leak(tmp_path):
    """Every real score negative and no min_score: the pad paragraphs (no
    slots, so MaxSim 0) stay out of the cut, as in the JAX package."""
    rng = np.random.default_rng(3)
    cfg, oi, elems = _single_index(tmp_path, rng, negate=True)
    ts = tvector.VectorSearcher(cfg, oi, device="cpu")
    js = jvector.VectorSearcher(jvector.VectorConfig.from_dict(cfg.to_dict()), oi)
    q = np.abs(rng.standard_normal((2, 3, D))).astype(np.float32)
    s, i = ts.index.search(q, 60)
    assert (i[:, :40] >= 0).all() and (i[:, 40:] == -1).all() and (s[:, :40] < 0).all()
    assert_same_results(*js.index.search(q, 60), s, i)


@pytest.mark.parametrize("flags", [["hnsw"], ["ivf"], ["bf16"]])
def test_multi_guards_match_jax(tmp_path, flags):
    """A MULTI index flagged hnsw or ivf builds neither and has no codes or
    host tier, as in the JAX package; a bf16 arena is upcast, the query
    never downcast."""
    rng = np.random.default_rng(4)
    cfg, oi, elems = _single_index(tmp_path, rng, flags=flags, n=300)
    ts = tvector.VectorSearcher(cfg, oi, device="cpu")
    js = jvector.VectorSearcher(jvector.VectorConfig.from_dict(cfg.to_dict()), oi)
    idx = ts.index
    assert idx.graph is None and idx.ivf is None and idx.codes is None and idx._host_arena is None
    assert idx.vectors.dtype == (torch.bfloat16 if flags == ["bf16"] else torch.float32)
    q = rng.standard_normal((3, 2, D)).astype(np.float32)
    for kw in (dict(), dict(with_duplicates=False)):
        assert_same_results(*js.index.search(q, 10, **kw), *idx.search(q, 10, **kw))
    # the duplicate pair 0/1 comes back once under dedup
    q1 = elems[0].vectors[None, :1]
    _, ids = idx.search(q1, 5, with_duplicates=False)
    assert len({0, 1} & set(ids[0].tolist())) == 1


def test_query_shapes_and_refusals(tmp_path):
    """A 3-D query against a single-vector index raises in both packages; a
    2-D query against a MULTI index is MaxSim with M = 1."""
    rng = np.random.default_rng(5)
    cfg, oi, _ = _single_index(tmp_path, rng)
    ts = tvector.VectorSearcher(cfg, oi, device="cpu")
    q = rng.standard_normal((2, D)).astype(np.float32)
    for a, b in zip(ts.index.search(q, 5), ts.index.search(q[:, None, :], 5)):
        np.testing.assert_array_equal(a, b)
    scfg = tvector.VectorConfig(dimension=D)
    meta = tsegment.create_segment(str(tmp_path / "single"), [tvector.Elem(key="a/f/0/0-1", vectors=q[:1])], scfg)
    single = tvector.VectorSearcher(scfg, tvector.SimpleOpenIndex(segment_list=[(meta, tvector.Seq(1))]), device="cpu")
    with pytest.raises(ValueError, match="multivector query"):
        single.search(tvector.VectorSearchRequest(vectors=q[None]))
    with pytest.raises(ValueError, match="multivector query"):
        single.index.search(q[None], 5)


def test_from_reference_state_multi(tmp_path):
    rng = np.random.default_rng(6)
    cfg, oi, _ = _single_index(tmp_path, rng)
    js = jvector.VectorSearcher(jvector.VectorConfig.from_dict(cfg.to_dict()), oi)
    j = js.index
    arrays = dict(vectors=np.asarray(j.vectors), m_count=np.asarray(j.m_count), m_max=j.m_max,
                  alive=j.alive, para_seg=j.para_seg)
    idx = tdevice.DeviceVectorIndex.from_reference_state(
        cfg, j.keys, j.para_meta, j.labels, j.seg_tags, j.seg_bounds, arrays, device="cpu"
    )
    assert idx.multi and idx.m_max == j.m_max and not idx.host_resident()
    q = rng.standard_normal((2, 3, D)).astype(np.float32)
    pm = np.zeros(idx.n_para, bool)
    pm[::2] = True
    for kw in (dict(), dict(para_mask=pm), dict(with_duplicates=False, min_score=0.0)):
        assert_same_results(*j.search(q, 10, **kw), *idx.search(q, 10, **kw))


# --------------------------------------------------------------------------
# the node
# --------------------------------------------------------------------------


def _resource(rid, rng, n_para=3, vectorset="mv"):
    """A resource of ``n_para`` paragraphs, each with 1-4 sentence vectors
    (of DIM 16), labels on the resource, field and paragraph."""
    rd = ResourceDoc(resource_id=rid, labels=["/n/s/PROCESSED"], created=1000, modified=1000)
    text = " ".join(f"word{i}" for i in range(10 * n_para))
    rd.texts["t/text1"] = TextInformation(text=text, labels=["/t/field"])
    paras = {}
    for p in range(n_para):
        para = IndexParagraph(start=10 * p, end=10 * p + 9, labels=[f"/p/{p % 2}"])
        para.vectorsets_sentences[vectorset] = {
            f"{rid}/t/text1/{s}/{10 * p}-{10 * p + 9}": VectorSentence(vector=rng.standard_normal(D).astype(np.float32))
            for s in range(int(rng.integers(1, 5)))
        }
        paras[f"{rid}/t/text1/{10 * p}-{10 * p + 9}"] = para
    rd.paragraphs["t/text1"] = paras
    return rd


def test_resource_elems_match_jax():
    """One elem per paragraph keyed by it under MULTI (its sentence vectors
    stacked), one per sentence under SINGLE, as in the JAX package."""
    rng = np.random.default_rng(7)
    rd = _resource("r1", rng)
    n_sentences = sum(len(p.vectorsets_sentences["mv"]) for p in rd.paragraphs["t/text1"].values())
    for cardinality, n in (("multi", 3), ("single", n_sentences)):
        want = jvector.VectorIndexer(jvector.VectorConfig(dimension=D, cardinality=cardinality)).resource_elems(rd, "mv")
        got = tvector.VectorIndexer(tvector.VectorConfig(dimension=D, cardinality=cardinality), device="cpu").resource_elems(
            as_port(rd), "mv"
        )
        assert len(got) == n and [e.key for e in got] == [e.key for e in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.vectors, w.vectors)
            assert g.labels == w.labels and g.metadata == w.metadata


def _multi_node_run(node, conv, rng_seed):
    """Index 6 resources into a MULTI vectorset one by one, delete one,
    merge, sync; then hybrid requests, a single vector and a [M, D] vector
    (the per-shard path reads its first row: see ROADMAP Queue 3)."""
    rng = np.random.default_rng(rng_seed)
    cfg = jvector.VectorConfig(dimension=D, cardinality=VectorCardinality.MULTI)
    sid = node.create_shard("kb1", conv({"mv": cfg}), shard_id="s1")
    resources = [_resource(f"r{i}", rng) for i in range(6)]
    for rd in resources:
        node.index(sid, conv(rd))
    node.delete_resource(sid, "r2")
    stats = node.tick_background()
    node.wait_for_sync()
    q = rng.standard_normal((3, D)).astype(np.float32)
    reqs = [
        ShardSearchRequest(body="word3", vector=q[0], vectorset="mv", top_k=10),
        ShardSearchRequest(body="", vector=q[1], vectorset="mv", paragraph=False, top_k=20, min_score_semantic=-0.5),
        ShardSearchRequest(body="", vector=q[2], vectorset="mv", paragraph=False, top_k=5, with_duplicates=True),
        ShardSearchRequest(body="", vector=q, vectorset="mv", paragraph=False, top_k=10),
        ShardSearchRequest(body="", vector=q[0], vectorset="mv", paragraph=False, top_k=10),
    ]
    return stats, [node.search(sid, conv(r)) for r in reqs]


def test_multi_shard_through_embedded_node_matches_jax(tmp_path):
    ref = EmbeddedNode(data_dir=str(tmp_path / "jax"), storage=MemoryStorage())
    port = port_services.EmbeddedNode(data_dir=str(tmp_path / "port"), storage=PortMemoryStorage(), device="cpu")
    want_stats, want = _multi_node_run(ref, lambda x: x, 9)
    got_stats, got = _multi_node_run(port, as_port, 9)
    assert got_stats["merged"] == want_stats["merged"] > 0
    for g, w in zip(got, want):
        assert_same_response(g, w)
    assert got[0].vector and all(h.key.count("/") == 3 for h in got[0].vector)  # paragraph keys
    assert not any(h.key.startswith("r2/") for r in got for h in r.vector)
    # a [M, D] vector through the per-shard path: the first row's answer
    assert [h.key for h in got[3].vector] == [h.key for h in got[4].vector]
    assert [h.key for h in want[3].vector] == [h.key for h in want[4].vector]
