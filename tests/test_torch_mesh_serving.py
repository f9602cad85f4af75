"""The port's mesh serving path (``parallel/group.py`` and the mesh branch
of ``SyncedSearcher.search_multi``) against its own per-shard path and the
JAX package's mesh path, on the CPU.

``tests/test_mesh_serving.py``'s nine tests on both packages. The JAX
package runs on its 8-device virtual CPU mesh (``tests/conftest.py``); the
port's mesh has 8 members that repeat the one CPU, reached as on the card
by replacing the device listing ``parallel.mesh.visible_devices`` in
process. Two layers:

1. group level: ``MeshVectorGroup.search`` against S sequential
   ``DeviceVectorIndex.search`` calls of the port (ids equal, scores within
   1e-5 as the JAX test holds them: the sequential side of a small shard is
   the host numpy tier) and against the JAX package's group (ids up to
   ties, scores within ``torch_test_helpers.RTOL``, 1e-5);
2. product level: ``SearchService.find`` over a multi-shard knowledge box
   with ``NDBTPU_MESH_SERVING`` on and off gives the same responses, the
   semantic result sets equal an independent oracle's, and every answer
   equals the JAX package's mesh path's on the same corpus (the uuids of
   both packages aligned, ``test_torch_product_find.run_both``).
"""

import time

import numpy as np
import pytest
import torch

import nucliadb_tpu.index.vector as jvector
import nucliadb_tpu.models.api as api
import nucliadb_tpu_torch.index.vector.device as tdev
from nucliadb_tpu.index.vector import VectorSearchRequest
from nucliadb_tpu.parallel.group import MeshVectorGroup as JMeshVectorGroup
from nucliadb_tpu.parallel.group import mesh_serving_active as jmesh_serving_active
from nucliadb_tpu.query_language import LabelAtom
from nucliadb_tpu_torch.index.vector import VectorSearcher
from nucliadb_tpu_torch.ops import quant, slot_scan
from nucliadb_tpu_torch.parallel import mesh as pmesh
from nucliadb_tpu_torch.parallel.group import MeshVectorGroup, mesh_serving_active

from tests import test_mesh_serving as ref
from tests.test_torch_product_find import _pkg, run_both  # noqa: F401  (run_both: a fixture)
from torch_test_helpers import as_port, assert_same_results

MEMBERS = 8


@pytest.fixture(autouse=True)
def _eight_member_mesh(monkeypatch):
    monkeypatch.setattr(pmesh, "visible_devices", lambda device="cuda": [torch.device("cpu")] * MEMBERS)


def _capture_open_indexes(monkeypatch):
    """Records the (config, open index) of every JAX VectorSearcher built,
    so the port opens the same segment files."""
    seen = []
    real = jvector.VectorSearcher.__init__

    def capture(self, config, open_index, *a, **kw):
        seen.append((config, open_index))
        real(self, config, open_index, *a, **kw)

    monkeypatch.setattr(jvector.VectorSearcher, "__init__", capture)
    return seen


def _shards(tmp_path, monkeypatch, build, specs):
    """(JAX searchers, port searchers on the CPU) over the same segments:
    ``build(tmp_path, *spec)`` is one of tests/test_mesh_serving.py's
    shard builders."""
    seen = _capture_open_indexes(monkeypatch)
    jsearchers = [build(tmp_path, *spec) for spec in specs]
    return jsearchers, [VectorSearcher(as_port(c), as_port(oi), device="cpu") for c, oi in seen]


def _request_masks(searchers, jsearchers, q, **kw):
    """Each shard's combined mask (the port's) and its filter mask, from
    the same request in both packages (equal masks checked)."""
    masks, filt = [], []
    for vs, js in zip(searchers, jsearchers):
        m = vs._build_mask(as_port(VectorSearchRequest(vectors=q, **kw)))
        jm = js._build_mask(VectorSearchRequest(vectors=q, **kw))
        assert (m is None) == (jm is None)
        combined = vs.index.base_mask()
        if m is not None:
            np.testing.assert_array_equal(m, jm)
            full = np.zeros(vs.index.p_pad, bool)
            full[: m.shape[0]] = m
            combined &= full
        masks.append(combined)
        filt.append(m)
    return masks, filt


def _check_group(group, jgroup, searchers, q, k, masks, filt, min_score, dedup):
    gs, gi = group.search(q, k, masks, min_score=min_score, with_duplicates=not dedup)
    js, ji = jgroup.search(q, k, masks, min_score=min_score, with_duplicates=not dedup)
    assert gs.shape == gi.shape == (len(searchers),) + np.asarray(q).shape[:1] + (k,)
    for si, vs in enumerate(searchers):
        es, ei = vs.index.search(q, k, para_mask=filt[si], min_score=min_score, with_duplicates=not dedup)
        np.testing.assert_array_equal(gi[si], ei, err_msg=f"shard {si} ids")
        np.testing.assert_allclose(gs[si], es, rtol=1e-5, atol=1e-5, err_msg=f"shard {si} scores")
        assert_same_results(js[si], ji[si], gs[si], gi[si])


@pytest.mark.parametrize("seed", [0, 1])
def test_group_matches_sequential_exact(tmp_path, monkeypatch, seed):
    """Uneven shards, deletions, random masks, min_score and dedup: the
    group's per-shard cuts equal the sequential per-shard cuts and the JAX
    package's group."""
    rng = np.random.default_rng(seed)
    d = 32
    sizes = [int(rng.integers(5, 120)) for _ in range(5)]
    jsearchers, searchers = _shards(
        tmp_path, monkeypatch, ref._build_shard,
        [(rng, f"sh{i}", n, d, i % 2 == 0) for i, n in enumerate(sizes)],
    )
    assert MeshVectorGroup.eligible(searchers)
    group = MeshVectorGroup(searchers)
    jgroup = JMeshVectorGroup(jsearchers)
    assert group.mesh.shape == {"shard": MEMBERS} and group.s_pad == jgroup.s_pad
    # each member reads its shard's own arena; the JAX package stacks copies
    # padded to its group-wide per
    assert all(v is vs.index.vectors for v, vs in zip(group.vectors, searchers))
    assert group.device_bytes == 0 and jgroup.per == max(vs.index.p_pad for vs in searchers)
    assert not group.use_codes and not jgroup.use_codes

    for trial in range(6):
        k = int(rng.integers(1, 20))
        b = int(rng.integers(1, 5))
        q = rng.standard_normal((b, d)).astype(np.float32)
        min_score = float(rng.standard_normal()) if rng.random() < 0.4 else None
        dedup = bool(rng.random() < 0.5)
        use_label = rng.random() < 0.5
        masks, filt = _request_masks(
            searchers, jsearchers, q, top_k=k, filter=LabelAtom("/l/ls/even") if use_label else None,
            min_score=min_score, with_duplicates=not dedup,
        )
        _check_group(group, jgroup, searchers, q, k, masks, filt, min_score, dedup)


def test_group_scale_uneven_shards(tmp_path, monkeypatch):
    """~50k vectors over 8 uneven shards: group cuts == sequential cuts,
    with deletions and a selective label filter."""
    rng = np.random.default_rng(7)
    d = 64
    sizes = [12000, 9000, 7500, 6000, 5000, 4500, 3500, 2500]
    jsearchers, searchers = _shards(
        tmp_path, monkeypatch, ref._build_shard,
        [(rng, f"big{i}", n, d, i < 4) for i, n in enumerate(sizes)],
    )
    group = MeshVectorGroup(searchers)
    jgroup = JMeshVectorGroup(jsearchers)
    # the JAX package holds 8 x 12288 x d f32 rows of stacked copies; the
    # port's members on the (repeated) CPU device hold no copy
    assert jgroup.per == max(vs.index.p_pad for vs in searchers) == 12288
    assert group.device_bytes == 0
    q = rng.standard_normal((3, d)).astype(np.float32)
    masks, filt = _request_masks(searchers, jsearchers, q, top_k=10, filter=LabelAtom("/l/ls/even"))
    _check_group(group, jgroup, searchers, q, 10, masks, filt, None, True)


# ---------------------------------------------------------------------------
# Product level: mesh on against off, both packages, an evolving knowledge box
# ---------------------------------------------------------------------------


def _mesh_fuzz(pkg, tmp, seed, monkeypatch):
    """tests/test_mesh_serving.py's fuzz on ``pkg``: random CRUD over a
    multi-shard knowledge box; every fourth step one hybrid query through
    BOTH serving paths (equal answers), and a semantic query held to the
    oracle's filtered set. Returns every answer for the comparison of the
    two packages."""
    import importlib

    kbmod = importlib.import_module(f"{pkg.name}.common.kb")
    monkeypatch.setattr(kbmod, "MAX_RESOURCES_PER_SHARD", 6)
    rng = np.random.default_rng(seed)
    driver = pkg.Driver(str(tmp / "db.sqlite"))
    node = pkg.node(tmp / "node")
    kbs = pkg.KnowledgeBoxManager(driver, node)
    kbid = kbs.create(pkg.conv(api.KnowledgeBoxConfig(
        slug="fuzz", hidden_resources_enabled=True, vectorsets={"m": api.VectorSetSpec(dimension=8)},
    )))
    processor = pkg.Processor(driver, node, kbs)
    search = pkg.SearchService(node, kbs, processor)
    oracle, live, answers = ref.Oracle(), [], []

    def random_payload(cls):
        body = " ".join(rng.choice(ref.VOCAB, size=rng.integers(2, 6)))
        labels = [ref.LABELSETS[i] for i in rng.choice(len(ref.LABELSETS), size=rng.integers(0, 3), replace=False)]
        groups = list(rng.choice(ref.GROUPS, size=rng.integers(0, 3), replace=False))
        hidden = bool(rng.random() < 0.2)
        vec = rng.standard_normal(8).astype(np.float32)
        vec /= np.linalg.norm(vec)
        p = cls(
            title="t", texts={"t": api.TextFieldPayload(body=body)},
            usermetadata=api.UserMetadata(classifications=[api.Classification(labelset=s, label=l) for s, l in labels]),
            security=api.ResourceSecurity(access_groups=groups) if groups else None, hidden=hidden,
            embeddings={"m": {"t": [api.SentenceEmbedding(start=0, end=len(body), vector=vec.tolist())]}},
        )
        return pkg.conv(p), body, [f"/l/{s}/{l}" for s, l in labels], groups, hidden

    mesh_used = 0
    for step in range(36):
        op = rng.random()
        if op < 0.6 or not live:
            p, body, labels, groups, hidden = random_payload(api.CreateResourcePayload)
            rid, _ = processor.create_resource(kbid, p)
            live.append(rid)
            oracle.put(rid, body, labels, groups, hidden)
        elif op < 0.8:
            rid = live[int(rng.integers(len(live)))]
            p, body, labels, groups, hidden = random_payload(api.UpdateResourcePayload)
            processor.update_resource(kbid, rid, p)
            oracle.put(rid, body, labels, groups, hidden)
        else:
            rid = live.pop(int(rng.integers(len(live))))
            processor.delete_resource(kbid, rid)
            oracle.delete(rid)
        if rng.random() < 0.25:
            node.tick_background()
        if step % 4 != 3:
            continue
        node.wait_for_sync()
        label = ref.LABELSETS[int(rng.integers(len(ref.LABELSETS)))] if rng.random() < 0.4 else None
        security = list(rng.choice(ref.GROUPS, size=1)) if rng.random() < 0.4 else None
        show_hidden = bool(rng.random() < 0.3)
        qv = rng.standard_normal(8).astype(np.float32)
        qv /= np.linalg.norm(qv)
        filt = api.FilterExpression(literal=f"/l/{label[0]}/{label[1]}") if label else None
        req = pkg.conv(api.FindRequest(
            query=" ".join(rng.choice(ref.VOCAB, size=2, replace=False)), vector=qv.tolist(),
            features=[api.SearchFeature.KEYWORD, api.SearchFeature.SEMANTIC], top_k=100,
            filter_expression=filt, security_groups=security, show_hidden=show_hidden,
        ))
        monkeypatch.setenv("NDBTPU_MESH_SERVING", "0")
        r_seq = search.find(kbid, req)
        monkeypatch.setenv("NDBTPU_MESH_SERVING", "1")
        r_mesh = search.find(kbid, req)
        assert set(r_seq.resources) == set(r_mesh.resources), (pkg.name, step)
        assert r_seq.best_matches == r_mesh.best_matches, (pkg.name, step)
        if len(kbs.get_shards(kbid).shards) > 1:
            mesh_used += 1
        sem = search.find(kbid, pkg.conv(api.FindRequest(
            query="", vector=qv.tolist(), features=[api.SearchFeature.SEMANTIC], top_k=200,
            filter_expression=filt, security_groups=security, show_hidden=show_hidden,
        )))
        assert set(sem.resources) == oracle.filtered(label, security, show_hidden), (pkg.name, step)
        answers += [r_mesh, sem]
    assert mesh_used > 0 and len(kbs.get_shards(kbid).shards) > 1
    assert len(node.searcher._mesh_groups) >= 1, (pkg.name, "mesh path never taken")
    return answers


@pytest.mark.parametrize("seed", [0, 1])
def test_find_mesh_vs_sequential_fuzz(run_both, monkeypatch, seed):
    """Both packages' mesh paths on: each package's mesh answers equal its
    per-shard answers and the oracle, and the port's equal the JAX
    package's (``run_both``)."""
    assert jmesh_serving_active() and mesh_serving_active("cpu")
    jax_answers, port_answers = run_both(lambda pkg, tmp: _mesh_fuzz(pkg, tmp, seed, monkeypatch))
    assert len(port_answers) == len(jax_answers) == 18


@pytest.mark.parametrize("route", ["slot_scan", "topc"])
def test_group_selector_matches_sequential_per_route(tmp_path, monkeypatch, route):
    """The group selects int8 candidates through the SAME
    ``_int8_candidates`` as ``DeviceVectorIndex._search_int8``: at D = 128
    both call the top-2 slot scan (the CUDA kernel on the card, its plain
    version here) once a search, at D = 64 neither does (an exact top-c of
    the int8 estimates). The JAX test traces both programs per backend and
    looks for the Pallas call; the port counts the calls."""
    import nucliadb_tpu.index.vector.device as jdev

    monkeypatch.setattr(jdev, "EXACT_SCAN_THRESHOLD", 256)
    monkeypatch.setattr(tdev, "EXACT_SCAN_THRESHOLD", 256)
    rng = np.random.default_rng(11)
    d = 128 if route == "slot_scan" else 64
    jsearchers, searchers = _shards(
        tmp_path, monkeypatch, ref._build_shard, [(rng, f"sel{i}", n, d, False) for i, n in enumerate([5000, 1200])],
    )
    assert all(isinstance(vs.index.codes, quant.Int8Codes) for vs in searchers)
    group = MeshVectorGroup(searchers)
    jgroup = JMeshVectorGroup(jsearchers)
    assert group.use_codes and jgroup.use_codes and jgroup.per == 6144

    calls = []
    real = slot_scan.int8_scan_slots_resident2
    monkeypatch.setattr(slot_scan, "int8_scan_slots_resident2", lambda *a, **kw: calls.append(a[1].shape) or real(*a, **kw))
    q = rng.standard_normal((8, d)).astype(np.float32)
    masks = [vs.index.base_mask() for vs in searchers]
    seq = [vs.index.search(q, 10) for vs in searchers]
    n_seq = len(calls)
    gs, gi = group.search(q, 10, masks)
    n_group = len(calls) - n_seq
    want = 2 if route == "slot_scan" else 0
    assert n_seq == n_group == want, (route, n_seq, n_group)
    if route == "slot_scan":
        # each member's table over its own arena, as the sequential call's
        assert calls == [(6144, d), (4096, d), (6144, d), (4096, d)]
    for si, (es, ei) in enumerate(seq):
        np.testing.assert_array_equal(gi[si], ei)
        np.testing.assert_array_equal(gs[si], es)


def test_group_quantized_regime(tmp_path, monkeypatch):
    """Shards above EXACT_SCAN_THRESHOLD run the int8 candidate path and
    the group mirrors it: both reach recall@k >= 0.95 against the exact
    oracle (the JAX test's bar), and the port's group equals its
    sequential path exactly (its candidate selection is an exact top-c on
    every shape, where the JAX package's approx_max_k bins depend on the
    padded arena)."""
    import nucliadb_tpu.index.vector.device as jdev

    monkeypatch.setattr(jdev, "EXACT_SCAN_THRESHOLD", 256)
    monkeypatch.setattr(tdev, "EXACT_SCAN_THRESHOLD", 256)
    rng = np.random.default_rng(3)
    d = 64
    jsearchers, searchers = _shards(
        tmp_path, monkeypatch, ref._build_shard,
        [(rng, f"q{i}", n, d, i == 0) for i, n in enumerate([2000, 900, 1500])],
    )
    assert all(vs.index.codes is not None for vs in searchers)
    group = MeshVectorGroup(searchers)
    assert group.use_codes
    q = rng.standard_normal((2, d)).astype(np.float32)
    k = 10
    masks = [vs.index.base_mask() for vs in searchers]
    gs, gi = group.search(q, k, masks, with_duplicates=True)
    jgs, jgi = JMeshVectorGroup(jsearchers).search(q, k, masks, with_duplicates=True)
    for si, vs in enumerate(searchers):
        es, ei = vs.index.search(q, k, with_duplicates=True)
        np.testing.assert_array_equal(gi[si], ei)
        np.testing.assert_array_equal(gs[si], es)
        vecs = vs.index.vectors.numpy()[: vs.index.n_para]
        scores = q @ vecs.T
        scores[:, ~vs.index.alive] = -np.inf
        oracle = np.argsort(-scores, axis=1)[:, :k]
        for b in range(q.shape[0]):
            want = set(oracle[b].tolist())
            for ids in (set(gi[si, b].tolist()), set(jgi[si, b].tolist())):
                ids.discard(-1)
                assert len(ids & want) >= int(0.95 * k), (si, b)


def _multi_shard_kb(tmp_path, monkeypatch, n_res=17, d=8):
    """tests/test_mesh_serving.py's knowledge box forced onto several
    shards, on the port."""
    import nucliadb_tpu_torch.common.kb as tkb

    pkg = _pkg("nucliadb_tpu_torch")
    monkeypatch.setattr(tkb, "MAX_RESOURCES_PER_SHARD", 6)
    rng = np.random.default_rng(7)
    driver = pkg.Driver(str(tmp_path / "db.sqlite"))
    node = pkg.node(tmp_path / "node")
    kbs = pkg.KnowledgeBoxManager(driver, node)
    kbid = kbs.create(pkg.conv(api.KnowledgeBoxConfig(slug="msk", vectorsets={"m": api.VectorSetSpec(dimension=d)})))
    processor = pkg.Processor(driver, node, kbs)
    search = pkg.SearchService(node, kbs, processor)
    for i in range(n_res):
        v = rng.standard_normal(d).astype(np.float32)
        v /= np.linalg.norm(v)
        body = f"{ref.VOCAB[i % len(ref.VOCAB)]} {ref.VOCAB[(i + 1) % len(ref.VOCAB)]} doc{i}"
        processor.create_resource(kbid, pkg.conv(api.CreateResourcePayload(
            title=f"r{i}", texts={"t": api.TextFieldPayload(body=body)},
            embeddings={"m": {"t": [api.SentenceEmbedding(start=0, end=len(body), vector=v.tolist())]}},
        )))
    node.wait_for_sync()
    assert len(kbs.get_shards(kbid).shards) > 1
    return pkg, node, kbs, search, kbid, rng


@pytest.mark.parametrize("host_tier", ["0", "1"])
def test_mesh_find_dispatch_count(tmp_path, monkeypatch, host_tier):
    """A hybrid /find over N co-resident shards runs at most 2 mesh
    programs, not 2 a shard. With the host tier off: one vector group and
    one text group call, no per-shard leg. With it on (the default at this
    size): one vector group call, the keyword legs per shard on the host
    inside the fan-out, no text group. Either way the answer is the
    per-shard path's."""
    from nucliadb_tpu_torch.index.paragraph import ParagraphSearcher
    from nucliadb_tpu_torch.parallel.text_group import MeshTextGroup

    monkeypatch.setenv("NDBTPU_TEXT_HOST_TIER", host_tier)
    pkg, node, kbs, search, kbid, rng = _multi_shard_kb(tmp_path, monkeypatch)
    qv = rng.standard_normal(8).astype(np.float32)
    qv /= np.linalg.norm(qv)
    req = pkg.conv(api.FindRequest(
        query=f"{ref.VOCAB[0]} {ref.VOCAB[1]}", vector=qv.tolist(),
        features=[api.SearchFeature.KEYWORD, api.SearchFeature.SEMANTIC], top_k=20,
    ))
    monkeypatch.setenv("NDBTPU_MESH_SERVING", "0")
    per_shard = search.find(kbid, req)
    monkeypatch.setenv("NDBTPU_MESH_SERVING", "1")
    warm = search.find(kbid, req)  # group construction is not under test
    assert warm.best_matches and warm.best_matches == per_shard.best_matches

    counts = {"vgroup": 0, "tgroup": 0, "vseq": 0, "pseq": 0}

    def wrap(cls, key):
        orig = cls.search

        def counted(self, *a, **kw):
            counts[key] += 1
            return orig(self, *a, **kw)

        monkeypatch.setattr(cls, "search", counted)

    wrap(MeshVectorGroup, "vgroup")
    wrap(MeshTextGroup, "tgroup")
    wrap(VectorSearcher, "vseq")
    wrap(ParagraphSearcher, "pseq")
    resp = search.find(kbid, req)
    assert resp.best_matches == warm.best_matches
    n_shards = len(kbs.get_shards(kbid).shards)
    if host_tier == "0":
        assert counts == {"vgroup": 1, "tgroup": 1, "vseq": 0, "pseq": 0}, counts
    else:
        assert counts == {"vgroup": 1, "tgroup": 0, "vseq": 0, "pseq": n_shards}, counts


def test_search_many_concurrent_overlap(tmp_path, monkeypatch):
    """The mesh-ineligible multi-shard fallback fans shards out
    concurrently: a keyword-only request (vector=None) always takes
    ``_search_many``; with 0.5 s injected a shard, a /find over 3 or more
    shards finishes well under the 1.5 s a sequential loop would need."""
    from nucliadb_tpu_torch.services.searcher import SyncedSearcher

    pkg, node, kbs, search, kbid, rng = _multi_shard_kb(tmp_path, monkeypatch)
    req = pkg.conv(api.FindRequest(query=ref.VOCAB[0], features=[api.SearchFeature.KEYWORD], top_k=20))
    warm = search.find(kbid, req)
    assert len(kbs.get_shards(kbid).shards) >= 3

    delay = 0.5
    orig = SyncedSearcher.search

    def slow(self, shard_id, request):
        time.sleep(delay)
        return orig(self, shard_id, request)

    monkeypatch.setattr(SyncedSearcher, "search", slow)
    t0 = time.perf_counter()
    resp = search.find(kbid, req)
    wall = time.perf_counter() - t0
    assert resp.best_matches == warm.best_matches
    assert delay <= wall < 2 * delay, wall


@pytest.mark.parametrize("seed", [0, 1])
def test_multivector_group_matches_sequential(tmp_path, monkeypatch, seed):
    """MaxSim groups: per-shard cuts equal S sequential searches across
    uneven shards with DIFFERENT per-shard m_max (the group re-pads slot
    blocks), deletions, masks, min_score, dedup, and both [B, D] and [B,
    M, D] queries; and the JAX package's group."""
    rng = np.random.default_rng(100 + seed)
    d = 16
    specs = [
        (rng, f"mv{i}", int(rng.integers(6, 60)), d, int(rng.integers(1, 5)), i % 2 == 0) for i in range(4)
    ]
    jsearchers, searchers = _shards(tmp_path, monkeypatch, ref._build_multi_shard, specs)
    assert MeshVectorGroup.eligible(searchers)
    group = MeshVectorGroup(searchers)
    jgroup = JMeshVectorGroup(jsearchers)
    assert group.multi and jgroup.m_max == max(vs.index.m_max for vs in searchers)
    assert all(mc is vs.index.m_count for mc, vs in zip(group.m_counts, searchers))

    for trial in range(6):
        k = int(rng.integers(1, 12))
        b = int(rng.integers(1, 4))
        if trial % 2:
            q = rng.standard_normal((b, int(rng.integers(1, 4)), d)).astype(np.float32)
        else:
            q = rng.standard_normal((b, d)).astype(np.float32)
        min_score = float(rng.standard_normal()) if rng.random() < 0.3 else None
        dedup = bool(rng.random() < 0.5)
        masks, filt = [], []
        for vs in searchers:
            mask = rng.random(vs.index.n_para) < 0.6 if rng.random() < 0.4 else None
            combined = vs.index.base_mask()
            if mask is not None:
                full = np.zeros(vs.index.p_pad, bool)
                full[: mask.shape[0]] = mask
                combined &= full
            masks.append(combined)
            filt.append(mask)
        _check_group(group, jgroup, searchers, q, k, masks, filt, min_score, dedup)


def test_mixed_cardinality_group_ineligible(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    jsearchers, (single, multi) = _shards(
        tmp_path, monkeypatch, lambda tp, *a: (ref._build_shard if a[-1] == "s" else ref._build_multi_shard)(tp, *a[:-1]),
        [(rng, "sg", 20, 16, False, "s"), (rng, "mx", 20, 16, 3, False, "m")],
    )
    assert not MeshVectorGroup.eligible([single, multi])
    assert not JMeshVectorGroup.eligible(jsearchers)
    assert MeshVectorGroup.eligible([single]) and MeshVectorGroup.eligible([multi])
