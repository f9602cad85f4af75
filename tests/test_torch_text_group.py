"""The port's mesh text group (``parallel/text_group.py``) against its own
per-shard path and the JAX package's group, on the CPU.

``tests/test_text_group.py``'s three tests on both packages over the same
segment files: the JAX group on its 8-device virtual CPU mesh, the port's
on 8 members repeating the one CPU (the device listing
``parallel.mesh.visible_devices`` replaced in process). As in the JAX
tests, the port's ``MeshTextGroup.search`` + ``finish_kernel`` must give
the SAME responses as its sequential ``ParagraphSearcher.search`` (hits,
scores to 4 places, ematches, totals); against the JAX group's responses
the hits agree up to ties with scores within ``torch_test_helpers.RTOL``
(1e-5) and the totals and ematches exactly.
"""

import numpy as np
import pytest
import torch

from nucliadb_tpu.index.paragraph import ParagraphSearchRequest
from nucliadb_tpu.parallel.text_group import MeshTextGroup as JMeshTextGroup
from nucliadb_tpu.parallel.text_group import layout_sig as jlayout_sig
from nucliadb_tpu.query_language import LabelAtom
from nucliadb_tpu.types import FieldId, PrefilterResult
from nucliadb_tpu_torch.index.paragraph import ParagraphSearcher
from nucliadb_tpu_torch.parallel import mesh as pmesh
from nucliadb_tpu_torch.parallel.text_group import MeshTextGroup, layout_sig

from tests.test_text_group import _build_shard, _random_request, _resp_key
from torch_test_helpers import as_port, assert_same_ranked, plain


@pytest.fixture(autouse=True)
def _kernel_only_on_an_8_member_mesh(monkeypatch):
    """The device route on both sides (as tests/test_text_group.py), and 8
    mesh members for the port."""
    monkeypatch.setenv("NDBTPU_TEXT_HOST_TIER", "0")
    monkeypatch.setattr(pmesh, "visible_devices", lambda device="cuda": [torch.device("cpu")] * 8)


def _port_searcher(open_index):
    return ParagraphSearcher(as_port(open_index), device="cpu")


def _shards(tmp_path, rng, names_sizes_dels):
    """JAX searchers built as tests/test_text_group.py builds them, and the
    port's searchers over the same segment files."""
    import nucliadb_tpu.index.paragraph as jpara

    jsearchers = []

    captured = []
    real = jpara.ParagraphSearcher.__init__

    def capture(self, open_index, *a, **kw):
        captured.append(open_index)
        real(self, open_index, *a, **kw)

    jpara.ParagraphSearcher.__init__ = capture
    try:
        for name, n, dels in names_sizes_dels:
            jsearchers.append(_build_shard(tmp_path, rng, name, n, dels))
    finally:
        jpara.ParagraphSearcher.__init__ = real
    return jsearchers, [_port_searcher(oi) for oi in captured]


def _same_as_reference(got, want):
    """A port response against the JAX package's: hits up to ties, scores
    within RTOL, totals and ematches equal."""
    g, w = plain(got)[1], plain(want)[1]
    assert_same_ranked([h[1] for h in g["hits"]], [h[1] for h in w["hits"]], lambda h: h["paragraph_id"])
    assert g["total"] == w["total"] and sorted(g["ematches"]) == sorted(w["ematches"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_text_group_matches_sequential(tmp_path, seed):
    rng = np.random.default_rng(seed)
    jsearchers, searchers = _shards(
        tmp_path, rng,
        [(f"sh{i}", int(rng.integers(2, 7)), i % 2 == 0) for i in range(4)],
    )
    assert MeshTextGroup.eligible(searchers)
    group = MeshTextGroup(searchers)
    jgroup = JMeshTextGroup(jsearchers)
    assert group.mesh.shape == {"shard": 8} and group.s_pad == jgroup.s_pad == 8
    assert group.n_pad == jgroup.n_pad and group.tier_counts == jgroup.tier_counts
    assert [layout_sig(p.engine) for p in searchers] == [jlayout_sig(p.engine) for p in jsearchers]

    for trial in range(12):
        req, per_shard_prefilter = _random_request(rng, jsearchers)
        preqs = []
        for i in range(len(searchers)):
            pr = ParagraphSearchRequest(**{**req.__dict__})
            if per_shard_prefilter:
                pr.field_filter = PrefilterResult.some([FieldId(f"sh{i}-r0", "t/t1")])
            preqs.append(pr)
        tpreqs = [as_port(pr) for pr in preqs]
        expected = [p.search(pr) for p, pr in zip(searchers, tpreqs)]
        queries = [p.plan_kernel_query(pr) for p, pr in zip(searchers, tpreqs)]
        assert all(q is not None for q in queries), trial
        top_s, top_ic, counts = group.search(queries, req.top_k)
        jqueries = [p.plan_kernel_query(pr) for p, pr in zip(jsearchers, preqs)]
        js, jic, jcounts = jgroup.search(jqueries, req.top_k)
        np.testing.assert_array_equal(counts, np.asarray(jcounts))
        for i, (p, pr, q) in enumerate(zip(searchers, tpreqs, queries)):
            got = p.finish_kernel(pr, q, top_s[i], top_ic[i], int(counts[i]))
            assert _resp_key(got) == _resp_key(expected[i]), (trial, i)
            want = jsearchers[i].finish_kernel(preqs[i], jqueries[i], js[i], jic[i], int(jcounts[i]))
            _same_as_reference(got, want)


def test_text_group_fallback_regimes(tmp_path):
    """Phrases and deep-pagination cursors are not mesh-plannable: the
    planner returns None (as the JAX package's) and the caller falls back
    per shard."""
    from nucliadb_tpu_torch.index.paragraph import ParagraphSearchRequest as TReq, SearchAfter

    rng = np.random.default_rng(9)
    jsearchers, (p,) = _shards(tmp_path, rng, [("fb", 3, False)])
    assert p.plan_kernel_query(TReq(query='"alpha bravo"', top_k=5)) is None
    assert p.plan_kernel_query(TReq(query="alpha", top_k=5, search_after=SearchAfter(score=1.0))) is None
    assert p.plan_kernel_query(TReq(query="", top_k=5)) is None
    q = p.plan_kernel_query(TReq(query="alpha bravo", top_k=5))
    jq = jsearchers[0].plan_kernel_query(ParagraphSearchRequest(query="alpha bravo", top_k=5))
    assert q is not None and (q.text, q.top_k, q.excluded) == (jq.text, jq.top_k, jq.excluded)


def test_text_group_scale_many_shards(tmp_path):
    """8 shards, a few hundred paragraphs each: group == sequential with
    deletions, label filters, fuzzy and all_terms."""
    rng = np.random.default_rng(42)
    jsearchers, searchers = _shards(
        tmp_path, rng, [(f"big{i}", 40 + 10 * i, i < 4) for i in range(8)],
    )
    assert MeshTextGroup.eligible(searchers)
    group = MeshTextGroup(searchers)
    jgroup = JMeshTextGroup(jsearchers)
    for body, all_terms, fuzzy in [
        ("alpha bravo charlie", False, True),
        ("delta echo", True, False),
        ("foxtrot -alpha", False, True),
    ]:
        req = ParagraphSearchRequest(
            query=body, top_k=20, all_terms=all_terms, fuzzy=fuzzy,
            filter=LabelAtom("/l/ls/even"),
        )
        treq = as_port(req)
        expected = [p.search(treq) for p in searchers]
        queries = [p.plan_kernel_query(treq) for p in searchers]
        top_s, top_ic, counts = group.search(queries, req.top_k)
        jqueries = [p.plan_kernel_query(req) for p in jsearchers]
        js, jic, jcounts = jgroup.search(jqueries, req.top_k)
        for i, (p, q) in enumerate(zip(searchers, queries)):
            got = p.finish_kernel(treq, q, top_s[i], top_ic[i], int(counts[i]))
            assert _resp_key(got) == _resp_key(expected[i]), (body, i)
            want = jsearchers[i].finish_kernel(req, jqueries[i], js[i], jic[i], int(jcounts[i]))
            _same_as_reference(got, want)
