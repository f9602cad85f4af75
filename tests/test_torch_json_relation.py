"""The port's JSON and relation indexes against the JAX package's.

The fixtures of ``tests/test_json_index.py``, ``tests/test_relation_vectorized.py``
and ``tests/test_graph_vector_match.py``: each package's indexer writes the
same resources, each package's searcher opens its own segments and the
other's, and every answer (prefilters, evaluated expressions, graph paths,
node and relation projections, semantic matches) compares equal, floats
within 1e-5.
"""

import json
import random

import numpy as np
import pytest

from nucliadb_tpu.index.json import JsonIndexer, JsonPredicate, JsonSearcher
from nucliadb_tpu.index.relation import GraphSearchRequest, NodePattern, RelationIndexer, RelationPattern, RelationSearcher
from nucliadb_tpu.models.internal import ResourceDoc
from nucliadb_tpu.types import Seq, SimpleOpenIndex

import nucliadb_tpu_torch.index.json as port_json
import nucliadb_tpu_torch.index.relation as port_relation

from tests import test_graph_vector_match as gvm
from tests import test_json_index as tji
from tests import test_relation_vectorized as trv
from tests.torch_test_helpers import as_port, assert_plain_close, plain


def _json_open_index(indexer, tmp, payloads, deletions, conv):
    oi = conv(SimpleOpenIndex(deletion_list=list(deletions)))
    for i, payload in enumerate(payloads):
        res = conv(ResourceDoc(resource_id=f"r{i:04d}", json_fields={"f1": json.dumps(payload)}))
        oi.segment_list.append((indexer.index_resource(res, str(tmp / f"js{i}")), conv(Seq(i + 1))))
    return oi


def _json_searchers(tmp, payloads, deletions=()):
    """(JAX searcher, port over its own segments, port over the JAX ones)."""
    ref_oi = _json_open_index(JsonIndexer(), tmp / "jax", payloads, deletions, lambda x: x)
    port_oi = _json_open_index(port_json.JsonIndexer(), tmp / "port", payloads, deletions, as_port)
    return JsonSearcher(ref_oi), port_json.JsonSearcher(port_oi), port_json.JsonSearcher(as_port(ref_oi))


def _random_payloads(rng):
    """tests/test_json_index.py:102's payloads."""
    payloads = []
    for _ in range(60):
        p = {}
        if rng.random() < 0.8:
            p["num"] = rng.choice([1, 2.5, 7, 100, True, False])
        if rng.random() < 0.7:
            p["tag"] = rng.sample(["x", "y", "z", "1"], k=rng.randint(1, 3))
        if rng.random() < 0.3:
            p["opt"] = rng.choice([None, "set", 0])
        payloads.append(p or {"empty": 1})
    return payloads


def _random_json_expr(rng, depth=0):
    r = rng.random()
    if depth < 2 and r < 0.35:
        kind = rng.choice([tji.JsonAnd, tji.JsonOr])
        return kind([_random_json_expr(rng, depth + 1) for _ in range(rng.randint(1, 3))])
    if depth < 2 and r < 0.5:
        return tji.JsonNot(_random_json_expr(rng, depth + 1))
    return JsonPredicate(
        path=rng.choice(["num", "tag", "opt", "nope"]),
        op=rng.choice(["eq", "ne", "gt", "gte", "lt", "lte", "exists"]),
        value=rng.choice([1, 2.5, 7, "x", "set", None, True, 0]),
    )


@pytest.mark.parametrize("case", ["fixed_exprs", "random_fuzz", "deletions", "field_scoped"])
def test_json_prefilter_matches_jax(tmp_path, case):
    rng = random.Random(5)
    payloads = _random_payloads(rng) if case == "random_fuzz" else tji.PAYLOADS
    deletions = [("r0000/", Seq(100)), ("r0003/f1", Seq(100))] if case == "deletions" else ()
    ref, port, cross = _json_searchers(tmp_path, payloads, deletions)
    if case == "random_fuzz":
        exprs = [_random_json_expr(rng) for _ in range(200)]
    elif case == "field_scoped":
        exprs = [JsonPredicate(path="price", op="gt", value=5, field_id=f) for f in ("f1", "f2")]
    else:
        exprs = tji.EXPRS
    for expr in exprs:
        want = ref.prefilter(expr)
        for s in (port, cross):
            got = s.prefilter(as_port(expr))
            assert plain(got) == plain(want), expr
            assert tji._keys(s, got) == {  # the port's vectorized answer is its scalar oracle's
                s.docs[i]["key"].split("/", 1)[0] for i in range(s.n_docs) if s._matches(as_port(expr), i)
            }
    assert port.prefilter(None).is_all


def test_json_merge_matches_jax(tmp_path):
    ref_oi = _json_open_index(JsonIndexer(), tmp_path / "in", tji.PAYLOADS, [("r0001/", Seq(9))], lambda x: x)
    want = JsonIndexer().merge(ref_oi, str(tmp_path / "jax"))
    got = port_json.JsonIndexer().merge(as_port(ref_oi), str(tmp_path / "port"))
    assert got.records == want.records == len(tji.PAYLOADS) - 1
    for name in ("docs.msgpack", "meta.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


@pytest.fixture(scope="module")
def relation_searchers(tmp_path_factory):
    """tests/test_relation_vectorized.py's 400 random edges, opened by both."""
    import msgpack
    import os

    edges = trv.make_edges(random.Random(7), 400)
    seg_dir = str(tmp_path_factory.mktemp("relseg"))
    with open(os.path.join(seg_dir, "edges.msgpack"), "wb") as f:
        f.write(msgpack.packb(edges))
    meta = {"records": len(edges), "kind": "relation"}
    with open(os.path.join(seg_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    from nucliadb_tpu.types import SegmentMetadata

    oi = SimpleOpenIndex(segment_list=[(SegmentMetadata(path=seg_dir, records=len(edges), index_metadata=meta), 1)])
    return RelationSearcher(oi), port_relation.RelationSearcher(as_port(oi))


def _same_vec(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-6)


def _edge_ok(e):
    return hash(e["key"]) % 3 != 0


@pytest.mark.parametrize("what", ["eval_expr", "eval_node_expr", "graph_search", "graph_search_expr", "projections"])
def test_relation_searcher_matches_jax(relation_searchers, what):
    ref, port = relation_searchers
    rng = random.Random(101)
    for _ in range(60):
        if what == "eval_expr":
            q = trv.rand_expr(rng)
            _same_vec(port._eval_expr(q), ref._eval_expr(q))
        elif what == "eval_node_expr":
            q = trv.rand_node_expr(rng)
            for position in ("source", "destination"):
                _same_vec(port._eval_node_expr(q, position), ref._eval_node_expr(q, position))
        elif what == "graph_search":
            src, dst = trv.rand_node_leaf(rng), trv.rand_node_leaf(rng)
            req = GraphSearchRequest(
                source=NodePattern(
                    value=src.get("value"), ntype=src.get("type"), subtype=src.get("group"),
                    match=src.get("match", "exact"), prefix=bool(src.get("prefix", False)),
                    semantic_matches=src.get("semantic_matches"),
                ),
                relation=RelationPattern(relation=rng.choice(trv.RELATIONS + [None])),
                target=NodePattern(value=dst.get("value"), match=dst.get("match", "exact")),
                undirected=rng.random() < 0.5,
                top_k=17,
            )
            assert_plain_close(plain(port.graph_search(as_port(req))), plain(ref.graph_search(req)))
        elif what == "graph_search_expr":
            q = trv.rand_expr(rng)
            assert_plain_close(plain(port.graph_search_expr(q, top_k=25)), plain(ref.graph_search_expr(q, top_k=25)))
        else:
            nq, q = trv.rand_node_expr(rng), trv.rand_expr(rng)
            assert_plain_close(
                plain(port.nodes_search(nq, top_k=1000, edge_ok=_edge_ok)),
                plain(ref.nodes_search(nq, top_k=1000, edge_ok=_edge_ok)),
            )
            assert_plain_close(
                plain(port.relations_search(q, top_k=1000, edge_ok=_edge_ok)),
                plain(ref.relations_search(q, top_k=1000, edge_ok=_edge_ok)),
            )
    assert plain(port.neighbours(["Apple", "órange"], top_k=10)) == plain(ref.neighbours(["Apple", "órange"], top_k=10))
    assert plain(port.suggest_nodes("app")) == plain(ref.suggest_nodes("app"))


def _relation_pair(tmp, conv, indexer):
    docs = [
        gvm.make_doc("r1", {"Fox": gvm.vec(1, 0), "Bear": gvm.vec(0, 1)}, labels={"mentions": gvm.vec(1, 1)}),
        gvm.make_doc("r2", {"Órange Fox": gvm.vec(0.9, 0.1)}, labels={"praises": gvm.vec(-1, -1)}),
    ]
    return [indexer.index_resource(conv(d), str(tmp / f"s{i}")) for i, d in enumerate(docs)]


@pytest.mark.parametrize("written_by", ["jax", "port"])
@pytest.mark.parametrize("deleted", [False, True])
def test_graph_vector_match_matches_jax(tmp_path, written_by, deleted):
    """tests/test_graph_vector_match.py's segment pair, written by one
    package and opened by both, with and without a deletion of r1."""
    if written_by == "jax":
        segs = _relation_pair(tmp_path, lambda x: x, RelationIndexer())
    else:
        segs = [as_port_back(m) for m in _relation_pair(tmp_path, as_port, port_relation.RelationIndexer())]
    oi = SimpleOpenIndex(
        segment_list=[(m, i + 1) for i, m in enumerate(segs)],
        deletion_list=[("r1/", 3)] if deleted else [],
    )
    ref, port = RelationSearcher(oi), port_relation.RelationSearcher(as_port(oi))
    for fn, args in (
        ("semantic_node_matches", ("gm", gvm.vec(1, 0))),
        ("semantic_node_matches", ("gm", gvm.vec(0, 1))),
        ("semantic_edge_matches", ("ge", gvm.vec(1, 1))),
    ):
        for kwargs in ({"top_n": 10}, {"top_n": 10, "min_score": 0.5}):
            assert_plain_close(plain(getattr(port, fn)(*args, **kwargs)), plain(getattr(ref, fn)(*args, **kwargs)))
    query = {"prop": "path", "source": {}, "destination": {"type": "ENTITY", "vector": [0.0, 1.0] + [0.0] * 6}, "relation": {}}
    rel_query = {"prop": "relation", "vector": [1.0, 1.0] + [0.0] * 6}
    want = ref.resolve_vector_leaves(query, top_k=10, node_vectorset="gm")
    got = port.resolve_vector_leaves(query, top_k=10, node_vectorset="gm")
    assert_plain_close(plain(got), plain(want))
    assert_plain_close(plain(port.graph_search_expr(got, 10)), plain(ref.graph_search_expr(want, 10)))
    want = ref.resolve_vector_leaves(rel_query, top_k=5, edge_vectorset="ge")
    got = port.resolve_vector_leaves(rel_query, top_k=5, edge_vectorset="ge")
    assert_plain_close(plain(got), plain(want))
    assert_plain_close(plain(port.relations_search(got, 5)), plain(ref.relations_search(want, 5)))
    with pytest.raises(LookupError):
        port.semantic_node_matches("nope", gvm.vec(1, 0), top_n=10)


def as_port_back(meta):
    """A port ``SegmentMetadata`` as the JAX package's (the JAX searcher
    takes its own types)."""
    from nucliadb_tpu.types import SegmentMetadata

    return SegmentMetadata(path=meta.path, records=meta.records, tags=meta.tags, index_metadata=meta.index_metadata)


def test_relation_merge_matches_jax(tmp_path):
    segs = _relation_pair(tmp_path / "in", lambda x: x, RelationIndexer())
    oi = SimpleOpenIndex(segment_list=[(m, i + 1) for i, m in enumerate(segs)], deletion_list=[("r1/", 3)])
    want = RelationIndexer().merge(oi, str(tmp_path / "jax"))
    got = port_relation.RelationIndexer().merge(as_port(oi), str(tmp_path / "port"))
    assert got.records == want.records == 3
    for path in sorted(p.name for p in (tmp_path / "jax").iterdir()):
        assert (tmp_path / "port" / path).read_bytes() == (tmp_path / "jax" / path).read_bytes(), path
    # each package's merged segment answers the same in the other
    ref = RelationSearcher(SimpleOpenIndex(segment_list=[(as_port_back(got), 1)]))
    port = port_relation.RelationSearcher(as_port(SimpleOpenIndex(segment_list=[(want, 1)])))
    for s in (ref, port):
        assert list(s.semantic_node_matches("gm", gvm.vec(1, 0), top_n=10)) == ["orange fox"]
