"""The scenarios of ``tests/test_text_mesh.py`` on the port: the port's ``MeshShardedTextEngine`` on a mesh of the CPU.

The reference file's own docstring:

Mesh-sharded BM25 on the virtual 8-device CPU mesh."""

import numpy as np

from nucliadb_tpu_torch.index.text_engine import (
    DeviceTextEngine,
    TextQuery,
    build_segment,
    open_text_segment,
)
from nucliadb_tpu_torch.index.text_engine.builder import DocEntry
from nucliadb_tpu_torch.parallel import make_mesh
from nucliadb_tpu_torch.parallel.text_mesh import MeshShardedTextEngine
from nucliadb_tpu_torch.types import Seq

WORDS = ["fox", "dog", "cat", "yak", "owl", "bee", "elk", "hen", "ant", "ram"]


def _engine(tmp_path, docs, tag):
    entries = [DocEntry(key=k, text=t, facets=[]) for k, t in docs]
    meta = build_segment(str(tmp_path / f"seg_{tag}"), entries, kind="text")
    return DeviceTextEngine([(open_text_segment(meta.path), Seq(1))], device="cpu")


def test_mesh_bm25_matches_per_shard_merge(rng, tmp_path):
    n_shards = 4
    docs = []
    for i in range(48):
        words = [WORDS[j] for j in rng.integers(0, len(WORDS), 8)]
        docs.append((f"r{i:03d}/f", " ".join(words)))
    shards = [docs[i::n_shards] for i in range(n_shards)]
    engines = [_engine(tmp_path, sh, i) for i, sh in enumerate(shards)]

    mesh = make_mesh(8, query_axis=2, device="cpu")  # 4 shard rows x 2 query columns
    sharded = MeshShardedTextEngine(engines, mesh)
    assert sharded.n_docs == 48

    query = TextQuery(text="fox dog", top_k=10)
    ms, mi = sharded.search(query)

    # oracle: per-shard search + host merge (the reference's scatter-gather
    # semantics — BM25 stats are shard-local on both sides)
    merged = []
    for si, e in enumerate(engines):
        hits, _ = e.search(TextQuery(text="fox dog", top_k=10))
        for h in hits:
            merged.append((h.score, h.key))
    merged.sort(key=lambda x: (-x[0], x[1]))
    expect = merged[:10]

    got = [(float(s), sharded.key(int(i))) for s, i in zip(ms, mi)]
    assert len(got) == len(expect)
    for (gs, gk), (es, ek) in zip(got, expect):
        assert abs(gs - es) < 1e-4, (gk, gs, ek, es)
    # same result SET (ties may order differently across merge paths)
    assert {k for _, k in got} == {k for _, k in expect}


def test_mesh_bm25_filters_apply_per_shard(rng, tmp_path):
    n_shards = 2
    docs = [(f"r{i:02d}/f", "fox " + WORDS[i % len(WORDS)]) for i in range(12)]
    shards = [docs[i::n_shards] for i in range(n_shards)]
    engines = [_engine(tmp_path, sh, i) for i, sh in enumerate(shards)]
    mesh = make_mesh(2, query_axis=1, device="cpu")
    sharded = MeshShardedTextEngine(engines, mesh)

    ms, mi = sharded.search(TextQuery(text="fox", top_k=20, key_prefixes=["r00/", "r01/"]))
    keys = {sharded.key(int(i)) for i in mi}
    assert keys == {"r00/f", "r01/f"}


def test_mesh_topk_exceeds_per_shard_capacity(rng, tmp_path):
    """Regression: k was clamped to the PER-SHARD padded doc count, so a
    multi-shard query with top_k > n_pad silently truncated its results."""
    n_shards = 2
    per = 4200  # above the 4096 padding floor, so top_k can exceed n_pad
    docs = [(f"r{i:05d}/f", "fox") for i in range(n_shards * per)]
    shards = [docs[i::n_shards] for i in range(n_shards)]
    engines = [_engine(tmp_path, sh, f"cap{i}") for i, sh in enumerate(shards)]
    mesh = make_mesh(8, query_axis=4, device="cpu")
    sharded = MeshShardedTextEngine(engines, mesh)
    total = n_shards * per
    want = sharded.n_pad + 64  # beyond the old clamp, within the corpus
    assert sharded.n_pad < want <= total

    ms, mi = sharded.search(TextQuery(text="fox", top_k=want))
    assert len(mi) == want  # the old per-shard clamp returned only n_pad
    assert len({int(i) for i in mi}) == want
