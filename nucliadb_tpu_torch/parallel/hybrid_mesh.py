"""Mesh-sharded HYBRID search: vector scan, BM25 and RRF in one program.

Counterpart of ``nucliadb_tpu/parallel/hybrid_mesh.py``. The product's
/find runs keyword and semantic retrieval, then fuses them with RRF
(search/find.py). Here every member of the ``shard`` axis runs its local
int8 candidates, exact rerank AND its local BM25 program; both legs' cuts
merge across the members with the all-gather, and the RRF fusion
(``ops/fusion.py``, rrf_k = 60) runs on the device: no host round trip
between the retrieval legs and the fusion. It replaces the reference's
scatter-gather and Python fusion (shards_query.rs, shard_merge.rs,
rank_fusion.py:106-186) for shards on one host.

Alignment contract: text doc j of shard s and vector row j of shard s are
the same record, so global id ``s * per_shard + j`` is one id space for
both legs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.text_engine.engine import TextQuery
from ..ops import quant
from ..ops.distance import exact_rerank, prepare_query
from ..ops.fusion import rrf_merge
from ..ops.topk import masked_topk, sharded_topk_allgather
from ..utils.platform import device_fetch, stream_wait
from .mesh import Mesh, on_member
from .text_mesh import MeshShardedTextEngine


class MeshHybridIndex:
    """Per-shard (vectors, text engine) pairs fused into one program.

    ``shard_data`` = list of (vectors [n_s, D] f32, DeviceTextEngine): entry
    j of both is the same record."""

    def __init__(self, shard_data, mesh: Mesh, *, similarity: str = "dot"):
        vec_list = [np.asarray(v, np.float32) for v, _ in shard_data]
        engines = [e for _, e in shard_data]
        assert len(vec_list) == mesh.shape["shard"]
        for v, e in zip(vec_list, engines):
            assert v.shape[0] == e.n_docs, (v.shape, e.n_docs)
        self.mesh = mesh
        self.similarity = similarity
        self.text = MeshShardedTextEngine(engines, mesh)

        d = vec_list[0].shape[1]
        # one shared per-shard capacity: the text engine's padded doc count
        per = self.text.n_pad
        self.per_shard = per
        # per shard: {device: tensor} over the distinct devices of its row
        self.vectors, self.valid, self.codes = [], [], []
        for s, v in enumerate(vec_list):
            arena = np.zeros((per, d), np.float32)
            arena[: v.shape[0]] = v
            valid = np.zeros(per, bool)
            valid[: v.shape[0]] = True
            vecs, val, codes = {}, {}, {}
            for dev in mesh.devices[s]:
                if dev in vecs:
                    continue
                with on_member(dev):
                    vecs[dev] = torch.from_numpy(arena).to(dev)
                    val[dev] = torch.from_numpy(valid).to(dev)
                    codes[dev] = quant.Int8Codes.encode(vecs[dev])
            self.vectors.append(vecs)
            self.valid.append(val)
            self.codes.append(codes)
        # text offsets (canonical global ids) follow the vector layout: both
        # sides pad to `per` records a shard
        self.offsets = np.arange(len(vec_list), dtype=np.int64) * per
        for dev in set(mesh.devices.reshape(-1)):
            stream_wait(dev)

    @property
    def n_docs(self) -> int:
        return int(self.text.n_docs)

    def key(self, global_id: int) -> str:
        shard = int(global_id) // self.per_shard
        return self.text.engines[shard].keys[int(global_id) % self.per_shard]

    def search(
        self, queries: np.ndarray, text_query: TextQuery, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Hybrid top-k: [B, D] query vectors and one keyword query applied
        to every row. Returns ([B, k] fused scores, [B, k] global ids)."""
        b = queries.shape[0]
        qn = self.mesh.shape["query"]
        b_pad = -(-b // qn) * qn
        qp = np.zeros((b_pad, queries.shape[1]), np.float32)
        qp[:b] = queries
        ts, ti = _mesh_hybrid(self, k, qp, self.text.member_inputs(text_query))
        ts, ti = device_fetch(ts, ti)
        return ts[:b], ti[:b]


def _merged_legs(index: MeshHybridIndex, k: int, queries: np.ndarray, text_inputs):
    """Per query column c, yields the column's two merged cuts on the
    mesh's first device: ([bq, k] vector scores, ids; [1, k] keyword
    scores, ids). On each member (s, c): the int8 candidates, the exact
    rerank and ``_bm25_search``, the ids offset by ``s * per_shard``; then
    the two all-gather merges."""
    mesh = index.mesh
    n_shards, qn = mesh.devices.shape
    bq = queries.shape[0] // qn
    for c in range(qn):
        q_np = queries[c * bq : (c + 1) * bq]
        vs_, vi_, bs_, bi_ = [], [], [], []
        for s in range(n_shards):
            dev = mesh.devices[s, c]
            base = s * index.per_shard
            with on_member(dev):
                # semantic leg: int8 candidates -> exact rerank (local)
                q = torch.from_numpy(q_np).to(dev)
                qs = prepare_query(q, index.similarity)
                est = quant.int8_estimate_scores(index.codes[s][dev], qs)
                budget = min(quant.int8_rerank_budget(k), est.shape[-1])
                _, cand = masked_topk(est, budget, mask=index.valid[s][dev])
                ls, li = exact_rerank(q, index.vectors[s][dev], cand, k, similarity=index.similarity)
                vs_.append(ls)
                vi_.append(torch.where(li >= 0, li + base, -1))
                # keyword leg: the local BM25 cut
                ks, ki = index.text.member_cut(s, text_inputs[s], k, base)
                bs_.append(ks)
                bi_.append(ki)
        with on_member(mesh.first):
            yield (
                *sharded_topk_allgather(vs_, vi_, k, mesh.first),
                *sharded_topk_allgather(bs_, bi_, k, mesh.first),
            )


def _mesh_hybrid(index: MeshHybridIndex, k: int, queries: np.ndarray, text_inputs):
    """Each query column's merged cuts fused on the device: the RRF of the
    vector cut with the keyword cut broadcast over the column's queries
    (the one keyword query applies to every row)."""
    first = index.mesh.first
    out_s, out_i = [], []
    for _, vg_i, _, bg_i in _merged_legs(index, k, queries, text_inputs):
        with on_member(first):
            fs, fi = rrf_merge(vg_i, bg_i.expand(vg_i.shape[0], -1), k)
        out_s.append(fs)
        out_i.append(fi)
    with on_member(first):
        return torch.cat(out_s), torch.cat(out_i)
