"""Mesh-sharded BM25: per-shard postings and the all-gather top-k merge.

Counterpart of ``nucliadb_tpu/parallel/text_mesh.py``, the keyword half of
the hybrid mesh (the vector half is ``parallel/mesh.py``). Each member of
the ``shard`` axis holds one document partition's tiered postings (the
layout a solo-group ``DeviceTextEngine`` builds), a query runs the
single-arena program ``_bm25_search`` on every member, and the members'
cuts merge through ``sharded_topk_allgather`` — the reference's
cross-node scatter-gather and host merge
(nidx/src/searcher/{shards_query,shard_merge}.rs) for shards on one host.

Query planning stays on the host per shard (term -> tier/row is
shard-local); the scoring runs on the devices. Global doc id = the shard's
cumulative doc offset + its local id.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.text_engine.engine import DeviceTextEngine, TextQuery, _bm25_search
from ..ops import bm25
from ..ops.topk import sharded_topk_allgather
from ..utils.platform import device_fetch, stream_wait
from .mesh import Mesh, on_member


class MeshShardedTextEngine:
    """S solo-group engines on the S members of the ``shard`` mesh axis.
    Global doc id = the shard's cumulative doc offset + its local id.

    The JAX package pads the engines' tiers, dense blocks and doc lengths
    to common shapes for its one static kernel; a member loop needs no
    common shape, so each member reads its engine's own tensors (padding
    columns are masked, so the cuts are the same). ``n_pad``, the widest
    member's score space, bounds ``k`` and is the hybrid index's stride,
    as there."""

    def __init__(self, engines: list[DeviceTextEngine], mesh: Mesh):
        assert len(engines) == mesh.shape["shard"], (len(engines), mesh.shape)
        self.engines = engines
        self.mesh = mesh
        # mesh engines are freshly built (one solo arena group), so every
        # shard shares the full tier and dense layout and the fixed caps
        assert all(len(e.groups) == 1 for e in engines), (
            "mesh sharding expects full-built engines (one solo group)"
        )
        self.caps = engines[0].fixed_caps()
        # the member of shard s on query column 0 (the keyword leg has no
        # query axis: one query runs once a shard)
        self.devices = [mesh.devices[i, 0] if mesh.devices.ndim == 2 else mesh.devices[i] for i in range(len(engines))]
        self.n_pad = max(e.dense_tf.shape[1] for e in engines)
        self.arenas = []
        for e, dev in zip(engines, self.devices):
            with on_member(dev):
                self.arenas.append((
                    tuple(tuple(t.to(dev) for t in tier) for tier in e.tiers),
                    e.dense_tf.to(dev),
                    e.dlen.to(dev),
                ))
        # each member's kernel layout, once (the engines are one refresh)
        self.layouts = [
            bm25.arena_layout(*arena) if dev.type == "cuda" else None
            for arena, dev in zip(self.arenas, self.devices)
        ]
        self.offsets = np.cumsum([0] + [e.n_docs for e in engines])  # [S + 1]
        for dev in set(self.devices):
            stream_wait(dev)

    @property
    def n_docs(self) -> int:
        return int(self.offsets[-1])

    def key(self, global_id: int) -> str:
        shard = int(np.searchsorted(self.offsets, global_id, side="right") - 1)
        return self.engines[shard].keys[global_id - self.offsets[shard]]

    def member_inputs(self, query: TextQuery) -> list:
        """Each shard's (rows, idfs, params, mask) for ``query``."""
        out = []
        for e in self.engines:
            r, w, p, mk = e._device_inputs(query)
            out.append((r, w, np.asarray(p, np.float32), mk))
        return out

    def member_cut(self, i: int, inputs, k: int, offset: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Shard i's ``_bm25_search`` cut as ([1, k] scores, [1, k] ids
        offset by ``offset``), on its member's device."""
        dev = self.devices[i]
        r, w, p, m = (torch.from_numpy(x).to(dev) for x in inputs)
        tiers, dense, dlen = self.arenas[i]
        top_s, top_ic, _ = _bm25_search(tiers, dense, None, dlen, m, r, w, p, k, self.caps, 0,
                                        layout=self.layouts[i])
        top_i = top_ic[:k]  # ids lead the packed [ids | term counts] array
        return top_s[None], torch.where(top_i >= 0, top_i + offset, -1)[None]

    def search(self, query: TextQuery) -> tuple[np.ndarray, np.ndarray]:
        """Returns ([k] scores, [k] global doc ids): the merged cut."""
        s = len(self.engines)
        # capped at the MESH-wide doc capacity: _bm25_search's masked top-k
        # pads when k exceeds one shard's corpus
        k = min(query.top_k, s * self.n_pad)
        ts, ti = _mesh_bm25(self, k, self.member_inputs(query))
        ts, ti = device_fetch(ts, ti)
        out_s, out_i = ts[0], ti[0]
        keep = out_i >= 0
        return out_s[keep], out_i[keep]


def _mesh_bm25(index: MeshShardedTextEngine, k: int, inputs):
    """Every member's ``_bm25_search``, then the all-gather merge."""
    cut_s, cut_i = [], []
    for i, dev in enumerate(index.devices):
        with on_member(dev):
            ls, li = index.member_cut(i, inputs[i], k, int(index.offsets[i]))
        cut_s.append(ls)
        cut_i.append(li)
    first = index.mesh.first
    with on_member(first):
        return sharded_topk_allgather(cut_s, cut_i, k, first)
