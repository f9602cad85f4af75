"""The vector legs of co-resident shards as one mesh program.

Counterpart of ``nucliadb_tpu/parallel/group.py`` (the reference's
in-process multi-shard parallel query, nidx/src/searcher/shards_query.rs:
29-72): the shards' consolidated vector arenas are placed on the members
of a 1-D ``shard`` mesh (``parallel/mesh.py``), per-request filter masks
are computed on the host per shard (the same prefilter and mask pipeline
as the single-shard path), and one call computes every shard's local top-k
cut. The per-shard cuts come back to the host: the product fuses ALL
per-shard hits (RRF over the concatenated lists, search/find.py); the
merged cut lives in ``MeshShardedVectorIndex`` for engine-level callers.

Parity contract (the JAX package's): each member runs the SAME sequence as
``DeviceVectorIndex.search`` over its shard — ``_search_int8`` (the shared
top-2 slot scan: the CUDA kernel on the card, its plain version on the
CPU, under the same gate, then the exact rerank and masked cut) or
``_search_exact``, with the same Fssc dedup and min_score — in an unrolled
member loop, so each member's launches are those of a sequential call.
The JAX package stacks the members into one ``per = max(p_pad)`` arena
because ``shard_map`` needs one shape; the port's member loop needs none,
so each member reads its shard's own arena (the same tensors on the
shard's card, a copy on another card) and its own p_pad mask. The
reference's padding rows are masked and the top-2 table's slot of a row is
its position modulo the slots, so both layouts give the same cuts. One
deviation, the JAX package's own: quantized candidate selection is chosen
once for the GROUP (every member has int8 codes or none does); a mixed
group, where only some shards exceed EXACT_SCAN_THRESHOLD, runs the exact
scan for every member — better recall than the per-shard path, at
full-scan cost for the big shards. MULTI (MaxSim) members run
``_maxsim_core`` over their own (p_pad, m_max) slot blocks.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from ..index.vector.device import _maxsim_core, _search_exact, _search_int8
from ..ops import quant
from ..ops.topk import NEG_INF
from ..utils.buckets import bucket
from ..utils.platform import device_fetch, stream_wait
from . import mesh as mesh_lib
from .mesh import Mesh, on_member


def mesh_serving_active(device: "str | torch.device" = "cuda") -> bool:
    """True when more than one device of ``device``'s type is visible
    (``mesh.visible_devices``: the distinct cards) and mesh serving is not
    turned off. ``NDBTPU_MESH_SERVING=0`` forces the per-shard path (the
    differential tests compare both paths on the same corpus)."""
    if os.environ.get("NDBTPU_MESH_SERVING", "1") == "0":
        return False
    try:
        return len(mesh_lib.visible_devices(device)) > 1
    except Exception:
        return False


def member_layout(n_shards: int, mesh: Mesh) -> tuple[int, int]:
    """(members per device, padded member count): ``shard_map`` splits the
    stacked member axis into one contiguous block per mesh device."""
    n_dev = mesh.shape["shard"]
    per_dev = -(-n_shards // n_dev)
    return per_dev, per_dev * n_dev


class MeshVectorGroup:
    """The vector arenas of N co-resident shards (one vectorset), copied
    onto a 1-D ``shard`` mesh. Built from the shards' open VectorSearchers;
    rebuilt (by the caller's cache) whenever a member shard reloads."""

    @staticmethod
    def eligible(searchers: Sequence) -> bool:
        if not searchers:
            return False
        cfgs = [s.config for s in searchers]
        # ivf/hnsw/pallas strategies hold per-arena derived state the group
        # program does not replicate
        if any(set(c.flags) & {"ivf", "hnsw", "pallas"} for c in cfgs):
            return False
        # uniform cardinality: MULTI groups run _maxsim_core per member; a
        # mixed single/multi set has no common sequence
        if len({
            (c.dimension, c.similarity, frozenset(c.flags), c.cardinality)
            for c in cfgs
        }) != 1:
            return False
        if any(isinstance(s.index.codes, quant.BinaryCodes) for s in searchers):
            return False
        # beyond-HBM paged arenas keep their f32 rows in host memory
        if any(getattr(s.index, "paging", None) is not None for s in searchers):
            return False
        return True

    def __init__(self, searchers: Sequence, mesh: Mesh | None = None):
        from ..index.vector.config import VectorCardinality

        assert self.eligible(searchers)
        self.searchers = list(searchers)
        first = searchers[0].index
        self.mesh = mesh or Mesh(mesh_lib.visible_devices(first.device), ("shard",))
        s = len(searchers)
        self.n_shards = s
        self.shards_per_dev, self.s_pad = member_layout(s, self.mesh)
        cfg = searchers[0].config
        self.similarity = cfg.similarity.value
        self.multi = cfg.cardinality == VectorCardinality.MULTI

        # member i lives on the mesh device holding its block; the
        # surplus members up to s_pad only pad the mesh axis and run nothing
        self.devices = [self.mesh.devices[i // self.shards_per_dev] for i in range(s)]
        self.use_codes = (not self.multi) and all(
            isinstance(se.index.codes, quant.Int8Codes) for se in searchers
        )
        self.vectors, self.m_counts, self.codes = [], [], []
        self.device_bytes = 0  # bytes of the copies made for members on another card
        for se, dev in zip(searchers, self.devices):
            idx = se.index
            with on_member(dev):
                self.vectors.append(self._member(idx.vectors, dev))
                if self.multi:
                    self.m_counts.append(self._member(idx.m_count, dev))
                elif self.use_codes:
                    self.codes.append(quant.Int8Codes(
                        codes=self._member(idx.codes.codes, dev),
                        scale=self._member(idx.codes.scale, dev),
                    ))
        for dev in set(self.devices):
            stream_wait(dev)  # other threads' streams read the copies

    def _member(self, t: torch.Tensor, dev: torch.device) -> torch.Tensor:
        """``t`` on ``dev``: the shard's own tensor there, else a copy."""
        out = t.to(dev)
        if out is not t:
            self.device_bytes += out.numel() * out.element_size()
        return out

    def search(
        self,
        queries: np.ndarray,
        top_k: int,
        shard_masks: Sequence[np.ndarray],
        *,
        min_score: float | None = None,
        with_duplicates: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Every shard's top-k cut in one call.

        ``shard_masks[i]`` is shard i's combined validity mask (alive ∧
        filters), of length n_para or p_pad of that shard. Returns ([S, B,
        k] scores, [S, B, k] local paragraph ids, -1 = empty): what S
        sequential ``DeviceVectorIndex.search`` calls return."""
        q = np.asarray(queries, np.float32)
        masks = []
        for se, mk in zip(self.searchers, shard_masks):
            m = np.zeros(se.index.p_pad, bool)
            m[: mk.shape[0]] = mk
            masks.append(m)
        # the floor compares in f32, as the JAX package's device scalar does
        ms = float(np.float32(NEG_INF if min_score is None else min_score))
        dedup = not with_duplicates
        if self.multi:
            # [B, D] single query vectors run as MaxSim with M = 1, as
            # DeviceVectorIndex.search re-enters them
            q3 = q if q.ndim == 3 else q[:, None, :]
            b = q3.shape[0]
            qp = np.zeros((bucket(b, minimum=1),) + q3.shape[1:], np.float32)
            qp[:b] = q3
            qmask = np.zeros(qp.shape[:2], bool)
            qmask[:b] = np.abs(q3).sum(-1) > 0
            s_, i_ = _group_search_multi(self, top_k, dedup, masks, ms, qp, qmask)
        else:
            b = q.shape[0]
            qp = np.zeros((bucket(b, minimum=8), q.shape[1]), np.float32)
            qp[:b] = q
            s_, i_ = _group_search(self, top_k, dedup, masks, ms, qp)
        s_, i_ = device_fetch(s_, i_)
        return s_[:, :b], i_[:, :b]


def _gather_members(group: MeshVectorGroup, outs) -> tuple[torch.Tensor, torch.Tensor]:
    """[S, B, k] x2 on the mesh's first device, in member order (the
    sharded output's single-process fetch)."""
    first = group.mesh.first
    with on_member(first):
        return (
            torch.stack([o[0].to(first) for o in outs]),
            torch.stack([o[1].to(first) for o in outs]),
        )


def _group_search(group: MeshVectorGroup, k, dedup, masks, min_score, queries):
    """Each member's ``_search_int8``/``_search_exact`` over its arena
    (``group.py:237`` of the JAX package), in member order."""
    outs = []
    for i, dev in enumerate(group.devices):
        with on_member(dev):
            mk = torch.from_numpy(masks[i]).to(dev)
            qt = torch.from_numpy(queries).to(dev)
            args = (group.vectors[i], qt, mk, min_score, k, group.similarity, dedup)
            if group.use_codes:
                outs.append(_search_int8(group.codes[i], *args))
            else:
                outs.append(_search_exact(*args))
    return _gather_members(group, outs)


def _group_search_multi(group: MeshVectorGroup, k, dedup, masks, min_score, queries, qmask):
    """Each member's ``_maxsim_core`` over its slot arena (``group.py:286``
    of the JAX package; nidx_vector/src/searcher.rs:345-394 and
    multivector.rs:18-46), in member order."""
    outs = []
    for i, (se, dev) in enumerate(zip(group.searchers, group.devices)):
        with on_member(dev):
            outs.append(_maxsim_core(
                group.vectors[i], group.m_counts[i], torch.from_numpy(queries).to(dev),
                torch.from_numpy(qmask).to(dev), torch.from_numpy(masks[i]).to(dev),
                min_score, k, se.index.m_max, group.similarity, dedup=dedup,
            ))
    return _gather_members(group, outs)
