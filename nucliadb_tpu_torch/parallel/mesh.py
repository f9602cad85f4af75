"""The port's device mesh, and the mesh-sharded vector index.

Counterpart of ``nucliadb_tpu/parallel/mesh.py``. The JAX package runs
one program over many devices (``shard_map`` over a ``jax.sharding.Mesh``)
and merges the shards' cuts with ``lax.all_gather``. The port keeps that
shape in one process:

- ``Mesh`` is a NumPy array of ``torch.device`` with axis names, and
  ``mesh.shape[axis]`` as JAX's has. A mesh may repeat a device: the tests
  run an 8-member mesh of ``cpu``, ``chip_smoke.py`` a 4-member mesh of one
  card.
- A ``shard_map`` is a Python loop over the members, in member order.
  Member j's tensors live on its device and its launches go on that
  device's stream of the calling thread (``utils/platform.thread_stream``).
  Nothing is batched across members, so each member launches what a
  sequential call over its shard launches.
- The all-gather is a copy of each member's cut to the mesh's first device
  and a concatenation in member order (``ops/topk.sharded_topk_allgather``).
  There is no ``torch.distributed`` and no NCCL.

``MeshShardedVectorIndex`` partitions one vector arena over the ``shard``
axis (the reference's shard fan-out, nidx/src/searcher/shards_query.rs:
29-72, with the merge of shard_merge.rs:54-332) and the query batch over
the ``query`` axis: each query sub-batch runs on a row of members against
every shard, and the merged cut comes back.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch

from ..ops import quant
from ..ops.distance import exact_rerank, prepare_query, scores_matmul
from ..ops.topk import masked_topk, sharded_topk_allgather
from ..utils.platform import device_fetch, resolve_device, stream_wait, thread_stream


def visible_devices(device: "str | torch.device" = "cuda") -> list[torch.device]:
    """The devices a mesh of ``device``'s type spans: every visible card
    for ``cuda``, the one CPU for ``cpu``. The serving gate
    (``group.mesh_serving_active``) counts them; tests replace this one
    function to stand a repeated device in for several."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


class Mesh:
    """Devices laid out on named axes (``jax.sharding.Mesh``'s role)."""

    def __init__(self, devices: Sequence, axis_names: Sequence[str]):
        flat = list(np.asarray(devices, dtype=object).reshape(-1))
        arr = np.empty(len(flat), dtype=object)
        arr[:] = [torch.device(d) for d in flat]
        shape = np.shape(np.asarray(devices, dtype=object))
        self.devices = arr.reshape(shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {shape} for axes {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first(self) -> torch.device:
        """The device the all-gathers copy to."""
        return self.devices.reshape(-1)[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def make_mesh(n_devices: int | None = None, query_axis: int = 1, *, device: "str | torch.device" = "cuda") -> Mesh:
    """A (shard, query) mesh over ``visible_devices(device)``. Unlike the
    JAX package's, a mesh of more members than devices repeats them in
    turn (one card stands in for several)."""
    devices = visible_devices(device)
    n = n_devices or len(devices)
    assert n % query_axis == 0, (n, query_axis)
    members = [devices[i % len(devices)] for i in range(n)]
    arr = np.empty(n, dtype=object)
    arr[:] = members
    return Mesh(arr.reshape(n // query_axis, query_axis), ("shard", "query"))


def on_member(device: torch.device):
    """The context a member's launches run in: its card current, and the
    calling thread's stream on it (nothing on the CPU)."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    thread_stream(device)
    return torch.cuda.device(device)


def _row_copies(rows: np.ndarray, devices, dtype=torch.float32) -> dict:
    """One upload of ``rows`` to each distinct device of ``devices``."""
    out = {}
    for dev in devices:
        if dev not in out:
            thread_stream(dev)
            out[dev] = torch.from_numpy(np.ascontiguousarray(rows)).to(dev, dtype)
    return out


class MeshShardedVectorIndex:
    """A vector arena partitioned over the ``shard`` mesh axis.

    Shard s holds rows ``[s * per_shard, (s + 1) * per_shard)`` (the last
    shard zero-padded) on every device of its mesh row, with optional int8
    codes. Queries split over the ``query`` axis; every query sees every
    shard; the merged cut is the global top-k."""

    def __init__(
        self,
        vectors: np.ndarray,
        mesh: Mesh,
        *,
        quantize: bool = False,
        similarity: str = "dot",
    ):
        self.mesh = mesh
        self.similarity = similarity
        n_shards = mesh.shape["shard"]
        n, d = vectors.shape
        per = -(-n // n_shards)
        n_pad = per * n_shards
        vectors = np.asarray(vectors, np.float32)
        if n_pad != n:
            vectors = np.concatenate([vectors, np.zeros((n_pad - n, d), np.float32)])
        self.n = n
        self.n_pad = n_pad
        self.per_shard = per
        valid = np.arange(n_pad) < n

        # per shard: {device: tensor} over the distinct devices of its row
        self.vectors, self.valid, self.codes = [], [], []
        for s in range(n_shards):
            row = list(mesh.devices[s])
            rows = slice(s * per, (s + 1) * per)
            vecs = _row_copies(vectors[rows], row)
            self.vectors.append(vecs)
            self.valid.append(_row_copies(valid[rows], row, torch.bool))
            if quantize:
                # the sharded encode: each shard's codes from its own rows
                codes = {}
                for dev, v in vecs.items():
                    with on_member(dev):
                        codes[dev] = quant.Int8Codes.encode(v)
                self.codes.append(codes)
        self.quantized = quantize
        for dev in {d for d in mesh.devices.reshape(-1)}:
            stream_wait(dev)  # other threads' streams read the shards

    def search(self, queries: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Global top-k over all shards; queries [B, D] (padded here to a
        multiple of the query axis). Returns ([B, k] scores, [B, k] ids)."""
        b = queries.shape[0]
        qn = self.mesh.shape["query"]
        b_pad = -(-b // qn) * qn
        qp = np.zeros((b_pad, queries.shape[1]), np.float32)
        qp[:b] = queries
        fn = _sharded_search_quant if self.quantized else _sharded_search_exact
        s, i = fn(self, k, qp)
        s, i = device_fetch(s, i)
        return s[:b], i[:b]


def _sharded_search(index: MeshShardedVectorIndex, k: int, queries: np.ndarray, local):
    """The shard_map of ``_sharded_search_exact``/``_quant``: query column
    c's sub-batch runs ``local(s, device, q)`` on each member (s, c) in
    member order, the shard's ids are offset by ``s * per_shard``, and the
    members' cuts merge with ``sharded_topk_allgather``; the columns'
    merged cuts concatenate on the mesh's first device."""
    mesh = index.mesh
    n_shards, qn = mesh.devices.shape
    bq = queries.shape[0] // qn
    out_s, out_i = [], []
    for c in range(qn):
        q_np = queries[c * bq : (c + 1) * bq]
        cut_s, cut_i = [], []
        for s in range(n_shards):
            dev = mesh.devices[s, c]
            with on_member(dev):
                q = torch.from_numpy(q_np).to(dev)
                ls, li = local(s, dev, q)
                cut_s.append(ls)
                cut_i.append(torch.where(li >= 0, li + s * index.per_shard, -1))
        with on_member(mesh.first):
            ms, mi = sharded_topk_allgather(cut_s, cut_i, k, mesh.first)
        out_s.append(ms)
        out_i.append(mi)
    with on_member(mesh.first):
        return torch.cat(out_s), torch.cat(out_i)


def _sharded_search_exact(index: MeshShardedVectorIndex, k: int, queries: np.ndarray):
    def local(s, dev, q):
        qs = prepare_query(q, index.similarity)
        scores = scores_matmul(qs, index.vectors[s][dev])  # [B_local, N_local]
        return masked_topk(scores, k, mask=index.valid[s][dev])

    return _sharded_search(index, k, queries, local)


def _sharded_search_quant(index: MeshShardedVectorIndex, k: int, queries: np.ndarray):
    def local(s, dev, q):
        qs = prepare_query(q, index.similarity)
        est = quant.int8_estimate_scores(index.codes[s][dev], qs)
        c = min(quant.int8_rerank_budget(k), est.shape[-1])
        # approx_candidates: on the CPU the JAX package's lax.approx_max_k
        # is this exact top-c
        _, cand = masked_topk(est, c, mask=index.valid[s][dev])
        return exact_rerank(q, index.vectors[s][dev], cand, k, similarity=index.similarity)

    return _sharded_search(index, k, queries, local)
