"""The semantic leg of ``nucliadb_tpu_torch`` as the system under test.

``build`` makes the configuration's corpus on the device from the seed and
hands it to the port's own constructors, in memory:
``DeviceVectorIndex.from_reference_state`` over the arena, the labels and
the deletions, with int8 codes from the port's ``Int8Codes.encode`` when
the index is above the port's exact-scan threshold (as ``DeviceVectorIndex``
builds them from segments), held by a ``VectorSearcher`` made around it
without its segment constructor. The entries are the two routes a node
serves a semantic query by: ``searcher`` (``VectorSearcher.search`` with a
batch) and ``coalescer`` (the node's ``coalescer.search_one``, one query
a request, as ``shard/searcher.py`` sends it).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import corpus

ROOT = Path(__file__).resolve().parents[2]
# the hand kernels of the semantic leg, by the names the profiler gives them
HAND_KERNELS = ("slot_scan_wgmma", "binary_scan_partial")


def _port():
    """The port's package, which has to be the checkout's own."""
    import nucliadb_tpu_torch

    where = Path(nucliadb_tpu_torch.__file__).resolve()
    if ROOT not in where.parents:
        raise RuntimeError(f"nucliadb_tpu_torch was loaded from {where}, outside the checkout {ROOT}")
    return nucliadb_tpu_torch


class VectorSystem:
    def __init__(self, config: dict, seed: int, device):
        _port()
        from nucliadb_tpu_torch.index.vector import (
            LabelAtom, VectorConfig, VectorSearcher, VectorSearchRequest,
        )
        from nucliadb_tpu_torch.index.vector import batcher, device as device_mod
        from nucliadb_tpu_torch.ops import binary_scan, quant, slot_scan
        from nucliadb_tpu_torch.utils.buckets import bucket

        self.device = torch.device(device)
        self.n = n = int(config["rows"])
        self.d = d = int(config["dimension"])
        self.similarity = config["similarity"]
        self.label = config["label"]
        self._request = VectorSearchRequest
        self._filter = LabelAtom(self.label)
        self.coalescer = batcher.coalescer
        self._counters = (slot_scan.LAUNCHES, binary_scan.LAUNCHES)
        self.hand_kernels = HAND_KERNELS
        vcfg = VectorConfig(
            dimension=d, similarity=self.similarity,
            quantization=config["quantization"], flags=list(config.get("flags", [])),
        )

        # the arena as the port pads it, made on the device, then handed to
        # the constructor as host arrays (it takes numpy state)
        p_pad = bucket(n + 1)
        arena = torch.zeros((p_pad, d), dtype=torch.float32, device=self.device)
        corpus.fill_rows(arena[:n], seed, n)
        arrays = {
            "alive": corpus.alive(n, int(config["delete_every"])),
            "para_seg": np.zeros(n, np.int32),
        }
        if n > device_mod.EXACT_SCAN_THRESHOLD and vcfg.quantization.value == "int8":
            codes = quant.Int8Codes.encode(arena)
            arrays["codes"] = codes.codes.cpu().numpy()
            arrays["scale"] = codes.scale.cpu().numpy()
            del codes
        arrays["vectors"] = arena.cpu().numpy()
        del arena
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        keys = [corpus.key_of(i) for i in range(n)]
        meta = {"field": "/f/f", "split": "", "position": {"start": 0, "end": 10, "page_number": 0}}
        labels = {self.label: np.flatnonzero(corpus.labelled(n, int(config["label_every"]))).astype(np.int32)}
        index = device_mod.DeviceVectorIndex.from_reference_state(
            vcfg, keys, [meta] * n, labels, [frozenset()], [(0, n)], arrays, device=self.device,
        )
        self.searcher = VectorSearcher.__new__(VectorSearcher)
        self.searcher.config = vcfg
        self.searcher.index = index
        self.entries = {"searcher": self.search_batch, "coalescer": self.search_one}

    # -- entries -----------------------------------------------------------

    def _req(self, vectors: np.ndarray, top_k: int, filtered: bool):
        return self._request(vectors=vectors, top_k=top_k, filter=self._filter if filtered else None)

    def search_batch(self, queries: np.ndarray, top_k: int, filtered: bool) -> list:
        return self.searcher.search(self._req(queries, top_k, filtered))

    def search_one(self, queries: np.ndarray, top_k: int, filtered: bool) -> list:
        if queries.shape[0] != 1:
            raise ValueError("the coalescer entry takes one query a request")
        return [self.coalescer.search_one(self.searcher, self._req(queries[0], top_k, filtered))]

    @staticmethod
    def answer(hits) -> tuple[list, list]:
        return [h.key for h in hits], [h.score for h in hits]

    # -- what the traced run reads ------------------------------------------

    def instrument(self, spans) -> None:
        """Record a span around each ``VectorSearcher.search`` and each
        ``DeviceVectorIndex.search``, by instance attributes that the
        coalescer's and the searcher's calls find first."""
        index = self.searcher.index
        self.searcher.search = spans.wrap("searcher.search", self.searcher.search)
        index.search = spans.wrap(
            "device_index.search", index.search, rows_of=lambda q, *a, **k: int(np.shape(q)[0])
        )
        self.entries = {
            "searcher": spans.wrap("request", self.search_batch),
            "coalescer": spans.wrap("coalescer.search_one", self.search_one),
        }

    def hand_launches(self) -> int:
        return sum(c.total() for c in self._counters)

    def coalescer_counts(self) -> tuple[int, int]:
        return self.coalescer.dispatches, self.coalescer.batched_queries

    def free(self) -> None:
        """Drop the program's state, so that the reference finds the
        device's memory free."""
        self.entries = {}
        self.searcher = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def build(config: dict, seed: int, device) -> VectorSystem:
    return VectorSystem(config, seed, device)
