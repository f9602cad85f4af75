"""HNSW build time and recall at a corpus size, on the card.

Counterpart of ``tools/hnsw_build_bench.py``: the same clustered recipe
(4,096 unit centres; each row a centre plus ``(spread / sqrt(d)) * N(0, 1)``
noise, L2-normalised, spread 1.0), drawn on the device with a seeded
``torch.Generator``. It builds the graph with ``ops.hnsw.build_graph``
(the device scans the waves, the host links them), then searches 256
queries (``near_queries``: corpus rows plus 0.05 * N(0, 1) noise,
normalised) at the default regime and at both fixed regimes, against an
exact f32 oracle on the card.

Run from the root of a checkout:

    python3 -m nucliadb_tpu_torch.tools.hnsw_build_bench [n] [d] [queries] [--device cuda|cpu]

It prints the card's name and power limit, then one JSON line: build
seconds (and of them the host linker's, ``LinkTimer``), waves and chunk
calls, and recall@10 with ms per batch at each search regime.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import numpy as np
import torch

N_CENTERS = 4096
SPREAD = 1.0
SEED = 7


def clustered_corpus(n: int, d: int, *, device, seed: int = SEED, n_centers: int = N_CENTERS,
                     spread: float = SPREAD) -> torch.Tensor:
    """[n, d] rows on ``device`` from the recipe: unit centres, a centre per
    row plus ``spread / sqrt(d)`` Gaussian noise, rows normalised."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    centers = torch.randn(n_centers, d, generator=gen, device=device)
    centers /= centers.norm(dim=1, keepdim=True)
    out = torch.empty((n, d), device=device)
    for lo in range(0, n, 131072):  # bounds the noise temporaries
        hi = min(n, lo + 131072)
        cid = torch.randint(0, n_centers, (hi - lo,), generator=gen, device=device)
        v = centers[cid] + (spread / math.sqrt(d)) * torch.randn(hi - lo, d, generator=gen, device=device)
        out[lo:hi] = v / v.norm(dim=1, keepdim=True)
    return out


def near_queries(vecs: torch.Tensor, n_queries: int, *, seed: int = SEED + 1, noise: float = 0.05) -> torch.Tensor:
    """[n_queries, d] queries: random rows of ``vecs`` plus ``noise`` *
    N(0, 1) in each dimension, normalised."""
    gen = torch.Generator(device=vecs.device)
    gen.manual_seed(seed)
    ids = torch.randint(0, vecs.shape[0], (n_queries,), generator=gen, device=vecs.device)
    q = vecs[ids] + noise * torch.randn(n_queries, vecs.shape[1], generator=gen, device=vecs.device)
    return q / q.norm(dim=1, keepdim=True)


class LinkTimer:
    """Sums the host seconds of ``ops.hnsw``'s native wave linker while it
    is entered (a timing proxy in place of ``hnsw._native``): the rest of
    a build is the card's wave scans not hidden behind the linking, the
    fetches and the host's bookkeeping."""

    def __init__(self, hnsw):
        self.hnsw, self.seconds, self.calls = hnsw, 0.0, 0

    def __enter__(self):
        self._native = native = self.hnsw._native
        timer = self

        class Timed:
            @staticmethod
            def hnsw_link_wave(*args):
                t = time.perf_counter()
                try:
                    return native.hnsw_link_wave(*args)
                finally:
                    timer.seconds += time.perf_counter() - t
                    timer.calls += 1

        if native is not None:
            self.hnsw._native = Timed()
        return self

    def __exit__(self, *exc):
        self.hnsw._native = self._native


def exact_top10(vecs: torch.Tensor, q: torch.Tensor) -> np.ndarray:
    best_s = torch.full((q.shape[0], 10), -float("inf"), device=vecs.device)
    best_i = torch.full((q.shape[0], 10), -1, dtype=torch.long, device=vecs.device)
    for lo in range(0, vecs.shape[0], 131072):
        s = q @ vecs[lo : lo + 131072].T
        ids = torch.arange(lo, lo + s.shape[1], device=vecs.device).expand_as(s)
        best_s, pos = torch.cat([best_s, s], 1).topk(10, dim=1)
        best_i = torch.gather(torch.cat([best_i, ids], 1), 1, pos)
    return best_i.cpu().numpy()


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("n", type=int, nargs="?", default=1_000_000)
    parser.add_argument("d", type=int, nargs="?", default=768)
    parser.add_argument("queries", type=int, nargs="?", default=256)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    from nucliadb_tpu_torch.ops import hnsw
    from nucliadb_tpu_torch.utils.platform import device_fetch, resolve_device, thread_stream

    dev = resolve_device(args.device)
    thread_stream(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip(), flush=True)
    n, d = args.n, args.d
    t = time.perf_counter()
    vecs = clustered_corpus(n, d, device=dev)
    vectors_np = vecs.cpu().numpy()
    sync()
    gen_s = time.perf_counter() - t

    t = time.perf_counter()
    with LinkTimer(hnsw) as link:
        adj, entry = hnsw.build_graph(vectors_np, vectors_dev=vecs)
        sync()
    build_s = time.perf_counter() - t
    waves = -(-max(n - hnsw.WAVE, 0) // hnsw.WAVE)

    q = near_queries(vecs, args.queries)
    oracle = exact_top10(vecs, q)
    adj_t = torch.from_numpy(adj.astype(np.int64)).to(dev)
    entry_t = torch.from_numpy(entry.astype(np.int64)).to(dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    default_pt = hnsw.default_search_params(n)
    regimes = [(hnsw.EF_SEARCH, hnsw.SEARCH_TRIPS), (hnsw.EF_SEARCH_WIDE, hnsw.SEARCH_TRIPS_WIDE)]
    points = []
    for ef, trips in regimes:
        def run():
            return device_fetch(*hnsw.hnsw_search(vecs, adj_t, entry_t, q, mask, -3.0e38, 10, ef=ef, trips=trips))

        run()  # warm-up
        t = time.perf_counter()
        _, ids = run()
        search_ms = (time.perf_counter() - t) * 1e3
        recall = float(np.mean([len(set(ids[b].tolist()) & set(oracle[b].tolist())) / 10 for b in range(len(ids))]))
        points.append({"ef": ef, "trips": trips, "default": (ef, trips) == default_pt,
                       "recall_at_10_vs_exact": recall, "ms_per_batch": search_ms})
    print(json.dumps({
        "metric": f"hnsw_build_{n}x{d}", "device": str(dev), "build_s": build_s, "link_s": link.seconds,
        "link_calls": link.calls, "gen_s": gen_s,
        "waves": waves, "chunk_calls": -(-waves // hnsw.WAVES_PER_CALL), "search_points": points,
        "n": n, "d": d, "queries": args.queries, "n_centers": N_CENTERS, "spread": SPREAD,
        "native_linker": hnsw._native is not None,
    }), flush=True)


if __name__ == "__main__":
    main()
