#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``nucliadb_tpu_torch``) on one card.

Run from the root of a checkout, on a machine with an NVIDIA card:

    python3 chip_smoke.py

It drives the port's main path, the semantic leg of /find over an int8
vector index, once at full size, in phases that each print one line:

1. device: the card's name and power limit;
2. build: compiles every kernel of the path from ``nucliadb_tpu_torch/csrc``;
3. kernel vs plain: the top-2 slot-scan kernel against its plain PyTorch
   version on the card, bit for bit, over B in {8, 192, 2048},
   N in {4096, 6144, 1048576}, D in {128, 768}, S in {128, 256}, with an
   all-masked column range, planted pair collisions and planted ties; then
   both timed at B=2048, N=1048576, D=768, S=256;
4. slice: a clustered 1,000,000 x 768 corpus made from a seed (1024
   centres, noise 0.35, rows L2-normalised, a label on every tenth
   paragraph) written as 4 segments plus a deletion, opened through
   ``VectorSearcher(..., device="cuda")`` with int8 codes (p_pad
   1,048,576), and queried: a batch of 2048 at top-10 with the default
   dedup, one single query, one label-filtered and one min_score request.
   The slot-scan launch count must grow over that run; recall@10 against
   an exact f32 oracle on 1024 queries must reach 0.95; the filtered
   request must return only labelled, undeleted paragraphs;
5. breakdown: the batch's device time by layer, and its host time.

It then prints the kernels' JSON line and, last, ``{"ok": true, "device":
{...}}``. Any failed check exits non-zero and prints no result. It imports
nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import tempfile
import time

import numpy as np

SEED = 42
N_ROWS = 1_000_000
DIM = 768
N_CENTERS = 1024
NOISE = 0.35
BATCH = 2048
ORACLE_QUERIES = 1024
TOP_K = 10
RECALL_BAR = 0.95  # the reference's bar (BASELINE.md:12)
N_SEGMENTS = 4
DELETED = "r012345/"  # resource prefix removed by the deletion
KERNEL_SHAPES = [
    (b, n, d, s)
    for d in (128, 768)
    for s in (128, 256)
    for n in (4096, 6144, 1048576)
    for b in (8, 192, 2048)
]
TIMED_SHAPE = (2048, 1048576, 768, 256)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def key_of(i: int) -> str:
    # zero-padded resources sort in generation order: arena row == i
    return f"r{i // 10:06d}/f/{i % 10}/0-10"


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_inputs(gen, d, s, n_max, b_max, device):
    """Random codes with an all-masked range, planted pair collisions
    (ids j*31 and j*31+S share slot j*31) and planted ties (equal rows at
    ids in one slot and across slots)."""
    import torch

    codes = torch.randint(-127, 128, (n_max, d), generator=gen, device=device, dtype=torch.int8)
    scale = torch.rand(n_max, generator=gen, device=device) + 0.5
    mask = torch.rand(n_max, generator=gen, device=device) > 0.1
    mask[2048:4096] = False
    q = torch.randint(-127, 128, (b_max, d), generator=gen, device=device, dtype=torch.int8)
    pair = (torch.sign(q[0].float()) * 90).to(torch.int8)
    for j in range(5):
        for pid in (j * 31, j * 31 + s):
            codes[pid], scale[pid], mask[pid] = pair, 1.0, True
    hot = q[2].clone()
    for pid in (5, 5 + s, 5 + 3 * s, 6, 700, 4100, 5 + (6000 // s) * s):
        codes[pid], scale[pid], mask[pid] = hot, 1.0, True
    q[4::2] = hot
    return q, codes, scale, mask


def phase_kernels(torch, slot_scan):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    max_err = 0.0
    for d in (128, 768):
        for s in (128, 256):
            q, codes, scale, mask = kernel_inputs(gen, d, s, 1048576, 2048, "cuda")
            for b, n, dd, ss in KERNEL_SHAPES:
                if (dd, ss) != (d, s):
                    continue
                args = (q[:b], codes[:n], scale[:n], mask[:n])
                ks, ki = slot_scan.int8_scan_slots_resident2(*args, slots=s)
                rs, ri = slot_scan.int8_scan_slots_resident2_reference(*args, slots=s)
                torch.cuda.synchronize()
                same = torch.equal(ks.view(torch.int32), rs.view(torch.int32)) and torch.equal(ki, ri)
                check(same, f"kernel != plain at B={b} N={n} D={d} S={s}")
                max_err = max(max_err, float((ks - rs).abs().max()))
            if (d, s) == TIMED_SHAPE[2:]:
                args = (q, codes, scale, mask)
                kernel_ms = cuda_ms(lambda: slot_scan.int8_scan_slots_resident2(*args, slots=s), 5)
                plain_ms = cuda_ms(
                    lambda: slot_scan.int8_scan_slots_resident2_reference(*args, slots=s), 3
                )
            del q, codes, scale, mask
    torch.cuda.empty_cache()
    return max_err, kernel_ms, plain_ms


def make_corpus(torch, n, d, n_queries):
    """bench.py's recipe on the card: rows and queries are a random centre
    plus 0.35 * N(0, 1) noise, L2-normalised. As in bench.py, each centre
    owns a contiguous block of rows: a layout striding clusters by a
    multiple of the slot count would put a whole cluster into one slot."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    centers = torch.randn(N_CENTERS, d, generator=gen, device="cuda")
    vecs = torch.empty((n, d), device="cuda")
    for lo in range(0, n, 131072):
        hi = min(n, lo + 131072)
        assign = torch.arange(lo, hi, device="cuda") * N_CENTERS // n
        block = centers[assign] + NOISE * torch.randn(hi - lo, d, generator=gen, device="cuda")
        vecs[lo:hi] = block / block.norm(dim=-1, keepdim=True)
    assign = torch.randint(0, N_CENTERS, (n_queries,), generator=gen, device="cuda")
    q = centers[assign] + NOISE * torch.randn(n_queries, d, generator=gen, device="cuda")
    return vecs, q / q.norm(dim=-1, keepdim=True)


def exact_oracle(torch, vecs, alive, q, k):
    """Exact f32 top-k ids over the alive rows, on the card in chunks."""
    best_s = torch.full((q.shape[0], k), -float("inf"), device="cuda")
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.long, device="cuda")
    for lo in range(0, vecs.shape[0], 131072):
        s = q @ vecs[lo : lo + 131072].T
        s = torch.where(alive[lo : lo + 131072], s, -float("inf"))
        ids = torch.arange(lo, lo + s.shape[1], device="cuda").expand_as(s)
        best_s, pos = torch.cat([best_s, s], 1).topk(k, dim=1)
        best_i = torch.gather(torch.cat([best_i, ids], 1), 1, pos)
    return best_i.cpu().numpy()


def phase_slice(torch, slot_scan, tmp):
    from nucliadb_tpu_torch.index.vector import (
        Elem, LabelAtom, Quantization, Seq, Similarity, SimpleOpenIndex,
        VectorConfig, VectorSearcher, VectorSearchRequest, create_segment,
    )

    t0 = time.perf_counter()
    vecs, queries = make_corpus(torch, N_ROWS, DIM, BATCH)
    # the single query sits on a deleted paragraph: it must not come back
    deleted_row = int(DELETED[1:-1]) * 10 + 3
    queries[0] = vecs[deleted_row]
    host = vecs.cpu().numpy()
    t_gen = time.perf_counter() - t0

    cfg = VectorConfig(dimension=DIM, similarity=Similarity.DOT, quantization=Quantization.INT8)
    segs, per = [], N_ROWS // N_SEGMENTS
    for s in range(N_SEGMENTS):
        elems = [
            Elem(key=key_of(i), vectors=host[i], labels=["/l/tenth"] if i % 10 == 0 else [])
            for i in range(s * per, (s + 1) * per)
        ]
        segs.append((create_segment(f"{tmp}/s{s}", elems, cfg), Seq(s + 1)))
    open_index = SimpleOpenIndex(segment_list=segs, deletion_list=[(DELETED, Seq(N_SEGMENTS + 1))])
    t_write = time.perf_counter() - t0 - t_gen
    searcher = VectorSearcher(cfg, open_index, device="cuda")
    torch.cuda.synchronize()
    t_open = time.perf_counter() - t0 - t_gen - t_write
    idx = searcher.index
    check(idx.p_pad == 1048576 and idx.codes is not None, f"p_pad {idx.p_pad}, codes {idx.codes is not None}")
    check(idx.keys[:3] == [key_of(0), key_of(1), key_of(2)], "arena rows out of generation order")

    q_np = queries.cpu().numpy()
    filt_q = q_np[:64]
    floor_q = q_np[64:80]
    # ---- the main path, counted -----------------------------------------
    slot_scan.LAUNCHES = 0
    batch_hits = searcher.search(VectorSearchRequest(vectors=q_np, top_k=TOP_K))
    single_hits = searcher.search(VectorSearchRequest(vectors=q_np[0], top_k=TOP_K))
    filt_hits = searcher.search(
        VectorSearchRequest(vectors=filt_q, top_k=TOP_K, filter=LabelAtom("/l/tenth"))
    )
    floor_hits = searcher.search(VectorSearchRequest(vectors=floor_q, top_k=TOP_K, min_score=0.9))
    launches = slot_scan.LAUNCHES
    # ----------------------------------------------------------------------
    check(launches >= 4, f"slot-scan kernel launched {launches} times on the main path")

    check(len(batch_hits) == BATCH and all(len(h) == TOP_K for h in batch_hits), "batch result shape")
    scores = np.array([[h.score for h in row] for row in batch_hits])
    check(bool(np.isfinite(scores).all()) and bool((np.diff(scores, axis=1) <= 0).all()), "batch scores")
    alive = torch.from_numpy(idx.alive).to("cuda")
    oracle = exact_oracle(torch, vecs, alive, queries[:ORACLE_QUERIES], TOP_K)
    recall = float(np.mean([
        len({h.key for h in batch_hits[r]} & {key_of(i) for i in oracle[r]}) / TOP_K
        for r in range(ORACLE_QUERIES)
    ]))
    check(recall >= RECALL_BAR, f"recall@10 {recall} < {RECALL_BAR}")

    check(len(single_hits) == 1 and len(single_hits[0]) == TOP_K, "single query result")
    all_keys = [h.key for row in batch_hits + single_hits + filt_hits + floor_hits for h in row]
    check(not any(k.startswith(DELETED) for k in all_keys), "a deleted key came back")
    flat_filt = [h for row in filt_hits for h in row]
    check(len(flat_filt) == 64 * TOP_K, "filtered result shape")
    check(all(h.key.split("/")[2] == "0" and "/l/tenth" in h.labels for h in flat_filt),
          "an unlabelled paragraph passed the label filter")
    unfloored = searcher.search(VectorSearchRequest(vectors=floor_q, top_k=TOP_K))
    for got, full in zip(floor_hits, unfloored):
        want = [h.key for h in full if h.score >= np.float32(0.9)]
        check([h.key for h in got] == want, "min_score cut differs from the floored full result")

    def one_batch():
        searcher.search(VectorSearchRequest(vectors=q_np, top_k=TOP_K))

    one_batch()
    times = []
    for _ in range(5):
        t = time.perf_counter()
        one_batch()
        times.append((time.perf_counter() - t) * 1e3)
    ms = float(np.median(times))
    print(
        f"slice: {N_ROWS}x{DIM} int8, p_pad {idx.p_pad}, {N_SEGMENTS} segments + 1 deletion; "
        f"gen {t_gen:.1f}s write {t_write:.1f}s open {t_open:.1f}s; "
        f"recall@10 {recall:.4f} on {ORACLE_QUERIES} queries; batch {BATCH} top-{TOP_K} "
        f"{ms:.2f} ms/batch (median of 5: {', '.join(f'{t:.2f}' for t in times)}), "
        f"{BATCH / ms * 1e3:.0f} QPS; slot-scan launches {launches}",
        flush=True,
    )
    return searcher, q_np, launches


def phase_breakdown(torch, searcher, q_np):
    """Device time of each layer of one 2048-query batch (CUDA events), and
    host time of the whole search with and without the facade. Every layer
    is timed through the index's own functions: ``candidates`` is
    ``_int8_candidates`` (quantise, slot scan, slot top-c), of which
    ``quantise`` and ``slot_scan`` are its first two calls;
    ``rerank_and_cut`` is ``_rerank_and_cut`` (gather-dot, dedup, cut), of
    which ``dedup`` is ``_duplicate_mask``."""
    from nucliadb_tpu_torch.index.vector import VectorSearchRequest
    from nucliadb_tpu_torch.index.vector import device as dv
    from nucliadb_tpu_torch.ops import quant, slot_scan

    idx = searcher.index
    q = torch.from_numpy(q_np).to("cuda")
    mask = idx.base_mask_device()
    budget = quant.int8_rerank_budget(TOP_K)
    floor = float(np.float32(-3.0e38))
    qc, _ = quant.quantize_rows(q)
    cand = dv._int8_candidates(idx.codes, q, budget, mask)
    vecs = idx.vectors[cand.long().clamp_min(0)]
    layers = {
        "quantise": lambda: quant.quantize_rows(q),
        "slot_scan": lambda: slot_scan.int8_scan_slots_resident2(qc, idx.codes.codes, idx.codes.scale, mask),
        "candidates": lambda: dv._int8_candidates(idx.codes, q, budget, mask),
        "dedup": lambda: dv._duplicate_mask(vecs, cand >= 0),
        "rerank_and_cut": lambda: dv._rerank_and_cut(idx.vectors, q, cand, floor, TOP_K, dedup=True),
        "whole_search_int8": lambda: dv._search_int8(
            idx.codes, idx.vectors, q, mask, floor, TOP_K, "dot", True
        ),
    }
    out = {name: round(cuda_ms(fn, 5), 3) for name, fn in layers.items()}
    # host clock: the index's search (upload, device work, fetch) and the
    # facade around it (mask build, VectorHit objects)
    host = {
        "index_search": lambda: idx.search(q_np, TOP_K, with_duplicates=False),
        "searcher_search": lambda: searcher.search(VectorSearchRequest(vectors=q_np, top_k=TOP_K)),
    }
    for name, fn in host.items():
        times = []
        for _ in range(4):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        out[f"host_{name}"] = round(float(np.median(times[1:])), 3)
    print(f"breakdown (ms, batch {BATCH}): {json.dumps(out)}", flush=True)


def main() -> None:
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    from nucliadb_tpu_torch.ops import slot_scan
    from nucliadb_tpu_torch.utils import kernels

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"device: {name}, {count} visible, torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    t = time.perf_counter()
    lib = kernels.build("int8_slot_scan")
    kernels.load("int8_slot_scan")
    print(f"build: {lib.name} in {time.perf_counter() - t:.1f}s", flush=True)

    max_err, kernel_ms, plain_ms = phase_kernels(torch, slot_scan)
    print(
        f"kernel vs plain: bit-identical at {len(KERNEL_SHAPES)} shapes; at B,N,D,S={TIMED_SHAPE} "
        f"kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms",
        flush=True,
    )

    with tempfile.TemporaryDirectory() as tmp:
        searcher, q_np, launches = phase_slice(torch, slot_scan, tmp)
    phase_breakdown(torch, searcher, q_np)

    print(json.dumps({"kernels": [{
        "name": "int8_scan_slots_resident2",
        "route": "cuda",
        "source": "nucliadb_tpu_torch/csrc/int8_slot_scan.cu",
        "replaces": "nucliadb_tpu/ops/pallas_scan.py:350",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
