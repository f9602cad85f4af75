#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``nucliadb_tpu_torch``) on one card.

Run from the root of a checkout, on a machine with an NVIDIA card:

    python3 chip_smoke.py

It drives the port's vector-search paths, the semantic leg of /find, its
keyword leg, the index node and the product /find once at full size, in
phases that each print one line:

1. device: the card's name and power limit;
2. build: compiles every kernel of the paths from ``nucliadb_tpu_torch/csrc``,
   one nvcc per source, all started together, and prints the int8 kernel's
   ``-Xptxas -v`` report (registers and spills of each instantiation);
3. kernels vs plain versions, bit for bit (scores as int32 bits, and ids),
   on the card:
   - the top-2 int8 slot scan (``wgmma`` on the int8 tensor cores) over B
     in {8, 192, 2048}, N in {4096, 6144, 1048576}, D in {128, 768}, S in
     {128, 256};
   - its top-1 mode through ``int8_scan_slots`` and
     ``int8_scan_slots_resident`` over S in {256, 512, 1024}, B in {8, 192,
     2048} (1024 for the resident wrapper), N in {16384, 24576, 1048576},
     D in {128, 768};
   - both modes at the tiling's edge shapes: B in {1, 65, 2047}, D in {64,
     3072, 8192}, N = 65536, S = 32 (top-2) and 1024 (top-1);
   - the binary popcount slot scan over B in {8, 64}, N in {16384,
     1048576}, D in {128, 768}, S = 1024;
   all with an all-masked column range and planted ties (and, for int8,
   pair collisions); then each kernel and its plain version timed once
   with CUDA events after a warm-up, and ``torch._int_mm`` at the timed
   shape as a yardstick for the int8 product alone;
4. slices: a clustered 1,000,000 x 768 corpus made from a seed (1024
   centres, noise 0.35, rows L2-normalised, a label on every tenth
   paragraph) written once as 4 segments plus a deletion, and opened
   through ``VectorSearcher(..., device="cuda")`` three times (p_pad
   1,048,576), each searcher freed before the next:
   - int8: a batch of 2048 at top-10 with the default dedup, one single
     query, one label-filtered and one min_score request; the top-2 launch
     count must grow and the top-1 count must not;
   - int8 + ``pallas``: a batch of 2048, a filtered and a min_score
     request; the top-1 count must grow and the top-2 count must not;
   - binary + ``pallas``: 16 batches of 64 (the popcount kernel, which must
     launch at least 16 times), one batch of 256 (the route without the
     kernel: the count must not grow), a filtered and a min_score request.
   Every batch's recall@10 against an exact f32 oracle on its queries of
   the first 1024 must reach 0.95; filtered requests return only
   labelled, undeleted paragraphs; a min_score result is the floored full
   result;
5. breakdown, after each slice: its device time by layer and its host time;
6. keyword: bench_suite.py config 3's corpus (its 20,007-word vocabulary,
   24 zipf(1.3) tokens a paragraph, 2 % of paragraphs starting "quick brown
   fox", a ``created`` column, a label on every tenth paragraph) at
   1,000,000 paragraphs of 100,000 resources, written by the port's builder
   as segments of 326,000 x 3 and 22,000 plus a deleted resource, and a
   document index of the same resources. Through
   ``ParagraphSearcher(..., device="cuda")`` and ``TextSearcher``:
   - the device route (the host WAND tier off), counted: bench_suite.py's
     512 OR fuzzy queries and 512 AND queries through ``search_batch``, one
     ``search`` with the matched bitmap, label-filtered, key-prefix,
     excluded-term and ``min_score`` requests, a quoted phrase and an
     ``advanced_query`` request, 64 requests from 8 threads (which must
     share the coalescer's dispatches) and 16 document requests (one
     ordered by ``created``); every call must dispatch the device program
     (``ops.bm25.DISPATCHES``);
   - checks: a float64 NumPy BM25 oracle with the engine's own plan and
     mask (64 queries of each batch and every single request: ids equal up
     to ties, scores within 1e-5, exact matched counts), each batch run
     twice with identical bits, no deleted or filtered-out paragraph;
   - the default route: the OR batch on the host WAND tier (when
     ``nucliadb_tpu_native`` loads: no dispatch, the device's answers up to
     ties), and a batch of high-df AND pairs the cost model sends to the
     device;
   - a breakdown of the device program by stage (CUDA events) with the
     scatter's deterministic and atomic forms, host planning and hits, and
     whole batches on both routes;
   - a refresh adding 2,000 paragraphs: 3 groups reused, under a tenth of
     the first build's upload, answers bit-identical to a fresh build.
7. node: the index node end to end, ``EmbeddedNode(tmp, device="cuda")``
   with one shard of vectorset ``m`` (768-d, dot, int8): 1,000 resources of
   200 paragraphs (200,000, one target segment of the vector merge policy),
   made from ``SEED`` (paragraph text from config 3's vocabulary, clustered
   vectors, a label on every tenth paragraph, a title, a JSON field, three
   relations, the access group "restricted" on every seventh resource, one
   resource indexed hidden), each through ``node.index``; merge rounds until
   no job is left (a vector and a paragraph merge), then the sync, each
   timed. Then, counted: 64 hybrid requests (body + vector, top-20,
   paragraph and document legs) on the default keyword route and again on
   the device route (``NDBTPU_TEXT_HOST_TIER=0`` set before a second node
   over the same data directory opens its searcher): the top-2 kernel must
   launch for every vector leg and the BM25 program dispatch on the device
   route; vector recall@10 >= 0.95 against an exact f32 oracle over the
   alive, visible paragraphs; paragraph and document legs held to the
   float64 BM25 oracle. Then per-leg host times; 64 requests from 8 threads
   (fewer vector dispatches than requests, each answer its solo answer);
   the same 64 requests answered by a searcher on the CPU over the same
   segments (equal within 1e-4); label, security, JSON ("and", "or"),
   key-prefix, creation-date and min_score filters, a graph and a document
   request; a deletion, then a delta of 20 resources (the arena extended
   in place, the paragraph group reused, answers equal to a fresh
   searcher's).
8. find: the product ``/find`` in process, ``SearchService`` over
   ``KnowledgeBoxManager``, the ``Processor`` and the sqlite maindb, on an
   ``EmbeddedNode(tmp, device="cuda")``: one knowledge box with vectorset
   ``m`` (768-d, dot, int8) holding the node phase's 1,000 resources of 200
   paragraphs, each written through ``Processor.create_resource`` as an
   API payload (the paragraphs as one text field, an embedding per
   paragraph, labels of two labelsets, an access group on two resources in
   five); merge rounds, sync. Then, counted: 64 hybrid ``FindRequest``s
   (query + vector, top-20, rank fusion "rrf") on the default keyword route
   and again on the device route (``NDBTPU_TEXT_HOST_TIER=0`` before a
   second node opens): the top-2 kernel must launch for every vector leg;
   each paragraph leg equals the float64 BM25 oracle, the routes agree up
   to ties, 16 fused orders equal a plain RRF recomputed from their shard
   responses. Then 64 semantic-only requests (recall@10 >= 0.95 against the
   exact f32 oracle); 16 label-filtered and 16 security requests per route
   held to an oracle of the corpus's labels and groups (their paragraph
   legs to the masked BM25 oracle, their vector legs to the masked exact
   oracle); 16 requests through a ``SearchService`` over a node on the CPU
   (the same maindb and segments, equal within 1e-4); the /find p50 and
   p90 per route, the device's busy share, and 64 requests from 8 threads
   (each its solo answer) against the same 64 one after another.

It then prints the kernels' JSON line (each kernel's launches on its path
and on the node and /find phases' counted paths, times, bound from this
run's shapes and its share of it) and, last,
``{"ok": true, "device": {...}}``. Any failed check exits non-zero and
prints no result. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import re
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

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
TOP1_SHAPES = [
    (b, n, d, s)
    for d in (128, 768)
    for s in (256, 512, 1024)
    for n in (16384, 24576, 1048576)
    for b in (8, 192, 2048)
]
TOP1_TIMED = {  # (B, N, D, S) per wrapper
    "int8_scan_slots": (2048, 1048576, 768, 1024),
    "int8_scan_slots_resident": (1024, 1048576, 768, 512),
}
# edge shapes of the tensor-core tiling: ragged query tiles, the narrow slot
# group (S=32, W=32) and the widest slot table, D from one 64-byte chunk to
# the streamed query tile
EDGE_SHAPES = {
    keep: [(b, 65536, d, s) for d in (64, 3072, 8192) for b in (1, 65, 2047)]
    for keep, s in ((2, 32), (1, 1024))
}
BINARY_SHAPES = [(b, n, d, 1024) for d in (128, 768) for n in (16384, 1048576) for b in (8, 64)]
BINARY_TIMED = (64, 1048576, 768, 1024)
BINARY_BATCH = 64  # the largest bucketed batch the binary kernel's gate takes
SOURCES = ("int8_slot_scan", "binary_slot_scan")
# NVIDIA H100 SXM data sheet, dense: int8 tensor cores and HBM3
INT8_TOPS = 1979e12
HBM_BYTES_PER_S = 3.35e12
# __popc on the CUDA cores: 16 per clock per SM (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0) x 132
# SMs x 1.98 GHz boost
POPC_PER_S = 132 * 16 * 1.98e9


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


def same_table(torch, got, want) -> tuple[bool, float]:
    """(bit-identical scores and ids, max |score difference|)."""
    same = torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)) and torch.equal(
        got[1], want[1]
    )
    return same, float((got[0] - want[0]).abs().max())


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
                got = slot_scan.int8_scan_slots_resident2(*args, slots=s)
                want = slot_scan.int8_scan_slots_resident2_reference(*args, slots=s)
                torch.cuda.synchronize()
                same, err = same_table(torch, got, want)
                check(same, f"kernel != plain at B={b} N={n} D={d} S={s}")
                max_err = max(max_err, err)
            if (d, s) == TIMED_SHAPE[2:]:
                args = (q, codes, scale, mask)
                kernel_ms = cuda_ms(lambda: slot_scan.int8_scan_slots_resident2(*args, slots=s), 5)
                plain_ms = cuda_ms(
                    lambda: slot_scan.int8_scan_slots_resident2_reference(*args, slots=s), 3
                )
            del q, codes, scale, mask
    torch.cuda.empty_cache()
    return max_err, kernel_ms, plain_ms


def phase_top1_kernels(torch, slot_scan):
    """The top-1 mode through both of its wrappers against the plain
    version; returns {wrapper: (max_err, kernel_ms, plain_ms)}."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    out = {name: [0.0, None, None] for name in TOP1_TIMED}
    for d in (128, 768):
        for s in (256, 512, 1024):
            q, codes, scale, mask = kernel_inputs(gen, d, s, 1048576, 2048, "cuda")
            for name, timed in TOP1_TIMED.items():
                wrapper = getattr(slot_scan, name)
                max_b = slot_scan.RESIDENT_MAX_B if name == "int8_scan_slots_resident" else None
                for b, n, dd, ss in TOP1_SHAPES:
                    if (dd, ss) != (d, s):
                        continue
                    b = min(b, max_b or b)
                    args = (q[:b], codes[:n], scale[:n], mask[:n])
                    got = wrapper(*args, slots=s)
                    want = slot_scan.int8_scan_slots_top1_reference(*args, slots=s)
                    torch.cuda.synchronize()
                    same, err = same_table(torch, got, want)
                    check(same, f"{name} kernel != plain at B={b} N={n} D={d} S={s}")
                    out[name][0] = max(out[name][0], err)
                if (d, s) == timed[2:]:
                    b = timed[0]
                    args = (q[:b], codes, scale, mask)
                    out[name][1] = cuda_ms(lambda: wrapper(*args, slots=s), 5)
                    out[name][2] = cuda_ms(
                        lambda: slot_scan.int8_scan_slots_top1_reference(*args, slots=s), 3
                    )
            del q, codes, scale, mask
    torch.cuda.empty_cache()
    return {name: tuple(v) for name, v in out.items()}


def phase_edge_kernels(torch, slot_scan):
    """Both int8 modes at ``EDGE_SHAPES`` against the plain version, bit for
    bit (the top-1 mode through ``int8_scan_slots``); returns {keep: max_err}."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    wrappers = {2: slot_scan.int8_scan_slots_resident2, 1: slot_scan.int8_scan_slots}
    plain = {2: slot_scan.int8_scan_slots_resident2_reference, 1: slot_scan.int8_scan_slots_top1_reference}
    out = {}
    for keep, shapes in EDGE_SHAPES.items():
        out[keep] = 0.0
        for d in sorted({shape[2] for shape in shapes}):
            s = shapes[0][3]
            q, codes, scale, mask = kernel_inputs(gen, d, s, 65536, 2047, "cuda")
            for b, n, dd, ss in shapes:
                if dd != d:
                    continue
                args = (q[:b].contiguous(), codes[:n], scale[:n], mask[:n])
                got = wrappers[keep](*args, slots=s)
                want = plain[keep](*args, slots=s)
                torch.cuda.synchronize()
                same, err = same_table(torch, got, want)
                check(same, f"top-{keep} kernel != plain at edge shape B={b} N={n} D={d} S={s}")
                out[keep] = max(out[keep], err)
            del q, codes, scale, mask
    torch.cuda.empty_cache()
    return out


def int8_bound_ms(b: int, n: int, d: int, s: int, keep: int) -> tuple[float, str]:
    """The least time for a slot scan on an H100: 2*B*N*D int8 operations
    at the dense tensor-core peak, or its bytes (queries, codes, scales and
    mask read once, the [B, keep*S] scores and ids written once) at the HBM
    rate, whichever is larger."""
    ops_ms = 2 * b * n * d / INT8_TOPS * 1e3
    bytes_ms = (b * d + n * d + 5 * n + 8 * b * keep * s) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def binary_bound_ms(b: int, n: int, d: int, s: int) -> tuple[float, str]:
    """The popcount slot scan: B*N*(D/32)*4 AND+popcounts at the CUDA
    cores' __popc rate, or its bytes at the HBM rate."""
    w = d // 32
    ops_ms = b * n * w * 4 / POPC_PER_S * 1e3
    bytes_ms = (4 * b * 4 * w + 4 * 4 * b + 4 * w * n + 13 * n + 8 * b * s) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def product_library_ms(torch) -> float:
    """``torch._int_mm(q, codes.t())`` at ``TIMED_SHAPE``: the int8 product
    alone (an 8 GiB int32 matrix, no slot table). A yardstick for the
    product, not the same function; the port never calls it."""
    b, n, d, _ = TIMED_SHAPE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 4)
    q = torch.randint(-127, 128, (b, d), generator=gen, device="cuda", dtype=torch.int8)
    codes = torch.randint(-127, 128, (n, d), generator=gen, device="cuda", dtype=torch.int8)
    ms = cuda_ms(lambda: torch._int_mm(q, codes.t()), 3)
    del q, codes
    torch.cuda.empty_cache()
    return ms


def ptxas_report(kernels, name: str) -> list[str]:
    """One line per kernel of ``csrc/<name>.cu``: its template arguments,
    registers and spills, from the build's ``-Xptxas -v`` report."""
    labels = (
        (r"slot_scan_wgmmaILi(\d)ELi(\d+)ELb(\d)", "slot_scan_wgmma<KEEP={}, W={}, RESIDENT={}>"),
        (r"slot_table_mergeILi(\d)", "slot_table_merge<KEEP={}>"),
    )
    lines, label, spill = [], None, ""
    for line in kernels.library_path(name).with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            label = next(
                (fmt.format(*m.groups()) for pat, fmt in labels if (m := re.search(pat, entry))), entry[:60]
            )
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and label:
            lines.append(f"{label}: {line.split(':', 1)[1].strip()}; {spill}")
            label = None
    return lines


def binary_inputs(torch, quant, gen, d, n_max, b_max):
    """Random sign codes and query planes with their scalars, an all-masked
    range, and planted equal columns (ids 100, 100+S, 100+3S in one slot,
    101 in the next)."""
    w = d // 32

    def words(*shape):
        x = torch.randint(0, 2**32, shape, generator=gen, device="cuda", dtype=torch.int64)
        return (x - 2**31).to(torch.int32)

    def uniform(lo, hi, n):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device="cuda")

    codes_t = words(w, n_max)
    planes = words(b_max, quant.QUERY_BITS, w)
    scale, resid = uniform(0.02, 0.05, n_max), uniform(0.5, 1.0, n_max)
    popcnt = quant.popcount(codes_t).sum(0).float()
    mask = torch.rand(n_max, generator=gen, device="cuda") > 0.1
    mask[2048:4096] = False
    for pid in (100 + 1024, 100 + 3 * 1024, 101):
        codes_t[:, pid], scale[pid], resid[pid], popcnt[pid] = (
            codes_t[:, 100], scale[100], resid[100], popcnt[100]
        )
        mask[pid] = mask[100] = True
    qparams = (
        -uniform(0.1, 0.2, b_max), uniform(0.01, 0.03, b_max),
        torch.randn(b_max, generator=gen, device="cuda"), uniform(0.9, 1.1, b_max),
    )
    return planes, qparams, codes_t, (scale, popcnt, resid), mask


def phase_binary_kernel(torch, quant, binary_scan):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    max_err, kernel_ms, plain_ms = 0.0, None, None
    for d in (128, 768):
        planes, qparams, codes_t, cols, mask = binary_inputs(torch, quant, gen, d, 1048576, 64)
        for b, n, dd, s in BINARY_SHAPES:
            if dd != d:
                continue
            args = (
                planes[:b].contiguous(), *(t[:b].contiguous() for t in qparams),
                codes_t[:, :n].contiguous(), *(t[:n].contiguous() for t in cols),
                mask[:n].contiguous(),
            )
            got = binary_scan.binary_scan_slots(*args, dim=d, slots=s)
            want = binary_scan.binary_scan_slots_reference(*args, dim=d, slots=s)
            torch.cuda.synchronize()
            same, err = same_table(torch, got, want)
            check(same, f"binary kernel != plain at B={b} N={n} D={d} S={s}")
            check(int(got[1][0, 100]) not in (1124, 3172), "a planted tie did not keep its lowest id")
            max_err = max(max_err, err)
            if (b, n, d, s) == BINARY_TIMED:
                kernel_ms = cuda_ms(lambda: binary_scan.binary_scan_slots(*args, dim=d, slots=s), 5)
                plain_ms = cuda_ms(
                    lambda: binary_scan.binary_scan_slots_reference(*args, dim=d, slots=s), 2
                )
        del planes, qparams, codes_t, cols, mask
    torch.cuda.empty_cache()
    return max_err, kernel_ms, plain_ms


def make_corpus(torch, n, d, n_queries, device="cuda"):
    """bench.py's recipe on the card: rows and queries are a random centre
    plus 0.35 * N(0, 1) noise, L2-normalised. As in bench.py, each centre
    owns a contiguous block of rows: a layout striding clusters by a
    multiple of the slot count would put a whole cluster into one slot."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    centers = torch.randn(N_CENTERS, d, generator=gen, device=device)
    vecs = torch.empty((n, d), device=device)
    for lo in range(0, n, 131072):
        hi = min(n, lo + 131072)
        assign = torch.arange(lo, hi, device=device) * N_CENTERS // n
        block = centers[assign] + NOISE * torch.randn(hi - lo, d, generator=gen, device=device)
        vecs[lo:hi] = block / block.norm(dim=-1, keepdim=True)
    assign = torch.randint(0, N_CENTERS, (n_queries,), generator=gen, device=device)
    q = centers[assign] + NOISE * torch.randn(n_queries, d, generator=gen, device=device)
    return vecs, q / q.norm(dim=-1, keepdim=True)


def exact_oracle(torch, vecs, alive, q, k):
    """Exact f32 top-k ids over the alive rows, on their device in chunks."""
    dev = vecs.device
    best_s = torch.full((q.shape[0], k), -float("inf"), device=dev)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.long, device=dev)
    for lo in range(0, vecs.shape[0], 131072):
        s = q @ vecs[lo : lo + 131072].T
        s = torch.where(alive[lo : lo + 131072], s, -float("inf"))
        ids = torch.arange(lo, lo + s.shape[1], device=dev).expand_as(s)
        best_s, pos = torch.cat([best_s, s], 1).topk(k, dim=1)
        best_i = torch.gather(torch.cat([best_i, ids], 1), 1, pos)
    return best_i.cpu().numpy()


def recall_at_k(hits, oracle) -> float:
    return float(np.mean([
        len({h.key for h in hits[r]} & {key_of(i) for i in oracle[r]}) / TOP_K
        for r in range(len(hits))
    ]))


class Corpus:
    """The slices' shared state: the corpus on the card, its segments on
    disk, the queries and the exact oracle of the first 1024."""

    def __init__(self, torch, tmp):
        from nucliadb_tpu_torch.index.vector import (
            Elem, Seq, SimpleOpenIndex, VectorConfig, create_segment,
        )

        t0 = time.perf_counter()
        self.vecs, self.queries = make_corpus(torch, N_ROWS, DIM, BATCH)
        # the single query sits on a deleted paragraph: it must not come back
        self.deleted_row = int(DELETED[1:-1]) * 10 + 3
        self.queries[0] = self.vecs[self.deleted_row]
        host = self.vecs.cpu().numpy()
        self.t_gen = time.perf_counter() - t0

        cfg = VectorConfig(dimension=DIM)
        segs, per = [], N_ROWS // N_SEGMENTS
        for s in range(N_SEGMENTS):
            elems = [
                Elem(key=key_of(i), vectors=host[i], labels=["/l/tenth"] if i % 10 == 0 else [])
                for i in range(s * per, (s + 1) * per)
            ]
            segs.append((create_segment(f"{tmp}/s{s}", elems, cfg), Seq(s + 1)))
        self.open_index = SimpleOpenIndex(
            segment_list=segs, deletion_list=[(DELETED, Seq(N_SEGMENTS + 1))]
        )
        self.t_write = time.perf_counter() - t0 - self.t_gen
        self.q_np = self.queries.cpu().numpy()
        self.oracle = None

    def searcher(self, torch, cfg):
        from nucliadb_tpu_torch.index.vector import VectorSearcher

        t = time.perf_counter()
        searcher = VectorSearcher(cfg, self.open_index, device="cuda")
        torch.cuda.synchronize()
        idx = searcher.index
        check(idx.p_pad == 1048576 and idx.codes is not None, f"p_pad {idx.p_pad}, codes {idx.codes is not None}")
        check(idx.keys[:3] == [key_of(0), key_of(1), key_of(2)], "arena rows out of generation order")
        if self.oracle is None:
            alive = torch.from_numpy(idx.alive).to("cuda")
            self.oracle = exact_oracle(torch, self.vecs, alive, self.queries[:ORACLE_QUERIES], TOP_K)
        return searcher, time.perf_counter() - t

    def free(self, torch):
        del self.vecs, self.queries
        torch.cuda.empty_cache()


def check_batch(hits, n, what) -> None:
    check(len(hits) == n and all(len(h) == TOP_K for h in hits), f"{what}: result shape")
    scores = np.array([[h.score for h in row] for row in hits])
    check(bool(np.isfinite(scores).all()) and bool((np.diff(scores, axis=1) <= 0).all()), f"{what}: scores")
    check(not any(h.key.startswith(DELETED) for row in hits for h in row), f"{what}: a deleted key came back")


def check_filter_and_floor(searcher, filt_hits, floor_hits, floor_q, what) -> None:
    from nucliadb_tpu_torch.index.vector import VectorSearchRequest

    flat_filt = [h for row in filt_hits for h in row]
    check(len(flat_filt) == 64 * TOP_K, f"{what}: filtered result shape")
    check(all(h.key.split("/")[2] == "0" and "/l/tenth" in h.labels for h in flat_filt),
          f"{what}: an unlabelled paragraph passed the label filter")
    check(not any(h.key.startswith(DELETED) for h in flat_filt), f"{what}: a deleted key came back")
    unfloored = searcher.search(VectorSearchRequest(vectors=floor_q, top_k=TOP_K))
    for got, full in zip(floor_hits, unfloored):
        want = [h.key for h in full if h.score >= np.float32(0.9)]
        check([h.key for h in got] == want, f"{what}: min_score cut differs from the floored full result")


def median_ms(fn, reps: int = 5) -> tuple[float, list[float]]:
    fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times)), times


def reset_launches(*modules) -> None:
    for mod in modules:
        mod.LAUNCHES.clear()


def phase_slice(torch, slot_scan, binary_scan, corpus):
    from nucliadb_tpu_torch.index.vector import LabelAtom, Quantization, Similarity, VectorConfig, VectorSearchRequest

    cfg = VectorConfig(dimension=DIM, similarity=Similarity.DOT, quantization=Quantization.INT8)
    searcher, t_open = corpus.searcher(torch, cfg)
    q_np = corpus.q_np
    filt_q = q_np[:64]
    floor_q = q_np[64:80]
    # ---- the main path, counted -----------------------------------------
    reset_launches(slot_scan, binary_scan)
    batch_hits = searcher.search(VectorSearchRequest(vectors=q_np, top_k=TOP_K))
    single_hits = searcher.search(VectorSearchRequest(vectors=q_np[0], top_k=TOP_K))
    filt_hits = searcher.search(
        VectorSearchRequest(vectors=filt_q, top_k=TOP_K, filter=LabelAtom("/l/tenth"))
    )
    floor_hits = searcher.search(VectorSearchRequest(vectors=floor_q, top_k=TOP_K, min_score=0.9))
    launches = dict(slot_scan.LAUNCHES, **binary_scan.LAUNCHES)
    # ----------------------------------------------------------------------
    check(launches.get("top2", 0) >= 4, f"top-2 slot-scan kernel launched {launches} on the int8 path")
    check(launches.get("top1", 0) == 0 and launches.get("binary", 0) == 0, f"int8 path launched {launches}")

    check_batch(batch_hits, BATCH, "int8")
    recall = recall_at_k(batch_hits[:ORACLE_QUERIES], corpus.oracle)
    check(recall >= RECALL_BAR, f"int8 recall@10 {recall} < {RECALL_BAR}")
    check(len(single_hits) == 1 and len(single_hits[0]) == TOP_K, "single query result")
    check(not any(h.key.startswith(DELETED) for row in single_hits for h in row), "a deleted key came back")
    check_filter_and_floor(searcher, filt_hits, floor_hits, floor_q, "int8")

    ms, times = median_ms(lambda: searcher.search(VectorSearchRequest(vectors=q_np, top_k=TOP_K)))
    print(
        f"slice int8: {N_ROWS}x{DIM}, p_pad {searcher.index.p_pad}, {N_SEGMENTS} segments + 1 deletion; "
        f"gen {corpus.t_gen:.1f}s write {corpus.t_write:.1f}s open {t_open:.1f}s; "
        f"recall@10 {recall:.4f} on {ORACLE_QUERIES} queries; batch {BATCH} top-{TOP_K} "
        f"{ms:.2f} ms/batch (median of 5: {', '.join(f'{t:.2f}' for t in times)}), "
        f"{BATCH / ms * 1e3:.0f} QPS; launches {launches}",
        flush=True,
    )
    return searcher, launches["top2"]


def phase_int8_pallas_slice(torch, slot_scan, binary_scan, corpus):
    from nucliadb_tpu_torch.index.vector import LabelAtom, Quantization, VectorConfig, VectorSearchRequest

    cfg = VectorConfig(dimension=DIM, quantization=Quantization.INT8, flags=["pallas"])
    searcher, t_open = corpus.searcher(torch, cfg)
    q_np = corpus.q_np
    # ---- the main path, counted -----------------------------------------
    reset_launches(slot_scan, binary_scan)
    batch_hits = searcher.search(VectorSearchRequest(vectors=q_np, top_k=TOP_K))
    filt_hits = searcher.search(
        VectorSearchRequest(vectors=q_np[:64], top_k=TOP_K, filter=LabelAtom("/l/tenth"))
    )
    floor_hits = searcher.search(VectorSearchRequest(vectors=q_np[64:80], top_k=TOP_K, min_score=0.9))
    launches = dict(slot_scan.LAUNCHES, **binary_scan.LAUNCHES)
    # ----------------------------------------------------------------------
    check(launches.get("top1", 0) >= 3, f"top-1 slot-scan kernel launched {launches} on the pallas path")
    check(launches.get("top2", 0) == 0 and launches.get("binary", 0) == 0, f"pallas path launched {launches}")
    check_batch(batch_hits, BATCH, "int8 + pallas")
    recall = recall_at_k(batch_hits[:ORACLE_QUERIES], corpus.oracle)
    check(recall >= RECALL_BAR, f"int8 + pallas recall@10 {recall} < {RECALL_BAR}")
    check_filter_and_floor(searcher, filt_hits, floor_hits, q_np[64:80], "int8 + pallas")
    ms, times = median_ms(lambda: searcher.search(VectorSearchRequest(vectors=q_np, top_k=TOP_K)))
    print(
        f"slice int8 + pallas: open {t_open:.1f}s; recall@10 {recall:.4f} on {ORACLE_QUERIES} queries; "
        f"batch {BATCH} top-{TOP_K} {ms:.2f} ms/batch (median of 5: {', '.join(f'{t:.2f}' for t in times)}), "
        f"{BATCH / ms * 1e3:.0f} QPS; launches {launches}",
        flush=True,
    )
    return searcher, launches["top1"]


def phase_binary_slice(torch, slot_scan, binary_scan, corpus):
    from nucliadb_tpu_torch.index.vector import LabelAtom, Quantization, VectorConfig, VectorSearchRequest

    cfg = VectorConfig(dimension=DIM, quantization=Quantization.BINARY, flags=["pallas"])
    searcher, t_open = corpus.searcher(torch, cfg)
    q_np = corpus.q_np
    big = 256
    # ---- the main path, counted -----------------------------------------
    reset_launches(slot_scan, binary_scan)
    batches = [
        searcher.search(VectorSearchRequest(vectors=q_np[lo : lo + BINARY_BATCH], top_k=TOP_K))
        for lo in range(0, ORACLE_QUERIES, BINARY_BATCH)
    ]
    before_big = binary_scan.LAUNCHES["binary"]
    big_hits = searcher.search(VectorSearchRequest(vectors=q_np[:big], top_k=TOP_K))
    big_launches = binary_scan.LAUNCHES["binary"] - before_big
    filt_hits = searcher.search(
        VectorSearchRequest(vectors=q_np[:64], top_k=TOP_K, filter=LabelAtom("/l/tenth"))
    )
    floor_hits = searcher.search(VectorSearchRequest(vectors=q_np[64:80], top_k=TOP_K, min_score=0.9))
    launches = dict(slot_scan.LAUNCHES, **binary_scan.LAUNCHES)
    # ----------------------------------------------------------------------
    n_batches = ORACLE_QUERIES // BINARY_BATCH
    check(launches.get("binary", 0) >= n_batches, f"binary kernel launched {launches} for {n_batches} batches")
    check(big_launches == 0, f"the batch of {big} launched the binary kernel {big_launches} times")
    check(launches.get("top1", 0) == 0 and launches.get("top2", 0) == 0, f"binary path launched {launches}")
    hits = [row for batch in batches for row in batch]
    check_batch(hits, ORACLE_QUERIES, "binary + pallas")
    check_batch(big_hits, big, "binary, batch 256")
    recall = recall_at_k(hits, corpus.oracle)
    recall_big = recall_at_k(big_hits, corpus.oracle[:big])
    check(recall >= RECALL_BAR, f"binary + pallas recall@10 {recall} < {RECALL_BAR}")
    check(recall_big >= RECALL_BAR, f"binary batch-{big} recall@10 {recall_big} < {RECALL_BAR}")
    check_filter_and_floor(searcher, filt_hits, floor_hits, q_np[64:80], "binary + pallas")
    ms, times = median_ms(
        lambda: searcher.search(VectorSearchRequest(vectors=q_np[:BINARY_BATCH], top_k=TOP_K))
    )
    ms_big, _ = median_ms(lambda: searcher.search(VectorSearchRequest(vectors=q_np[:big], top_k=TOP_K)), 2)
    print(
        f"slice binary + pallas: open {t_open:.1f}s; recall@10 {recall:.4f} over {n_batches} batches of "
        f"{BINARY_BATCH} (kernel), {recall_big:.4f} for one batch of {big} (no kernel); batch {BINARY_BATCH} "
        f"{ms:.2f} ms (median of 5: {', '.join(f'{t:.2f}' for t in times)}), {BINARY_BATCH / ms * 1e3:.0f} QPS; "
        f"batch {big} {ms_big:.2f} ms; launches {launches}",
        flush=True,
    )
    return searcher, launches["binary"]


def breakdown(torch, name, searcher, q_np, layers, reps=5):
    """Device time of each layer (CUDA events, mean of ``reps`` after a
    warm-up), and host time of the index's search and of the facade's
    (median of 3 after one)."""
    from nucliadb_tpu_torch.index.vector import VectorSearchRequest

    out = {layer: round(cuda_ms(fn, reps), 3) for layer, fn in layers.items()}
    host = {
        "index_search": lambda: searcher.index.search(q_np, TOP_K, with_duplicates=False),
        "searcher_search": lambda: searcher.search(VectorSearchRequest(vectors=q_np, top_k=TOP_K)),
    }
    for layer, fn in host.items():
        times = []
        for _ in range(4):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        out[f"host_{layer}"] = round(float(np.median(times[1:])), 3)
    print(f"breakdown {name} (ms, batch {q_np.shape[0]}): {json.dumps(out)}", flush=True)


def phase_breakdown(torch, searcher, q_np):
    """The int8 route: ``candidates`` is ``_int8_candidates`` (quantise,
    slot scan, slot top-c), of which ``quantise`` and ``slot_scan`` are its
    first two calls; ``rerank_and_cut`` is ``_rerank_and_cut`` (gather-dot,
    dedup, cut), of which ``dedup`` is ``_duplicate_mask``."""
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
    breakdown(torch, "int8", searcher, q_np, {
        "quantise": lambda: quant.quantize_rows(q),
        "slot_scan": lambda: slot_scan.int8_scan_slots_resident2(qc, idx.codes.codes, idx.codes.scale, mask),
        "candidates": lambda: dv._int8_candidates(idx.codes, q, budget, mask),
        "dedup": lambda: dv._duplicate_mask(vecs, cand >= 0),
        "rerank_and_cut": lambda: dv._rerank_and_cut(idx.vectors, q, cand, floor, TOP_K, dedup=True),
        "whole_search_int8": lambda: dv._search_int8(
            idx.codes, idx.vectors, q, mask, floor, TOP_K, "dot", True
        ),
    })


def phase_int8_pallas_breakdown(torch, searcher, q_np):
    """``candidates`` is ``_int8_pallas_candidates`` (quantise, top-1 slot
    scan, slot top-c)."""
    from nucliadb_tpu_torch.index.vector import device as dv
    from nucliadb_tpu_torch.ops import quant, slot_scan

    idx = searcher.index
    q = torch.from_numpy(q_np).to("cuda")
    mask = idx.base_mask_device()
    budget = quant.int8_rerank_budget(TOP_K)
    floor = float(np.float32(-3.0e38))
    qc, _ = quant.quantize_rows(q)
    cand = dv._int8_pallas_candidates(idx.codes, q, budget, mask)
    breakdown(torch, "int8 + pallas", searcher, q_np, {
        "quantise": lambda: quant.quantize_rows(q),
        "slot_scan": lambda: slot_scan.int8_scan_slots(qc, idx.codes.codes, idx.codes.scale, mask),
        "candidates": lambda: dv._int8_pallas_candidates(idx.codes, q, budget, mask),
        "rerank_and_cut": lambda: dv._rerank_and_cut(idx.vectors, q, cand, floor, TOP_K, dedup=True),
        "whole_search_int8_pallas": lambda: dv._search_int8_pallas(
            idx.codes, idx.vectors, q, mask, floor, TOP_K, "dot", True
        ),
    })


def phase_binary_breakdown(torch, searcher, q_np):
    """``planes`` is ``binary_query_params``; ``candidates`` is
    ``_binary_pallas_candidates`` (planes, popcount slot scan, slot top-c
    of 1000); ``whole_search_binary_b256`` is the route without the kernel
    on a batch of 256 (one run after a warm-up)."""
    from nucliadb_tpu_torch.index.vector import device as dv
    from nucliadb_tpu_torch.ops import binary_scan, quant

    idx = searcher.index
    codes = idx.codes
    q = torch.from_numpy(q_np[:BINARY_BATCH]).to("cuda")
    q_big = torch.from_numpy(q_np[:256]).to("cuda")
    mask = idx.base_mask_device()
    budget = quant.binary_rerank_budget(TOP_K)
    floor = float(np.float32(-3.0e38))
    params = quant.binary_query_params(q)
    cand = dv._binary_pallas_candidates(codes, q, budget, mask)
    cols = (codes.codes_t, codes.scale, codes.popcnt, codes.resid, mask)
    breakdown(torch, "binary + pallas", searcher, q_np[:BINARY_BATCH], {
        "planes": lambda: quant.binary_query_params(q),
        "slot_scan": lambda: binary_scan.binary_scan_slots(*params, *cols, dim=codes.dim),
        "candidates": lambda: dv._binary_pallas_candidates(codes, q, budget, mask),
        "rerank_and_cut": lambda: dv._rerank_and_cut(idx.vectors, q, cand, floor, TOP_K, dedup=True),
        "whole_search_binary_pallas": lambda: dv._search_binary_pallas(
            codes, idx.vectors, q, mask, floor, TOP_K, "dot", True
        ),
    })
    b256 = cuda_ms(lambda: dv._search_binary(codes, idx.vectors, q_big, mask, floor, TOP_K, "dot", True), 1)
    print(f"breakdown binary, no kernel (ms, batch 256): {json.dumps({'whole_search_binary_b256': round(b256, 3)})}",
          flush=True)


# ---------------------------------------------------------------------------
# the keyword leg: BM25 over 1,000,000 paragraphs (bench_suite.py config 3)
# ---------------------------------------------------------------------------

KW_FULL = {
    "resources": 100_000,  # 10 paragraphs each
    "segments": (326_000, 326_000, 326_000, 22_000),  # 3 full-width groups + the fresh group
    "refresh": 2_000,  # paragraphs appended by the refresh
    "batch": 512,  # the coalescer's cap
    "oracle": 64,  # queries of each batch held to the float64 oracle
    "threads": 8,
    "threaded": 64,  # unfiltered requests through ParagraphSearcher.search from the threads
    "doc_requests": 16,  # TextSearcher.search requests
    "heavy_and": 64,  # AND queries of high-df pairs for the default route
}
KW_TOP_K = 20
KW_RTOL = 1e-5


def kw_vocab() -> list[str]:
    """bench_suite.py's vocabulary: 20,000 random letter strings
    (default_rng(7)) and the seven words the queries plant."""
    rng = np.random.default_rng(7)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    seen = {"quick", "brown", "fox", "lazy", "dog", "search", "database"}
    out = []
    while len(out) < 20_000:
        w = "".join(letters[rng.integers(0, 26, int(rng.integers(5, 10)))])
        if w not in seen:
            seen.add(w)
            out.append(w)
    return out + ["quick", "brown", "fox", "lazy", "dog", "search", "database"]


def kw_texts(words, n, seed):
    """bench_suite.py config 3's paragraphs: 24 zipf(1.3) token ids each, 2 %
    of them starting "quick brown fox". Returns (texts, the zipf ids)."""
    rng = np.random.default_rng(seed)
    zipf = np.minimum(rng.zipf(1.3, size=(n, 24)) - 1, len(words) - 8)
    hot = rng.random(n) < 0.02
    ids = zipf.copy()
    ids[hot, :3] = [words.index("quick"), words.index("brown"), words.index("fox")]
    vocab = np.asarray(words, dtype=object)
    return [" ".join(row) for row in vocab[ids].tolist()], zipf


class KwCorpus:
    """The keyword corpus on disk: paragraph segments (plus the refresh
    segment), the document index of the same resources, and the queries."""

    def __init__(self, tmp, cfg):
        from nucliadb_tpu_torch.index.text_engine import TextQuery
        from nucliadb_tpu_torch.index.text_engine.builder import DocEntry, build_segment
        from nucliadb_tpu_torch.index.vector import Seq, SimpleOpenIndex

        t0 = time.perf_counter()
        self.words = words = kw_vocab()
        n = self.n = cfg["resources"] * 10
        if sum(cfg["segments"]) != n:
            raise ValueError(f"segments {cfg['segments']} do not add up to {n} paragraphs")
        texts, zipf = kw_texts(words, n, 11)
        ref_texts, _ = kw_texts(words, cfg["refresh"], 12)
        self.t_gen = time.perf_counter() - t0

        def para(i, text):
            facets = ["/t/t", "/l/tenth"] if i % 10 == 0 else ["/t/t"]
            return DocEntry(key=key_of(i), text=text, facets=facets, columns={"created": i})

        segs, lo = [], 0
        for s, size in enumerate(cfg["segments"]):
            docs = [para(i, texts[i]) for i in range(lo, lo + size)]
            segs.append((build_segment(f"{tmp}/kw{s}", docs, kind="paragraph"), Seq(s + 1)))
            lo += size
        refresh = build_segment(
            f"{tmp}/kw_refresh", [para(n + i, t) for i, t in enumerate(ref_texts)], kind="paragraph"
        )
        dels = [(DELETED, Seq(len(segs) + 2))]
        self.first = SimpleOpenIndex(segment_list=segs, deletion_list=dels)
        self.second = SimpleOpenIndex(segment_list=segs + [(refresh, Seq(len(segs) + 1))], deletion_list=dels)
        self.t_para = time.perf_counter() - t0 - self.t_gen
        docs = [
            DocEntry(
                key=f"r{r:06d}/t/text", text=" ".join(texts[r * 10 : r * 10 + 10]),
                facets=["/l/tenth"] if r % 10 == 0 else [], columns={"created": r, "modified": r},
            )
            for r in range(cfg["resources"])
        ]
        text_seg = build_segment(f"{tmp}/kw_docs", docs, kind="text", store_text=True)
        self.documents = SimpleOpenIndex(segment_list=[(text_seg, Seq(1))], deletion_list=dels)
        self.t_docs = time.perf_counter() - t0 - self.t_gen - self.t_para
        del texts, docs

        # bench_suite.py's OR batch (two of the first 2,000 words and a typo,
        # fuzzy d=1) and AND batch (the first two tokens of a random paragraph)
        rng_q = np.random.default_rng(23)
        self.or_q = []
        for i in range(cfg["batch"]):
            t1, t2 = words[int(rng_q.integers(0, 2000))], words[int(rng_q.integers(0, 2000))]
            typo = "quikc" if i % 2 else "borwn"
            self.or_q.append(TextQuery(text=f"{t1} {t2} {typo}", top_k=KW_TOP_K, fuzzy=True))
        rng_a = np.random.default_rng(31)
        self.and_q = []
        for i in range(cfg["batch"]):
            toks = [words[j] for j in zipf[int(rng_a.integers(0, n))][:2]]
            self.and_q.append(
                TextQuery(text=f"{toks[0]} {toks[1]}", top_k=KW_TOP_K, fuzzy=bool(i % 2), all_terms=True)
            )
        # pairs of the most frequent words: far above the host tier's AND cap
        self.heavy_and = [
            TextQuery(text=f"{words[a]} {words[b]}", top_k=KW_TOP_K, all_terms=True)
            for a in range(1, 9) for b in range(a + 1, 10)
        ][: cfg["heavy_and"]]


class KwOracle:
    """Float64 NumPy BM25 from the segments' postings, with the engine's own
    plan (terms, weights, ``required``) and mask. Paragraphs hold 24 tokens,
    so no tf reaches the dense columns' clip at 255."""

    def __init__(self, engine):
        self.engine = engine
        self.dl = np.concatenate([np.maximum(np.asarray(s.dlen), 1) for s in engine.segments]).astype(np.float64)
        self._postings = {}

    def postings(self, term):
        import bisect

        hit = self._postings.get(term)
        if hit is None:
            docs, tfs = [], []
            for seg, (lo, _hi) in zip(self.engine.segments, self.engine.seg_bounds):
                ti = bisect.bisect_left(seg.terms, term)
                if ti < len(seg.terms) and seg.terms[ti] == term:
                    a, b = int(seg.postings_offsets[ti]), int(seg.postings_offsets[ti + 1])
                    docs.append(np.asarray(seg.postings_docs[a:b], np.int64) + lo)
                    tfs.append(np.asarray(seg.postings_tfs[a:b], np.float64))
            hit = self._postings[term] = (
                np.concatenate(docs) if docs else np.zeros(0, np.int64),
                np.concatenate(tfs) if tfs else np.zeros(0),
            )
        return hit

    def run(self, q, mask=None):
        """(top ids, their scores, matched count, matched bitmap, all scores)."""
        from nucliadb_tpu_torch.index.text_engine.engine import IMPOSSIBLE_REQUIRED

        e = self.engine
        n = e.n_docs
        if mask is None:
            mask = e.build_mask(q)[:n]
        terms, required = e._plan_terms(q)
        s = np.zeros(n)
        cnt = np.zeros(n, np.int32)
        n_sched = 0
        for term, weight in terms:
            df = e.term_df(term)
            if df == 0:
                continue
            n_sched += 1
            d, tf = self.postings(term)
            w = weight * e.idf(df)
            s[d] += w * tf * 2.2 / (tf + 1.2 * (0.25 + 0.75 * self.dl[d] / e.avgdl))
            cnt[d] += 1
        req = IMPOSSIBLE_REQUIRED if required >= IMPOSSIBLE_REQUIRED else max(min(required, n_sched), 1)
        matched = (cnt >= req) & mask
        ok = matched if q.min_score is None else matched & (s >= float(np.float32(q.min_score)))
        idx = np.flatnonzero(ok)
        if len(idx) > q.top_k:
            thr = np.partition(s[idx], len(idx) - q.top_k)[len(idx) - q.top_k]
            idx = idx[s[idx] >= thr]
        idx = idx[np.lexsort((idx, -s[idx]))][: q.top_k]
        if q.all_terms and q.fuzzy and q.text.strip():
            idx = np.array([d for d in idx if e.verify_all_terms(int(d), q)], np.int64)
        return idx, s[idx], int(matched.sum()), matched, s


def kw_check_hits(oracle, q, hits, matched, what, mask=None):
    """The device's (or the tier's) answer against the oracle: the same
    number of hits, each rank's score within KW_RTOL of the oracle's, every
    returned paragraph matched and scored as that rank (ids equal up to
    ties), and the exact matched count or bitmap."""
    o_ids, o_s, o_count, o_matched, s_full = oracle.run(q, mask)
    check(len(hits) == len(o_ids), f"{what}: {len(hits)} hits, oracle {len(o_ids)}")
    got = np.array([h.doc_id for h in hits], np.int64)
    got_s = np.array([h.score for h in hits])
    tol = KW_RTOL * np.abs(o_s) + 1e-6
    check(bool(np.all(np.abs(got_s - o_s) <= tol)), f"{what}: scores differ from the oracle")
    check(len(set(got.tolist())) == len(got) and bool(o_matched[got].all()), f"{what}: an unmatched or repeated id")
    check(bool(np.all(np.abs(s_full[got] - o_s) <= tol)), f"{what}: an id outside the oracle's ties")
    if isinstance(matched, np.ndarray):
        check(bool(np.array_equal(matched, o_matched)), f"{what}: matched bitmap differs")
    elif matched.sum() >= 0:
        check(matched.sum() == o_count, f"{what}: matched count {matched.sum()} != {o_count}")
    return o_s


def kw_same(a, b, what):
    """Two answers of one query equal up to ties: scores rank by rank within
    KW_RTOL, and the same ids above the tie band at the cut."""
    check(len(a) == len(b), f"{what}: {len(a)} vs {len(b)} hits")
    if not a:
        return
    sa, sb = np.array([h.score for h in a]), np.array([h.score for h in b])
    check(bool(np.all(np.abs(sa - sb) <= KW_RTOL * np.abs(sa) + 1e-6)), f"{what}: scores differ")
    band = sa[-1] * (1 + KW_RTOL) + 1e-6
    check({h.doc_id for h in a if h.score > band} == {h.doc_id for h in b if h.score > band}, f"{what}: ids differ")


def kw_bits(results):
    return [[(h.doc_id, h.score, h.term_count) for h in hits] for hits, _ in results]


def kw_dispatched(bm25, fn, what):
    """Runs ``fn`` and checks the device program was dispatched for it."""
    before = bm25.DISPATCHES.total()
    out = fn()
    check(bm25.DISPATCHES.total() > before, f"{what}: the device program was not dispatched")
    return out


def phase_keyword(torch, tmp, cfg, device="cuda"):
    """The keyword leg on ``device`` (see the module docstring); prints one
    line per part and returns the device-program dispatches of the counted
    main path."""
    import threading

    from nucliadb_tpu_torch.index.paragraph import ParagraphSearcher, ParagraphSearchRequest, advanced_query_mask
    from nucliadb_tpu_torch.index.text import DocumentSearchRequest, TextSearcher
    from nucliadb_tpu_torch.index.text_engine import engine as engine_mod
    from nucliadb_tpu_torch.index.text_engine import host_tier
    from nucliadb_tpu_torch.index.text_engine.batcher import coalescer
    from nucliadb_tpu_torch.index.text_engine.engine import TextQuery
    from nucliadb_tpu_torch.index.text_engine.tokenizer import tokenize
    from nucliadb_tpu_torch.index.vector import LabelAtom
    from nucliadb_tpu_torch.ops import bm25

    corpus = KwCorpus(tmp, cfg)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    up0, t = engine_mod.UPLOAD_BYTES, time.perf_counter()
    para = ParagraphSearcher(corpus.first, device=device)
    sync()
    t_open, first_upload = time.perf_counter() - t, engine_mod.UPLOAD_BYTES - up0
    engine = para.engine
    mem = torch.cuda.memory_allocated() if device == "cuda" else 0
    check(engine.n_docs == corpus.n and len(engine.groups) == len(cfg["segments"]), f"{len(engine.groups)} groups")
    check(engine.keys[:2] == [key_of(0), key_of(1)], "paragraph ids out of generation order")
    docs = TextSearcher(corpus.documents, device=device)
    oracle, doc_oracle = KwOracle(engine), KwOracle(docs.engine)
    tier = engine.host_tier()
    engine._host_tier_cached = None  # the device route (bench_suite.py:289)
    docs.engine._host_tier_cached = None
    or_q, and_q = corpus.or_q, corpus.and_q
    words = corpus.words
    single_q = TextQuery(text="quick brown fxo", top_k=KW_TOP_K, fuzzy=True, phrases=["quick brown"])
    label_q = TextQuery(text=or_q[1].text, top_k=KW_TOP_K, fuzzy=True, filter=LabelAtom("/l/tenth"))
    prefix_q = TextQuery(text="quick fox", top_k=KW_TOP_K, key_prefixes=["r00"])
    excl_q = TextQuery(text="quick brown", top_k=KW_TOP_K, fuzzy=True, excluded=["fox"])
    floor_q = TextQuery(text=or_q[2].text, top_k=KW_TOP_K, fuzzy=True, min_score=8.0)
    phrase_req = ParagraphSearchRequest(query='"quick brown"', top_k=KW_TOP_K)
    adv_req = ParagraphSearchRequest(query="quick", top_k=KW_TOP_K, advanced_query=f"brown -fox {words[5]}")
    doc_reqs = [
        DocumentSearchRequest(query=" ".join(q.text.split()[:2]), top_k=KW_TOP_K) for q in or_q[: cfg["doc_requests"] - 1]
    ] + [DocumentSearchRequest(query="quick fox", top_k=KW_TOP_K, order_by="created")]
    threaded = [ParagraphSearchRequest(query=q.text, top_k=KW_TOP_K) for q in or_q[: cfg["threaded"]]]
    threaded_out = {}

    def worker(reqs):
        for r in reqs:
            threaded_out[r.query] = para.search(r)

    # ---- the main path on the device route, counted ------------------------
    bm25.DISPATCHES.clear()
    coalesced0 = coalescer.dispatches
    or_out = kw_dispatched(bm25, lambda: engine.search_batch(or_q, need_matched=False), "OR batch")
    and_out = kw_dispatched(bm25, lambda: engine.search_batch(and_q, need_matched=False), "AND batch")
    single = kw_dispatched(bm25, lambda: engine.search(single_q, need_matched=True), "single request")
    filtered = {
        name: kw_dispatched(bm25, lambda q=q: engine.search(q, need_matched=False), name)
        for name, q in (("label", label_q), ("key prefix", prefix_q), ("excluded term", excl_q), ("min_score", floor_q))
    }
    phrase_resp = kw_dispatched(bm25, lambda: para.search(phrase_req), "phrase request")
    adv_resp = kw_dispatched(bm25, lambda: para.search(adv_req), "advanced_query request")
    threads = [threading.Thread(target=worker, args=(threaded[i :: cfg["threads"]],)) for i in range(cfg["threads"])]
    kw_dispatched(bm25, lambda: [th.start() for th in threads] + [th.join(timeout=600) for th in threads], "threaded requests")
    doc_resps = [kw_dispatched(bm25, lambda r=r: docs.search(r), f"document request {i}") for i, r in enumerate(doc_reqs)]
    dispatches = dict(bm25.DISPATCHES)
    coalesced = coalescer.dispatches - coalesced0
    # -----------------------------------------------------------------------
    check(not any(th.is_alive() for th in threads) and len(threaded_out) == len(threaded), "threaded requests did not finish")
    check(coalesced < len(threaded), f"{len(threaded)} threaded requests took {coalesced} dispatches")

    # the float64 oracle, determinism, filters
    n_oracle = cfg["oracle"]
    for name, queries, out in (("OR", or_q, or_out), ("AND", and_q, and_out)):
        check(len(out) == len(queries), f"{name} batch: {len(out)} results")
        for i in range(n_oracle):
            kw_check_hits(oracle, queries[i], out[i][0], out[i][1], f"{name} query {i}")
        again = engine.search_batch(queries, need_matched=False)
        check(kw_bits(again) == kw_bits(out), f"{name} batch: two runs differ")
    kw_check_hits(oracle, single_q, *single, "single request (matched bitmap)")
    for name, q in (("label", label_q), ("key prefix", prefix_q), ("excluded term", excl_q), ("min_score", floor_q)):
        kw_check_hits(oracle, q, *filtered[name], f"{name} request")
    deleted = set(range(int(DELETED[1:-1]) * 10, int(DELETED[1:-1]) * 10 + 10))
    every = [h for hits, _ in or_out + and_out for h in hits] + [h for hits, _ in filtered.values() for h in hits]
    check(not any(h.doc_id in deleted or h.key.startswith(DELETED) for h in every), "a deleted paragraph came back")
    check(all(h.doc_id % 10 == 0 for h in filtered["label"][0]), "label filter")
    check(all(h.key.startswith("r00") for h in filtered["key prefix"][0]), "key-prefix filter")
    check(not any(engine.doc_has_term(h.doc_id, "fox") for h in filtered["excluded term"][0]), "excluded term")
    check(all(h.score >= 8.0 for h in filtered["min_score"][0]), "min_score floor")
    pm = para._phrase_mask([tokenize("quick brown")])
    q = TextQuery(text=" ", phrases=["quick brown"], top_k=KW_TOP_K, fuzzy=True, extra_mask=pm)
    o_s = kw_check_hits(oracle, q, [engine_hit(h) for h in phrase_resp.hits], _no_count(), "phrase request")
    check(len(o_s) == KW_TOP_K, "phrase request: fewer than top_k hits")
    q = TextQuery(text="quick", top_k=KW_TOP_K, fuzzy=True, extra_mask=advanced_query_mask(engine, adv_req.advanced_query))
    kw_check_hits(oracle, q, [engine_hit(h) for h in adv_resp.hits], _no_count(), "advanced_query request")
    for i, req in enumerate(threaded):
        got = [(h.doc_id, h.score) for h in threaded_out[req.query].hits]
        check(got == [(h.doc_id, h.score) for h in or_out[i][0]], f"threaded request {i} differs from its batch answer")
    doc_ids = {k: i for i, k in enumerate(docs.engine.keys)}
    for i, (req, resp) in enumerate(zip(doc_reqs[:-1], doc_resps)):
        hits = [engine_hit(h, doc_ids[h.key]) for h in resp.hits]
        q = TextQuery(text=req.query, top_k=KW_TOP_K)
        _, _, count, _, _ = doc_oracle.run(q)
        kw_check_hits(doc_oracle, q, hits, _no_count(), f"document request {i}")
        check(resp.total == count, f"document request {i}: total {resp.total} != {count}")
    _, _, _, o_matched, _ = doc_oracle.run(TextQuery(text="quick fox", top_k=KW_TOP_K))
    created = docs.engine.columns["created"]
    want = np.flatnonzero(o_matched)[np.argsort(created[o_matched], kind="stable")[::-1]][:KW_TOP_K]
    check([doc_ids[h.key] for h in doc_resps[-1].hits] == want.tolist(), "order_by=created differs from the oracle")
    print(
        f"keyword device route: {corpus.n} paragraphs ({len(engine.groups)} groups, n_pad {engine.n_pad}), "
        f"{len(docs.engine.keys)} documents; gen {corpus.t_gen:.1f}s, paragraph segments {corpus.t_para:.1f}s, "
        f"document segment {corpus.t_docs:.1f}s, ParagraphSearcher open {t_open:.1f}s ({first_upload / 2**20:.1f} MiB "
        f"uploaded, {mem / 2**30:.2f} GiB on the card); dispatches {dispatches}; {len(threaded)} threaded requests "
        f"in {coalesced} coalesced dispatches; oracle (float64) agrees on {n_oracle} OR + {n_oracle} AND queries, "
        f"the single, 4 filtered, phrase, advanced_query and {len(doc_reqs) - 1} document requests; "
        f"both batches bit-identical on a second run",
        flush=True,
    )

    # ---- the default route (the cost model) --------------------------------
    engine._host_tier_cached = tier
    before = bm25.DISPATCHES.total()
    host_out = engine.search_batch(or_q, need_matched=False)
    host_dispatches = bm25.DISPATCHES.total() - before
    if tier is not None:
        check(host_dispatches == 0, f"the host tier served the OR batch with {host_dispatches} dispatches")
        for i in range(len(or_q)):
            kw_same(or_out[i][0], host_out[i][0], f"host tier vs device, OR query {i}")
            check(host_out[i][1].sum() == or_out[i][1].sum(), f"host tier vs device, OR query {i}: counts")
        for i in range(n_oracle):
            kw_check_hits(oracle, or_q[i], *host_out[i], f"host tier, OR query {i}")
    before = bm25.DISPATCHES.total()
    heavy = engine.search_batch(corpus.heavy_and, need_matched=False)
    check(bm25.DISPATCHES.total() > before, "the heavy AND batch did not reach the device program")
    for i in range(min(8, len(heavy))):
        kw_check_hits(oracle, corpus.heavy_and[i], *heavy[i], f"heavy AND query {i}")
    print(
        f"keyword default route: nucliadb_tpu_native {'loaded' if host_tier._native is not None else 'NOT loaded'}, "
        f"host WAND tier {'on' if tier is not None else 'off: the default route is the device route'}; OR batch "
        f"{host_dispatches} dispatches, equal to the device route up to ties; heavy AND batch ({len(heavy)} queries of "
        f"high-df pairs) on the device program",
        flush=True,
    )

    # ---- breakdown ----------------------------------------------------------
    print(kw_breakdown(torch, para, or_q, and_q, tier, device), flush=True)

    # ---- refresh ------------------------------------------------------------
    up0, t = engine_mod.UPLOAD_BYTES, time.perf_counter()
    para2 = ParagraphSearcher(corpus.second, prev=para, device=device)
    sync()
    t_refresh, refresh_upload = time.perf_counter() - t, engine_mod.UPLOAD_BYTES - up0
    check(para2.engine.reused_groups == 3, f"refresh reused {para2.engine.reused_groups} groups")
    check(refresh_upload < first_upload / 10, f"refresh uploaded {refresh_upload} bytes, first build {first_upload}")
    del para, docs, engine
    if device == "cuda":
        torch.cuda.empty_cache()
    fresh = ParagraphSearcher(corpus.second, device=device)
    for s in (para2, fresh):
        s.engine._host_tier_cached = None
    got = para2.engine.search_batch(or_q, need_matched=False)
    want = fresh.engine.search_batch(or_q, need_matched=False)
    check(kw_bits(got) == kw_bits(want), "refreshed searcher differs from a fresh build")
    check([c.sum() for _, c in got] == [c.sum() for _, c in want], "refreshed searcher: counts differ")
    for r in (ParagraphSearchRequest(query=q.text, top_k=KW_TOP_K) for q in or_q[:8] + [single_q]):
        a, b = para2.search(r), fresh.search(r)
        check([(h.doc_id, h.score) for h in a.hits] == [(h.doc_id, h.score) for h in b.hits], "refresh: a request differs")
    new_hits = [h for hits, _ in got for h in hits if h.doc_id >= corpus.n]
    print(
        f"keyword refresh: +{cfg['refresh']} paragraphs, reused {para2.engine.reused_groups} groups, "
        f"{refresh_upload / 2**20:.2f} MiB uploaded ({refresh_upload / first_upload:.4f} of the first build's), "
        f"{t_refresh:.1f}s; results bit-identical to a fresh build ({len(new_hits)} hits from the new segment)",
        flush=True,
    )
    del para2, fresh
    if device == "cuda":
        torch.cuda.empty_cache()
    return dispatches


def engine_hit(hit, doc_id=None):
    """A searcher's hit as (doc_id, score) for the oracle check."""
    from types import SimpleNamespace

    return SimpleNamespace(doc_id=hit.doc_id if doc_id is None else doc_id, score=hit.score)


def _no_count():
    from nucliadb_tpu_torch.index.text_engine.engine import _CountOnly

    return _CountOnly(-1, 0)


def kw_breakdown(torch, para, or_q, and_q, tier, device):
    """Device ms of each stage of the batched program on the OR batch (CUDA
    events, mean of 5 after a warm-up), the scatter's deterministic and
    atomic forms, and host ms of planning, fetch + hits and whole batches."""
    from nucliadb_tpu_torch.index.paragraph import ParagraphSearchRequest
    from nucliadb_tpu_torch.index.text_engine import engine as engine_mod
    from nucliadb_tpu_torch.ops import bm25
    from nucliadb_tpu_torch.utils.platform import device_fetch

    engine = para.engine
    dev = engine.device
    n_q = len(or_q)
    L = engine.n_pad
    k, caps, rows_np, idfs_np, params_np = engine.plan_batch(or_q)
    groups, offs, tc = engine._group_tensors(), engine._offsets(), tuple(engine._tier_group_counts())
    mask = engine.base_mask_device()

    def upload():
        return [torch.from_numpy(a).to(dev) for a in (rows_np, idfs_np, params_np)]

    rows, idfs, params = upload()
    avgdl = params[:, 0]
    parts = bm25.gather_weights(groups, offs, rows, idfs, avgdl, caps, tc, L)
    scores, _ = bm25.scatter_postings(parts, n_q, L, False, dev)
    base = torch.arange(n_q, device=dev)[:, None, None] * (L + 1)
    all_idx = torch.cat([(ids + base).reshape(-1) for ids, _, _ in parts])
    all_w = torch.cat([w.reshape(-1) for _, w, _ in parts])
    lanes = int(all_idx.numel())

    def put_deterministic():
        torch.use_deterministic_algorithms(True)
        try:
            torch.zeros(n_q * (L + 1), device=dev).index_put_((all_idx,), all_w, accumulate=True)
        finally:
            torch.use_deterministic_algorithms(False)

    timed = cuda_ms if device == "cuda" else host_ms
    out = {
        "upload_rows_idfs_params": timed(upload, 5),
        "gather_and_weights": timed(lambda: bm25.gather_weights(groups, offs, rows, idfs, avgdl, caps, tc, L), 5),
        "scatter_per_slot_deterministic": timed(lambda: bm25.scatter_postings(parts, n_q, L, False, dev), 5),
        "scatter_one_atomic_index_add": timed(
            lambda: torch.zeros(n_q * (L + 1), device=dev).index_add_(0, all_idx, all_w), 5
        ),
        "scatter_index_put_deterministic_algorithms": timed(put_deterministic, 3),
        "topk_cut": timed(lambda: bm25.cut(scores[:, :L], None, mask, params[:, 1], params[:, 2], k), 5),
        # what masked_topk's select path replaces: a stable sort of the whole axis
        "topk_full_stable_sort": timed(lambda: torch.sort(scores[:, :L], dim=-1, descending=True, stable=True), 3),
        "dense_columns": timed(
            lambda: bm25.add_dense_columns(scores[:, :L], None, groups, offs, rows, idfs, avgdl, caps, tc), 5
        ),
        "whole_program_or": timed(
            lambda: bm25.bm25_groups_batch(groups, offs, mask, rows, idfs, params, k, caps, tc,
                                           shared_mask=True, count_only=True, with_counts=False), 5
        ),
    }
    ka, caps_a, ra, ia, pa = engine.plan_batch(and_q)
    ra, ia, pa = (torch.from_numpy(a).to(dev) for a in (ra, ia, pa))
    out["whole_program_and"] = timed(
        lambda: bm25.bm25_groups_batch(groups, offs, mask, ra, ia, pa, ka, caps_a, tc,
                                       shared_mask=True, count_only=True, with_counts=True), 5
    )
    res = bm25.bm25_groups_batch(groups, offs, mask, rows, idfs, params, k, caps, tc,
                                 shared_mask=True, count_only=True, with_counts=False)
    if device == "cuda":
        torch.cuda.synchronize()
    out["host_fetch"] = host_ms(lambda: device_fetch(*res), 3)
    out["host_plan_batch"] = host_ms(lambda: engine.plan_batch(or_q), 3)
    out["host_fetch_and_hits"] = host_ms(lambda: engine._finalize_batch(or_q, k, False, *res), 3)
    engine._host_tier_cached = None
    out["host_batch_device_route_or"] = host_ms(lambda: engine.search_batch(or_q, need_matched=False), 3)
    out["host_batch_device_route_and"] = host_ms(lambda: engine.search_batch(and_q, need_matched=False), 3)
    req = ParagraphSearchRequest(query=or_q[0].text, top_k=KW_TOP_K)
    out["host_search_request_device_route"] = host_ms(lambda: para.search(req), 5)
    engine._host_tier_cached = tier
    if tier is not None:
        out["host_batch_default_route_or"] = host_ms(lambda: engine.search_batch(or_q, need_matched=False), 3)
        out["host_batch_default_route_and"] = host_ms(lambda: engine.search_batch(and_q, need_matched=False), 3)
        out["host_search_request_default_route"] = host_ms(lambda: para.search(req), 5)
    g0 = engine.groups[0]
    t = time.perf_counter()
    c = engine_mod._consolidate(g0.segments, (), 0, 0)
    out["host_consolidate_group0"] = round((time.perf_counter() - t) * 1e3, 3)
    t = time.perf_counter()
    engine_mod._build_tier_matrices(c.terms_sorted, c.group_offsets, c.pdocs, c.ptfs, g0.widths, g0.dlen_np)
    out["host_tier_matrices_group0"] = round((time.perf_counter() - t) * 1e3, 3)
    del c
    out["lanes"] = lanes
    out["caps"] = list(caps)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
        bm25.bm25_groups_batch(groups, offs, mask, rows, idfs, params, k, caps, tc,
                               shared_mask=True, count_only=True, with_counts=False)
        torch.cuda.synchronize()
        out["peak_gib_or_batch"] = round(torch.cuda.max_memory_allocated() / 2**30, 3)
    out = {key: (round(v, 3) if isinstance(v, float) else v) for key, v in out.items()}
    return f"breakdown keyword (ms, batch {n_q}, {engine.n_docs} paragraphs): {json.dumps(out)}"


def host_ms(fn, reps: int) -> float:
    """Median host ms of ``reps`` calls after one."""
    fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


# ---------------------------------------------------------------------------
# the index node: indexing, merging, syncing and hybrid shard search
# ---------------------------------------------------------------------------

NODE_FULL = {
    "resources": 1_000,
    # paragraphs per resource: 200,000 in all, one target segment of the
    # vector merge policy (VECTOR_MAX_SEGMENT)
    "paragraphs": 200,
    "dim": DIM,
    "hybrid": 64,  # single hybrid requests on each keyword route
    "threads": 8,
    "threaded": 64,  # hybrid requests through the coalescers from the threads
    "delta": 20,  # resources indexed after the deletion
    "cpu": 64,  # hybrid requests answered again by a searcher on the CPU
}
NODE_TOP_K = 20
NODE_CPU_RTOL = 1e-4
NODE_HIDDEN = 3  # the resource indexed with hidden=True
NODE_DELETED = 11  # the resource deleted before the delta
NODE_TEAMS = ("red", "blue", "green", "gold")


def node_rid(r: int) -> str:
    return f"n{r:05d}"


def node_restricted(r: int) -> bool:
    return r % 7 == 0  # access group "restricted"; every other resource is public


class NodeCorpus:
    """The node's resources, made from ``SEED``: paragraph text from
    bench_suite.py config 3's vocabulary, vectors from the clustered
    generator, a label on every tenth paragraph, a title, a JSON field
    ``{"year", "team"}``, three relations per resource, and the access group
    "restricted" on every seventh resource. Row i is paragraph i % P of
    resource i // P; the last ``delta`` resources are indexed later."""

    def __init__(self, torch, cfg, device):
        self.cfg = cfg
        self.P = cfg["paragraphs"]
        self.R = cfg["resources"]
        n_all = (self.R + cfg["delta"]) * self.P
        n_q = max(cfg["hybrid"], cfg["threaded"], cfg["cpu"])
        self.vecs, q = make_corpus(torch, n_all, cfg["dim"], n_q, device)
        self.vecs_np = self.vecs.cpu().numpy()
        self.q_np = q.cpu().numpy()
        self.words = kw_vocab()
        self.texts, _ = kw_texts(self.words, n_all, 13)
        self.titles, _ = kw_texts(self.words, self.R + cfg["delta"], 14)
        rng = np.random.default_rng(SEED)
        self.bodies = []
        for _ in range(n_q):  # bench_suite.py's OR queries: two words and a typo
            t1, t2 = self.words[int(rng.integers(0, 2000))], self.words[int(rng.integers(0, 2000))]
            self.bodies.append(f"{t1} {t2} {'quikc' if len(self.bodies) % 2 else 'borwn'}")
        self.vkey_row: dict[str, int] = {}
        self.pkey_row: dict[str, int] = {}

    def resource(self, r: int):
        from nucliadb_tpu_torch.models.internal import (
            IndexParagraph, IndexRelation, RelationNode, ResourceDoc, Security, TextInformation, VectorSentence,
        )

        rid, P = node_rid(r), self.P
        parts = self.texts[r * P : (r + 1) * P]
        rd = ResourceDoc(resource_id=rid, created=1000 + r, modified=1000 + r)
        rd.texts["t/body"] = TextInformation(text=" ".join(parts))
        rd.texts["a/title"] = TextInformation(text=" ".join(self.titles[r].split()[:6]))
        paras, start = {}, 0
        for j, text in enumerate(parts):
            i, end = r * P + j, start + len(text)
            para = IndexParagraph(start=start, end=end, labels=["/l/tenth"] if i % 10 == 0 else [])
            vkey, pkey = f"{rid}/t/body/{j:03d}/{start}-{end}", f"{rid}/t/body/{start}-{end}"
            para.vectorsets_sentences["m"] = {vkey: VectorSentence(vector=self.vecs_np[i])}
            paras[pkey] = para
            self.vkey_row[vkey], self.pkey_row[pkey] = i, i
            start = end + 1
        rd.paragraphs["t/body"] = paras
        rd.json_fields["a/meta"] = json.dumps({"year": 2000 + r % 25, "team": NODE_TEAMS[r % 4]})
        rd.relations["t/body"] = [
            IndexRelation(
                source=RelationNode(value=rid, ntype="RESOURCE"),
                target=RelationNode(value=f"entity{(3 * r + k) % 97}", ntype="ENTITY", subtype="team"),
                relation="ENTITY",
                label=("mentions", "praises", "cites")[k],
            )
            for k in range(3)
        ]
        if node_restricted(r):
            rd.security = Security(access_groups=["restricted"])
        return rd


def node_observed(family: str, kinds) -> dict:
    """Seconds the node's indexing or merge observer has summed per index
    kind (its prometheus histogram ``ndbtpu_<family>_duration_seconds``)."""
    from nucliadb_tpu_torch.telemetry.metrics import REGISTRY

    name = f"ndbtpu_{family}_duration_seconds_sum"
    return {k: REGISTRY.get_sample_value(name, {"kind": k}) or 0.0 for k in kinds}


def device_busy_ms(torch, fn) -> float:
    """Device ms that the kernels and copies of ``fn()`` took, summed by
    ``torch.profiler`` (CUDA activity only)."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages())
    check(total_us > 0, "torch.profiler saw no device time")
    return total_us / 1e3


def node_resource_of(hit_key: str) -> int:
    return int(hit_key.split("/", 1)[0][1:])


def node_legs(resp):
    """Every resource a response returned, by leg."""
    return {
        "vector": [node_resource_of(h.key) for h in resp.vector],
        "paragraph": [node_resource_of(h.paragraph_id) for h in (resp.paragraph.hits if resp.paragraph else [])],
        "document": [node_resource_of(h.key) for h in (resp.document.hits if resp.document else [])],
        "graph": [node_resource_of(p.resource_field) for p in resp.graph],
    }


def node_same(a, b, rtol, what):
    """Two ShardSearchResponses equal up to ties: vector keys and paragraph
    and document hits rank by rank within ``rtol``, the same ids above the
    tie band at the cut."""
    from types import SimpleNamespace

    def ranked(x, y, key, leg):
        check(len(x) == len(y), f"{what}, {leg}: {len(x)} vs {len(y)} hits")
        if not x:
            return
        sx, sy = np.array([h.score for h in x]), np.array([h.score for h in y])
        check(bool(np.all(np.abs(sx - sy) <= rtol * np.abs(sx) + 1e-6)), f"{what}, {leg}: scores differ")
        band = sx[-1] + rtol * abs(sx[-1]) + 1e-6
        check({key(h) for h in x if h.score > band} == {key(h) for h in y if h.score > band}, f"{what}, {leg}: ids differ")

    ranked(a.vector, b.vector, lambda h: h.key, "vector")
    for leg, key in (("paragraph", lambda h: h.paragraph_id), ("document", lambda h: h.key)):
        la, lb = getattr(a, leg), getattr(b, leg)
        check((la is None) == (lb is None), f"{what}: {leg} leg present on one side only")
        if la is not None:
            ranked(la.hits, lb.hits, key, leg)
            check(la.total == lb.total, f"{what}, {leg}: total {la.total} vs {lb.total}")
    empty = SimpleNamespace(kind=None, fields=())
    check((a.prefilter or empty).kind == (b.prefilter or empty).kind, f"{what}: prefilter differs")
    check([(p.resource_field, p.target.value) for p in a.graph] == [(p.resource_field, p.target.value) for p in b.graph],
          f"{what}: graph paths differ")


def node_hybrid(corpus, i, **kw):
    from nucliadb_tpu_torch.shard import ShardSearchRequest

    return ShardSearchRequest(
        body=corpus.bodies[i], vector=corpus.q_np[i], top_k=NODE_TOP_K, paragraph=True, document=True, **kw
    )


def node_check_keyword(corpus, shard, req, resp, what):
    """The paragraph and document legs against the float64 BM25 oracle on
    the searcher's own engines (ids equal up to ties, scores within 1e-5,
    the exact matched totals)."""
    from nucliadb_tpu_torch.index.text_engine.engine import TextQuery, _CountOnly

    para_oracle, doc_oracle = corpus.oracles(shard)
    q = TextQuery(text=req.body, top_k=req.top_k, fuzzy=True)
    kw_check_hits(para_oracle, q, resp.paragraph.hits, _CountOnly(resp.paragraph.total, 0), f"{what}, paragraph leg")
    doc_ids = {k: i for i, k in enumerate(shard.text.engine.keys)}
    hits = [engine_hit(h, doc_ids[h.key]) for h in resp.document.hits]
    kw_check_hits(doc_oracle, TextQuery(text=req.body, top_k=req.top_k), hits,
                  _CountOnly(resp.document.total, 0), f"{what}, document leg")


def node_recall(corpus, hits_rows, oracle) -> float:
    return float(np.mean([
        len({corpus.vkey_row[h.key] for h in hits[:TOP_K]} & set(oracle[r].tolist())) / TOP_K
        for r, hits in enumerate(hits_rows)
    ]))


def phase_node(torch, tmp, cfg, device="cuda"):
    """The index node on ``device`` (see the module docstring); prints one
    line per part and returns the launch and dispatch counts of its counted
    main path (the hybrid requests on both keyword routes)."""
    import os
    import threading
    from types import SimpleNamespace

    from nucliadb_tpu_torch.index.json import JsonPredicate
    from nucliadb_tpu_torch.index.paragraph import ParagraphSearchRequest
    from nucliadb_tpu_torch.index.relation import GraphSearchRequest, NodePattern
    from nucliadb_tpu_torch.index.text import DocumentSearchRequest
    from nucliadb_tpu_torch.index.vector import LabelAtom, VectorConfig, VectorSearchRequest
    from nucliadb_tpu_torch.index.vector.batcher import coalescer
    from nucliadb_tpu_torch.ops import binary_scan, bm25, slot_scan
    from nucliadb_tpu_torch.services import EmbeddedNode
    from nucliadb_tpu_torch.services.searcher import SyncedSearcher

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    corpus = NodeCorpus(torch, cfg, device)
    t_gen = time.perf_counter() - t0
    R, P, k = corpus.R, corpus.P, NODE_TOP_K

    def oracles(shard):
        cached = getattr(corpus, "_oracles", None)
        if cached is None or cached[0] is not shard:
            cached = corpus._oracles = (shard, KwOracle(shard.paragraph.engine), KwOracle(shard.text.engine))
        return cached[1:]

    corpus.oracles = oracles

    # ---- build: index, merge, sync ------------------------------------------
    node_dir = f"{tmp}/node"
    node = EmbeddedNode(node_dir, device=device)
    sid = node.create_shard("kb", {"m": VectorConfig(dimension=cfg["dim"])}, shard_id="shard0")
    node.configure_shards([{"shard_id": sid, "prewarm_enabled": True}])  # sync opens the searcher
    kinds = ("text", "paragraph", "relation", "json", "vector")
    index_s0, merge_s0 = node_observed("indexing", kinds), node_observed("merge", kinds)
    # busy seconds of the indexer and worker services (their utilization
    # counters): the segment builds and merges above are parts of them
    busy0 = node.indexer.utilization.totals()[0], node.worker.utilization.totals()[0]
    t = time.perf_counter()
    for r in range(R):
        node.index(sid, corpus.resource(r), hidden=r == NODE_HIDDEN)
    t_index = time.perf_counter() - t
    t, rounds, merged = time.perf_counter(), 0, {}
    while True:
        stats = node.tick_background()
        rounds += 1
        if stats["jobs_enqueued"] == 0 and stats["merged"] == 0:
            break
    t_merge = time.perf_counter() - t
    index_s = {k: round(v - index_s0[k], 2) for k, v in node_observed("indexing", kinds).items()}
    merge_s = {k: round(v - merge_s0[k], 2) for k, v in node_observed("merge", kinds).items()}
    busy = node.indexer.utilization.totals()[0] - busy0[0], node.worker.utilization.totals()[0] - busy0[1]
    segments = {
        index.full_name: [s.records for s in node.metadata.ready_segments(index.id)]
        for index in node.metadata.get_indexes(sid)
    }
    visible = (R - 1) * P
    check(segments["vector/m"] == [visible, P] or segments["vector/m"] == [P, visible],
          f"vector segments after the merges: {segments['vector/m']}")
    check(segments["paragraph"] == [R * P], f"paragraph segments after the merges: {segments['paragraph']}")
    check(all(len(v) == 1 for name, v in segments.items() if name != "vector/m"), f"segments {segments}")
    t = time.perf_counter()
    check(node.wait_for_sync() == [sid], "sync did not open the shard")
    sync()
    t_sync = time.perf_counter() - t
    shard = node.searcher.shard(sid)
    vindex = shard.vectors["m"].index
    check(vindex.codes is not None and not vindex.host_resident(), "the vector leg is not on the int8 route")
    tier = shard.paragraph.engine.host_tier()
    print(
        f"node build: {R} resources x {P} paragraphs ({R * P} paragraphs, dim {cfg['dim']}) on {device}; "
        f"gen {t_gen:.1f}s; indexed in {t_index:.1f}s ({R / t_index:.1f} resources/s; indexer busy {busy[0]:.1f}s, "
        f"of it segment builds by kind, s: {json.dumps(index_s)}); {rounds} background rounds, merges {t_merge:.1f}s "
        f"(worker busy {busy[1]:.1f}s, of it merges by kind, s: {json.dumps(merge_s)}) "
        f"-> segments {json.dumps(segments)}; sync {t_sync:.1f}s (p_pad {vindex.p_pad}, "
        f"{len(shard.paragraph.engine.groups)} paragraph group(s)); host WAND tier {'on' if tier else 'off'}",
        flush=True,
    )

    # the exact f32 oracle over the alive, visible paragraphs
    alive = torch.ones(corpus.vecs.shape[0], dtype=torch.bool, device=corpus.vecs.device)
    alive[R * P :] = False
    alive[NODE_HIDDEN * P : (NODE_HIDDEN + 1) * P] = False
    q_dev = torch.from_numpy(corpus.q_np).to(corpus.vecs.device)
    oracle = exact_oracle(torch, corpus.vecs, alive, q_dev, TOP_K)
    n_h = cfg["hybrid"]
    reqs = [node_hybrid(corpus, i) for i in range(n_h)]

    # ---- the main path, counted: hybrid requests on both keyword routes ------
    os.environ.pop("NDBTPU_TEXT_HOST_TIER", None)
    reset_launches(slot_scan, binary_scan)
    bm25.DISPATCHES.clear()
    default_out = [node.search(sid, r) for r in reqs]
    default_counts = dict(slot_scan.LAUNCHES, **binary_scan.LAUNCHES, **bm25.DISPATCHES)
    os.environ["NDBTPU_TEXT_HOST_TIER"] = "0"  # set before the device-route node's searcher opens
    node_dev = EmbeddedNode(node_dir, device=device)  # a second node over the same data directory
    t = time.perf_counter()
    shard_dev = node_dev.searcher.shard(sid)
    sync()
    t_open_dev = time.perf_counter() - t
    reset_launches(slot_scan, binary_scan)
    bm25.DISPATCHES.clear()
    device_out = [node_dev.search(sid, r) for r in reqs]
    device_counts = dict(slot_scan.LAUNCHES, **binary_scan.LAUNCHES, **bm25.DISPATCHES)
    # ---------------------------------------------------------------------------
    if device == "cuda":  # on the CPU the wrappers take their plain versions, which count nothing
        check(default_counts.get("top2", 0) >= n_h, f"default route: the top-2 kernel launched {default_counts}")
        check(device_counts.get("top2", 0) >= n_h, f"device route: the top-2 kernel launched {device_counts}")
    check(device_counts.get("single", 0) + device_counts.get("batch", 0) >= n_h,
          f"device route: the BM25 program dispatched {device_counts}")
    check(shard_dev.paragraph.engine.host_tier() is None, "the device-route searcher kept the host tier")
    if tier is not None:
        check(default_counts.get("single", 0) + default_counts.get("batch", 0) == 0,
              f"default route: the host tier dispatched {default_counts}")
    check(all(default_counts.get(m, 0) == 0 and device_counts.get(m, 0) == 0 for m in ("top1", "binary")),
          "the node launched a kernel of another route")
    for name, shard_x, out in (("default route", shard, default_out), ("device route", shard_dev, device_out)):
        for i, (req, resp) in enumerate(zip(reqs, out)):
            check(len(resp.vector) == k and resp.paragraph is not None and resp.document is not None,
                  f"{name}, hybrid {i}: a leg is missing")
            check(NODE_HIDDEN not in node_legs(resp)["vector"], f"{name}, hybrid {i}: a hidden vector came back")
            node_check_keyword(corpus, shard_x, req, resp, f"{name}, hybrid {i}")
        recall = node_recall(corpus, [resp.vector for resp in out], oracle)
        check(recall >= RECALL_BAR, f"{name}: vector leg recall@10 {recall} < {RECALL_BAR}")
    for i, (a, b) in enumerate(zip(default_out, device_out)):
        node_same(a, b, KW_RTOL, f"hybrid {i}: default vs device route")

    # ---- timings: a single hybrid request and each leg ----------------------
    req0 = reqs[0]
    timings = {}
    for name, node_x, shard_x in (("default", node, shard), ("device", node_dev, shard_dev)):
        timings[f"hybrid_{name}"] = host_ms(lambda: node_x.search(sid, req0), 5)
        timings[f"paragraph_leg_{name}"] = host_ms(
            lambda: shard_x.paragraph.search(ParagraphSearchRequest(query=req0.body, top_k=k)), 5
        )
        timings[f"document_leg_{name}"] = host_ms(
            lambda: shard_x.text.search(DocumentSearchRequest(query=req0.body, top_k=k)), 5
        )
    timings["vector_leg"] = host_ms(
        lambda: shard.vectors["m"].search(VectorSearchRequest(vectors=req0.vector, top_k=k)), 5
    )
    timings["prefilter_security_json"] = host_ms(
        lambda: shard.compute_prefilter(node_hybrid(corpus, 0, security_groups=[],
                                                     json_filter=JsonPredicate(path="team", op="eq", value="red"))), 5
    )

    if device == "cuda":
        for name, node_x in (("default", node), ("device", node_dev)):
            busy = device_busy_ms(torch, lambda: [node_x.search(sid, r) for r in reqs[:16]]) / 16
            timings[f"device_busy_per_hybrid_{name}"] = busy
            timings[f"device_idle_share_{name}"] = 1.0 - busy / timings[f"hybrid_{name}"]

    # ---- coalescers: threaded requests on both routes -------------------------
    n_t = cfg["threaded"]
    threaded = [node_hybrid(corpus, i % n_h) for i in range(n_t)]
    t_burst, coalesced, t_seq = {}, {}, {}
    for name, node_x, solo in (("device", node_dev, device_out), ("default", node, default_out)):
        t = time.perf_counter()
        for r in threaded:  # the same requests one after another, warm
            node_x.search(sid, r)
        t_seq[name] = (time.perf_counter() - t) * 1e3
        t_out = [None] * n_t
        errors = []

        def worker(ix):
            try:
                for i in ix:
                    t_out[i] = node_x.search(sid, threaded[i])
            except BaseException as e:  # reported below
                errors.append(e)

        coalesced0 = coalescer.dispatches
        threads = [threading.Thread(target=worker, args=(range(w, n_t, cfg["threads"]),)) for w in range(cfg["threads"])]
        t = time.perf_counter()
        [th.start() for th in threads]
        [th.join(timeout=600) for th in threads]
        t_burst[name] = (time.perf_counter() - t) * 1e3
        coalesced[name] = coalescer.dispatches - coalesced0
        check(not errors and all(x is not None for x in t_out), f"{name} route: threaded requests failed: {errors[:1]}")
        check(coalesced[name] < n_t, f"{name} route: {n_t} threaded requests took {coalesced[name]} vector dispatches")
        for i, resp in enumerate(t_out):
            node_same(resp, solo[i % n_h], KW_RTOL, f"{name} route: threaded request {i} vs its solo answer")

    # ---- the card against the CPU, over the same synced segments -------------
    n_c = min(cfg["cpu"], n_h)
    if device == "cuda":
        cpu = SyncedSearcher(node.metadata, node.storage, node.searcher.cache_dir, device="cpu")
        t = time.perf_counter()
        cpu_out = [cpu.search(sid, r) for r in reqs[:n_c]]
        t_cpu = time.perf_counter() - t
        check(cpu.shard(sid).paragraph.engine.host_tier() is None, "the CPU searcher kept the host tier")
        for i, (a, b) in enumerate(zip(device_out, cpu_out)):
            node_same(a, b, NODE_CPU_RTOL, f"hybrid {i}: card vs CPU")
        del cpu, cpu_out
    else:
        t_cpu = 0.0
    os.environ.pop("NDBTPU_TEXT_HOST_TIER", None)
    del node_dev, shard_dev, device_out, t_out
    if device == "cuda":
        torch.cuda.empty_cache()

    # ---- filters and the other legs (default route) --------------------------
    def legs(req):
        return node_legs(node.search(sid, req))

    restricted_r = next(r for r in range(1, R) if node_restricted(r) and r != NODE_HIDDEN)
    target = restricted_r * P + 5  # a paragraph of a restricted resource
    probe = dict(body=corpus.texts[target], vector=corpus.vecs_np[target], top_k=k, document=True)
    from nucliadb_tpu_torch.shard import ShardSearchRequest

    open_legs, closed_legs = legs(ShardSearchRequest(**probe, security_groups=["restricted"])), legs(
        ShardSearchRequest(**probe, security_groups=[]))
    check(open_legs["vector"][:1] == [restricted_r] and restricted_r in open_legs["paragraph"],
          "security: the restricted resource is not found by its group")
    check(not any(node_restricted(r) for leg in closed_legs.values() for r in leg), "security: a restricted resource passed")
    label = node.search(sid, node_hybrid(corpus, 1, filter=LabelAtom("/l/tenth")))
    check(label.vector and label.paragraph.hits, "label filter: an empty leg")
    check(all("/l/tenth" in h.labels for h in label.vector), "label filter: an unlabelled vector")
    check(all(corpus.pkey_row[h.paragraph_id] % 10 == 0 for h in label.paragraph.hits), "label filter: an unlabelled paragraph")
    red = JsonPredicate(path="team", op="eq", value="red")
    for op, ok in (("and", lambda r: not node_restricted(r) and r % 4 == 0),
                   ("or", lambda r: not node_restricted(r) or r % 4 == 0)):
        got = legs(node_hybrid(corpus, 2, security_groups=[], json_filter=red, filter_operator=op))
        check(got["vector"] and got["paragraph"], f"json prefilter ({op}): an empty leg")
        check(all(ok(r) for leg in got.values() for r in leg), f"json prefilter ({op}): a resource outside it passed")
    own = dict(body=corpus.texts[12 * P + 1], vector=corpus.q_np[3], top_k=k, document=True)
    got = legs(ShardSearchRequest(**own, key_filters=[node_rid(12) + "/"]))
    check(got["vector"] and got["paragraph"], "key_filters: an empty leg")
    check(all(r == 12 for leg in got.values() for r in leg), "key_filters: another resource passed")
    got = legs(node_hybrid(corpus, 4, range_creation=(1000 + R // 2, None)))
    check(got["vector"] and all(r >= R // 2 for leg in got.values() for r in leg), "range_creation: an older resource passed")
    full = default_out[5]
    v_floor, p_floor = full.vector[4].score, full.paragraph.hits[4].score
    floored = node.search(sid, node_hybrid(corpus, 5, min_score_semantic=v_floor, min_score_bm25=p_floor))
    check([h.key for h in floored.vector] == [h.key for h in full.vector if h.score >= np.float32(v_floor)],
          "min_score_semantic: not the floored full result")
    check(len(floored.paragraph.hits) >= 5 and all(h.score >= p_floor for h in floored.paragraph.hits),
          "min_score_bm25: a hit under the floor")
    graph = node.search(sid, ShardSearchRequest(body="", graph=GraphSearchRequest(source=NodePattern(value=node_rid(7)))))
    check(len(graph.graph) == 3 and all(p.source.value == node_rid(7) for p in graph.graph), "graph request")
    doc_body = " ".join(corpus.texts[6 * P + 2].split()[:3])  # words the corpus holds at any size
    doc_req = ShardSearchRequest(body=doc_body, top_k=k, document=True, paragraph=False)
    doc = node.search(sid, doc_req)
    check(doc.paragraph is None and doc.vector == [] and doc.document.hits, "document request")
    doc_oracle = oracles(shard)[1]
    doc_ids = {key: i for i, key in enumerate(shard.text.engine.keys)}
    from nucliadb_tpu_torch.index.text_engine.engine import TextQuery

    kw_check_hits(doc_oracle, TextQuery(text=doc_req.body, top_k=k), [engine_hit(h, doc_ids[h.key]) for h in doc.document.hits],
                  _no_count(), "document request")

    # ---- deletion, then a delta ----------------------------------------------
    gone = NODE_DELETED * P + 7
    probe_gone = ShardSearchRequest(body=corpus.texts[gone], vector=corpus.vecs_np[gone], top_k=k, document=True,
                                    graph=GraphSearchRequest(source=NodePattern(value=node_rid(NODE_DELETED))))
    check(NODE_DELETED in legs(probe_gone)["vector"][:1], "the resource to delete is not found before")
    node.delete_resource(sid, node_rid(NODE_DELETED))
    t = time.perf_counter()
    node.wait_for_sync()
    sync()
    t_sync_delete = time.perf_counter() - t
    check(not any(NODE_DELETED in leg for leg in legs(probe_gone).values()), "a deleted resource came back")
    before = node.searcher.shard(sid)
    t = time.perf_counter()
    for r in range(R, R + cfg["delta"]):
        node.index(sid, corpus.resource(r))
    t_delta_index = time.perf_counter() - t
    t = time.perf_counter()
    node.wait_for_sync()
    sync()
    t_sync_delta = time.perf_counter() - t
    after = node.searcher.shard(sid)
    extended = after.vectors["m"].index.vectors is before.vectors["m"].index.vectors
    reused = after.paragraph.engine.reused_groups
    check(extended, "the delta did not extend the vector arena in place")
    check(reused >= 1, f"the delta reused {reused} paragraph groups")
    new_row = R * P + 3
    found = legs(ShardSearchRequest(body=corpus.texts[new_row], vector=corpus.vecs_np[new_row], top_k=k))
    check(found["vector"][:1] == [R] and R in found["paragraph"], "a delta resource is not found")
    fresh = SyncedSearcher(node.metadata, node.storage, node.searcher.cache_dir, device=device)
    for i in range(16):
        req = node_hybrid(corpus, i)
        node_same(node.search(sid, req), fresh.search(sid, req), KW_RTOL, f"hybrid {i}: refreshed vs fresh searcher")
    del fresh, before, after
    if device == "cuda":
        torch.cuda.empty_cache()

    print(
        f"node requests: {n_h} hybrid requests (body + vector, top {k}, paragraph and document legs) on each keyword "
        f"route: vector recall@10 >= {RECALL_BAR} against the exact f32 oracle, paragraph and document legs equal to "
        f"the float64 BM25 oracle; counts default route {json.dumps(default_counts)}, device route "
        f"{json.dumps(device_counts)}; device-route searcher open {t_open_dev:.1f}s; filters (label, security, json "
        f"and/or, key_filters, range_creation, min_score on each leg), graph and document requests pass; "
        f"{n_t} threaded requests from {cfg['threads']} threads, each equal to its solo answer: device route "
        f"{t_burst['device']:.1f} ms ({coalesced['device']} vector dispatches), default route "
        f"{t_burst['default']:.1f} ms ({coalesced['default']}); the {n_t} requests one after another: device "
        f"route {t_seq['device']:.1f} ms, default route {t_seq['default']:.1f} ms (warm); card vs CPU on {n_c if device == 'cuda' else 0} requests equal within "
        f"{NODE_CPU_RTOL} (CPU {t_cpu:.1f}s); deletion sync {t_sync_delete:.2f}s; delta of {cfg['delta']} resources "
        f"indexed in {t_delta_index:.2f}s, synced in {t_sync_delta:.2f}s (arena extended in place, {reused} paragraph "
        f"group(s) reused), equal to a fresh searcher",
        flush=True,
    )
    timings = {key: round(v, 3) for key, v in timings.items()}
    print(
        f"node timings (host ms, median of 5; device busy ms per request from torch.profiler over 16 requests, idle "
        f"share against the unprofiled median): {json.dumps(timings)}; threaded bursts (ms) {json.dumps(t_burst)}",
        flush=True,
    )
    del node, shard
    if device == "cuda":
        torch.cuda.empty_cache()
    return SimpleNamespace(default=default_counts, device=device_counts)


# ---------------------------------------------------------------------------
# the product /find: SearchService over KnowledgeBoxManager, Processor, maindb
# ---------------------------------------------------------------------------

FIND_FULL = {
    "resources": 1_000,
    "paragraphs": 200,  # 200,000 paragraphs: the node phase's corpus generator and scale
    "dim": DIM,
    "requests": 64,  # hybrid FindRequests on each keyword route
    "filtered": 16,  # with a label filter_expression, on each route
    "secured": 16,  # with security groups, on each route
    "cpu": 16,  # answered again by a SearchService over a node on the CPU
    "fusion": 16,  # fused orders recomputed from their shard responses
    "semantic": 64,  # semantic-only requests held to the exact f32 oracle
    "threads": 8,
}
FIND_TOP_K = 20
FIND_TOPICS = ("sports", "news", "science", "arts")  # labelset "topic": resource r has FIND_TOPICS[r % 4]
FIND_LANGS = ("en", "es", "ca")  # labelset "lang": FIND_LANGS[r % 3]
FIND_GROUPS = ("g1", "g2")  # access groups of resources r % 5 == 0 and r % 5 == 1; the rest are public


def find_groups(r: int) -> list[str]:
    return [FIND_GROUPS[r % 5]] if r % 5 < 2 else []


def find_payload(corpus, r: int, rows: dict):
    """Resource r as the API's CreateResourcePayload: its paragraphs joined
    by blank lines into one text field, one 768-d embedding per paragraph
    (vectorset "m"), a title, two labels and, on two resources in five, an
    access group. ``rows`` maps each paragraph's block id to its corpus row."""
    from nucliadb_tpu_torch.models.api import (
        Classification, CreateResourcePayload, ResourceSecurity, SentenceEmbedding, TextFieldPayload, UserMetadata,
    )

    P, rid = corpus.P, node_rid(r)
    parts = corpus.texts[r * P : (r + 1) * P]
    embeddings, start = [], 0
    for j, text in enumerate(parts):
        end = start + len(text)
        embeddings.append(SentenceEmbedding(start=start, end=end, vector=corpus.vecs_np[r * P + j].tolist()))
        rows[f"{rid}/t/body/{start}-{end}"] = r * P + j
        start = end + 2
    groups = find_groups(r)
    return CreateResourcePayload(
        title=" ".join(corpus.titles[r].split()[:6]),
        texts={"body": TextFieldPayload(body="\n\n".join(parts))},
        usermetadata=UserMetadata(classifications=[
            Classification(labelset="topic", label=FIND_TOPICS[r % 4]),
            Classification(labelset="lang", label=FIND_LANGS[r % 3]),
        ]),
        security=ResourceSecurity(access_groups=groups) if groups else None,
        embeddings={"m": {"body": embeddings}},
    )


def find_request(corpus, i: int, **kw):
    from nucliadb_tpu_torch.models.api import FindRequest

    return FindRequest(**{"query": corpus.bodies[i], "vector": corpus.q_np[i].tolist(), "top_k": FIND_TOP_K, **kw})


def find_capture(node) -> list:
    """Keeps the shard responses of every ``search_multi`` call that
    ``SearchService`` makes on ``node`` (one per /find)."""
    seen, real = [], node.search_multi

    def search_multi(shard_ids, request):
        out = real(shard_ids, request)
        seen.append(out)
        return out

    node.search_multi = search_multi
    return seen


def find_scores(res) -> dict:
    """Block id -> fused score of every paragraph a FindResults holds."""
    return {pid: p.score for r in res.resources.values() for f in r.fields.values() for pid, p in f.paragraphs.items()}


def find_plain_rrf(resp, top_k: int) -> list:
    """Reciprocal rank fusion recomputed from one shard response: each leg
    ranked by score (stable), 1 / (60 + rank) summed per block, ordered by
    (-fused, block id), cut at top_k."""
    keyword = sorted(((h.paragraph_id, h.score) for h in resp.paragraph.hits), key=lambda x: -x[1])
    semantic = []
    for h in resp.vector:  # "{rid}/{field}/{index}/{start}-{end}" -> "{rid}/{field}/{start}-{end}"
        parts = h.key.split("/")
        semantic.append(("/".join(parts[:-2] + parts[-1:]), h.score))
    semantic.sort(key=lambda x: -x[1])
    fused = {}
    for blocks in (keyword, semantic):
        for rank, (block, _) in enumerate(blocks):
            fused[block] = fused.get(block, 0.0) + 1.0 / (60 + rank)
    return sorted(fused.items(), key=lambda x: (-x[1], x[0]))[:top_k]


def find_check_fusion(res, resp, what):
    want = find_plain_rrf(resp, FIND_TOP_K)
    check(res.best_matches == [b for b, _ in want], f"{what}: the fused order is not the plain RRF's")
    scores = find_scores(res)
    check(all(scores[b] == f for b, f in want), f"{what}: a fused score is not the plain RRF's")


def find_tied(*responses, rtol=KW_RTOL) -> set:
    """Blocks whose score on a leg lies within ``rtol`` of another block's
    in these responses: two routes (or two batch sizes of the rerank) may
    rank such ties either way."""
    tied = set()
    for leg in ([(h.paragraph_id, h.score) for r in responses for h in r.paragraph.hits],
                [("/".join(h.key.split("/")[:-2] + h.key.split("/")[-1:]), h.score) for r in responses for h in r.vector]):
        hits = sorted(set(leg), key=lambda x: x[1])
        for (a, sa), (b, sb) in zip(hits, hits[1:]):
            if a != b and abs(sa - sb) <= rtol * abs(sb) + 1e-6:
                tied |= {a, b}
    return tied


def find_same(a, b, tied, rtol, what):
    """Two FindResults equal up to ties: the same length, and at each rank
    the same block (with its fused score within ``rtol``) or two blocks of
    ``tied``."""
    check(len(a.best_matches) == len(b.best_matches), f"{what}: {len(a.best_matches)} vs {len(b.best_matches)} matches")
    sa, sb = find_scores(a), find_scores(b)
    for x, y in zip(a.best_matches, b.best_matches):
        if x == y:
            check(abs(sa[x] - sb[y]) <= rtol * abs(sb[y]) + 1e-9, f"{what}: {x} scores differ")
        else:
            check(x in tied and y in tied, f"{what}: {x} vs {y}")


def find_results_ok(res, what):
    scores = [find_scores(res)[b] for b in res.best_matches]
    check(len(res.best_matches) == FIND_TOP_K and res.resources, f"{what}: {len(res.best_matches)} matches")
    check(bool(np.isfinite(scores).all()) and all(x >= y for x, y in zip(scores, scores[1:])), f"{what}: fused scores")
    check(all(r.title and r.fields for r in res.resources.values()), f"{what}: a resource was not hydrated")


def phase_find(torch, tmp, cfg, device="cuda"):
    """The product /find in process (see the module docstring); prints one
    line per part and returns the launch and dispatch counts of its counted
    main path (the hybrid requests on both keyword routes)."""
    import os
    import threading

    from nucliadb_tpu_torch.common.kb import KnowledgeBoxManager
    from nucliadb_tpu_torch.index.text_engine.engine import TextQuery
    from nucliadb_tpu_torch.ingest import Processor
    from nucliadb_tpu_torch.maindb import Driver
    from nucliadb_tpu_torch.models.api import FilterExpression, KnowledgeBoxConfig, SearchFeature, VectorSetSpec
    from nucliadb_tpu_torch.ops import binary_scan, bm25, slot_scan
    from nucliadb_tpu_torch.search import SearchService
    from nucliadb_tpu_torch.services import EmbeddedNode

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t_phase = time.perf_counter()
    n_req = cfg["requests"]
    corpus = NodeCorpus(torch, dict(cfg, delta=0, hybrid=max(n_req, cfg["semantic"]), threaded=0, cpu=0), device)
    R, P = corpus.R, corpus.P

    def stack(node):
        kbs = KnowledgeBoxManager(driver, node)
        processor = Processor(driver, node, kbs)
        return SimpleNamespace(node=node, kbs=kbs, processor=processor, search=SearchService(node, kbs, processor))

    # ---- build: the Processor writes maindb and indexes; merge; sync ---------
    driver = Driver(f"{tmp}/find_kv.db")
    node_dir = f"{tmp}/find_node"
    app = stack(EmbeddedNode(node_dir, device=device))
    kbid = app.kbs.create(KnowledgeBoxConfig(slug="find", vectorsets={"m": VectorSetSpec(dimension=cfg["dim"])}))
    (sid,) = app.kbs.get_shards(kbid).shards
    app.node.configure_shards([{"shard_id": sid, "prewarm_enabled": True}])  # sync opens the searcher
    rows: dict = {}
    t = time.perf_counter()
    for r in range(R):
        app.processor.create_resource(kbid, find_payload(corpus, r, rows), rid=node_rid(r), created=1000.0 + r)
    t_ingest = time.perf_counter() - t
    t, rounds = time.perf_counter(), 0
    while True:
        stats = app.node.tick_background()
        rounds += 1
        if stats["jobs_enqueued"] == 0 and stats["merged"] == 0:
            break
    t_merge = time.perf_counter() - t
    t = time.perf_counter()
    check(app.node.wait_for_sync() == [sid], "sync did not open the shard")
    sync()
    t_sync = time.perf_counter() - t
    shard = app.node.searcher.shard(sid)
    vindex = shard.vectors["m"].index
    check(vindex.n_para == R * P and vindex.codes is not None and not vindex.host_resident(),
          "the vector leg is not on the int8 route over every paragraph")
    kb_bytes = os.path.getsize(f"{tmp}/find_kv.db")
    print(
        f"find build: {R} resources x {P} paragraphs ({R * P}, dim {cfg['dim']}) through the Processor on {device}: "
        f"{t_ingest:.1f}s ({R / t_ingest:.1f} resources/s, maindb {kb_bytes / 2**20:.0f} MiB); {rounds} background "
        f"rounds, merges {t_merge:.1f}s; sync {t_sync:.1f}s (p_pad {vindex.p_pad}); host WAND tier "
        f"{'on' if shard.paragraph.engine.host_tier() else 'off'}",
        flush=True,
    )

    reqs = [find_request(corpus, i) for i in range(n_req)]
    para_oracles = {}

    def check_paragraph_leg(shard_x, req, resp, what, mask=None):
        engine = shard_x.paragraph.engine
        oracle = para_oracles.setdefault(id(engine), KwOracle(engine))
        q = TextQuery(text=req.query, top_k=max(2 * FIND_TOP_K, 20), fuzzy=True)
        kw_check_hits(oracle, q, resp.paragraph.hits, _no_count(), f"{what}, paragraph leg", mask)

    def timed(search_x, requests):
        out, ms = [], []
        for req in requests:
            t = time.perf_counter()
            out.append(search_x.find(kbid, req))
            ms.append((time.perf_counter() - t) * 1e3)
        return out, ms

    # ---- the main path, counted: hybrid /find on both keyword routes ---------
    seen = find_capture(app.node)
    os.environ.pop("NDBTPU_TEXT_HOST_TIER", None)
    reset_launches(slot_scan, binary_scan)
    bm25.DISPATCHES.clear()
    default_out, default_ms = timed(app.search, reqs)
    default_counts = dict(slot_scan.LAUNCHES, **binary_scan.LAUNCHES, **bm25.DISPATCHES)
    default_resp = [r[0] for r in seen]
    os.environ["NDBTPU_TEXT_HOST_TIER"] = "0"  # set before the device-route node's searcher opens
    dev = stack(EmbeddedNode(node_dir, device=device))  # a second node over the same data directory
    shard_dev = dev.node.searcher.shard(sid)
    sync()
    seen_dev = find_capture(dev.node)
    reset_launches(slot_scan, binary_scan)
    bm25.DISPATCHES.clear()
    device_out, device_ms = timed(dev.search, reqs)
    device_counts = dict(slot_scan.LAUNCHES, **binary_scan.LAUNCHES, **bm25.DISPATCHES)
    device_resp = [r[0] for r in seen_dev]
    # ---------------------------------------------------------------------------
    check(len(default_resp) == len(device_resp) == n_req, "a /find did not make exactly one shard fan-out")
    if device == "cuda":  # on the CPU the wrappers take their plain versions, which count nothing
        check(default_counts.get("top2", 0) >= n_req, f"default route: the top-2 kernel launched {default_counts}")
        check(device_counts.get("top2", 0) >= n_req, f"device route: the top-2 kernel launched {device_counts}")
    check(device_counts.get("single", 0) + device_counts.get("batch", 0) >= n_req,
          f"device route: the BM25 program dispatched {device_counts}")
    check(shard_dev.paragraph.engine.host_tier() is None, "the device-route searcher kept the host tier")
    if shard.paragraph.engine.host_tier() is not None:
        check(default_counts.get("single", 0) + default_counts.get("batch", 0) == 0,
              f"default route: the host tier dispatched {default_counts}")
    check(all(default_counts.get(m, 0) == 0 and device_counts.get(m, 0) == 0 for m in ("top1", "binary")),
          "/find launched a kernel of another route")
    for name, shard_x, out, resp in (("default route", shard, default_out, default_resp),
                                     ("device route", shard_dev, device_out, device_resp)):
        for i, (req, res, r) in enumerate(zip(reqs, out, resp)):
            find_results_ok(res, f"{name}, find {i}")
            check(len(r.vector) == 2 * FIND_TOP_K, f"{name}, find {i}: the vector leg returned {len(r.vector)}")
            check_paragraph_leg(shard_x, req, r, f"{name}, find {i}")
    for i in range(n_req):
        find_same(default_out[i], device_out[i], find_tied(default_resp[i], device_resp[i]), KW_RTOL,
                  f"find {i}: default vs device route")
    for i in range(cfg["fusion"]):
        find_check_fusion(default_out[i], default_resp[i], f"find {i}, default route")
        find_check_fusion(device_out[i], device_resp[i], f"find {i}, device route")

    # ---- semantic-only requests against the exact f32 oracle -----------------
    n_sem = cfg["semantic"]
    q_dev = torch.from_numpy(corpus.q_np[:n_sem]).to(corpus.vecs.device)
    everything = torch.ones(R * P, dtype=torch.bool, device=corpus.vecs.device)
    oracle = exact_oracle(torch, corpus.vecs, everything, q_dev, TOP_K)
    sem_out = [app.search.find(kbid, find_request(corpus, i, query="", features=[SearchFeature.SEMANTIC]))
               for i in range(n_sem)]
    recall = float(np.mean([
        len({rows[b] for b in res.best_matches[:TOP_K]} & set(oracle[i].tolist())) / TOP_K
        for i, res in enumerate(sem_out)
    ]))
    check(recall >= RECALL_BAR, f"semantic /find recall@10 {recall} < {RECALL_BAR}")

    # ---- filters: a label filter_expression and security groups --------------
    rid_of_doc = {id(s): np.array([node_resource_of(k) for k in s.paragraph.engine.keys]) for s in (shard, shard_dev)}
    resources = np.arange(R)
    filtered = []
    for i in range(cfg["filtered"]):
        topic = FIND_TOPICS[i % 4]
        filtered.append((f"label /l/topic/{topic}", resources % 4 == i % 4,
                         find_request(corpus, i, filter_expression=FilterExpression(literal=f"/l/topic/{topic}"))))
    for i in range(cfg["secured"]):
        group = FIND_GROUPS[i % 2]
        allowed = np.array([not find_groups(r) or group in find_groups(r) for r in range(R)])
        filtered.append((f"security {group}", allowed, find_request(corpus, n_req - 1 - i, security_groups=[group])))
    filt_recall = []
    for name, search_x, shard_x, seen_x in (("default route", app.search, shard, seen),
                                            ("device route", dev.search, shard_dev, seen_dev)):
        for what, allowed, req in filtered:
            seen_x.clear()
            res = search_x.find(kbid, req)
            (resp,) = seen_x[0]
            what = f"{name}, {what}"
            find_results_ok(res, what)
            check(all(allowed[node_resource_of(rid)] for rid in res.resources), f"{what}: a resource outside the filter")
            check(all(allowed[node_resource_of(h.key)] for h in resp.vector)
                  and all(allowed[node_resource_of(h.paragraph_id)] for h in resp.paragraph.hits),
                  f"{what}: a hit outside the filter")
            engine = shard_x.paragraph.engine
            mask = engine.build_mask(TextQuery(text=req.query))[: engine.n_docs] & allowed[rid_of_doc[id(shard_x)]]
            check_paragraph_leg(shard_x, req, resp, what, mask)
            find_check_fusion(res, resp, what)
            alive = torch.from_numpy(np.repeat(allowed, P)).to(corpus.vecs.device)
            q = torch.from_numpy(np.asarray([req.vector], np.float32)).to(corpus.vecs.device)
            want = set(exact_oracle(torch, corpus.vecs, alive, q, TOP_K)[0].tolist())
            got = {rows["/".join(h.key.split("/")[:-2] + h.key.split("/")[-1:])] for h in resp.vector[:TOP_K]}
            filt_recall.append(len(got & want) / TOP_K)
    check(float(np.mean(filt_recall)) >= RECALL_BAR, f"filtered vector legs: recall@10 {np.mean(filt_recall)}")

    # ---- the card against the CPU, over the same maindb and segments ---------
    n_c = cfg["cpu"] if device == "cuda" else 0
    if n_c:
        cpu = stack(EmbeddedNode(node_dir, device="cpu"))  # NDBTPU_TEXT_HOST_TIER=0: the device route's program
        seen_cpu = find_capture(cpu.node)
        t = time.perf_counter()
        cpu_out = [cpu.search.find(kbid, r) for r in reqs[:n_c]]
        t_cpu = time.perf_counter() - t
        check(cpu.node.searcher.shard(sid).paragraph.engine.host_tier() is None, "the CPU searcher kept the host tier")
        for i, (a, b) in enumerate(zip(device_out, cpu_out)):
            tied = find_tied(device_resp[i], seen_cpu[i][0], rtol=NODE_CPU_RTOL)
            find_same(a, b, tied, NODE_CPU_RTOL, f"find {i}: card vs CPU")
        del cpu, cpu_out, seen_cpu
    else:
        t_cpu = 0.0
    os.environ.pop("NDBTPU_TEXT_HOST_TIER", None)

    # ---- timings, and threads: 8 threads against one after another -----------
    timings = {}
    for name, ms in (("default", default_ms), ("device", device_ms)):
        timings[f"find_p50_{name}"] = float(np.percentile(ms, 50))
        timings[f"find_p90_{name}"] = float(np.percentile(ms, 90))
    phases = {}  # SearchService's own per-phase seconds (debug=True), median of 16 requests, in ms
    for name, app_x in (("default", app), ("device", dev)):
        split = [app_x.search.find(kbid, find_request(corpus, i, debug=True)).timings for i in range(min(16, n_req))]
        phases[name] = {k: round(float(np.median([t[k] for t in split])) * 1e3, 3) for k in split[0]}
    if device == "cuda":
        for name, app_x in (("default", app), ("device", dev)):
            busy = device_busy_ms(torch, lambda: [app_x.search.find(kbid, r) for r in reqs[:16]]) / 16
            timings[f"device_busy_per_find_{name}"] = busy
            timings[f"device_idle_share_{name}"] = 1.0 - busy / timings[f"find_p50_{name}"]
    t_burst, t_seq = {}, {}
    for name, app_x, solo, resp in (("device", dev, device_out, device_resp), ("default", app, default_out, default_resp)):
        t = time.perf_counter()
        for r in reqs:  # the same requests one after another, warm
            app_x.search.find(kbid, r)
        t_seq[name] = (time.perf_counter() - t) * 1e3
        t_out, errors = [None] * n_req, []

        def worker(ix):
            try:
                for i in ix:
                    t_out[i] = app_x.search.find(kbid, reqs[i])
            except BaseException as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(range(w, n_req, cfg["threads"]),)) for w in range(cfg["threads"])]
        t = time.perf_counter()
        [th.start() for th in threads]
        [th.join(timeout=600) for th in threads]
        t_burst[name] = (time.perf_counter() - t) * 1e3
        check(not errors and all(x is not None for x in t_out), f"{name} route: threaded /find failed: {errors[:1]}")
        for i, res in enumerate(t_out):
            find_same(res, solo[i], find_tied(resp[i]), KW_RTOL, f"{name} route: threaded find {i} vs its solo answer")
    timings = {key: round(v, 3) for key, v in timings.items()}
    print(
        f"find requests: {n_req} hybrid /find (query + vector, top {FIND_TOP_K}, rrf) on each keyword route, every "
        f"answer hydrated from maindb, its paragraph leg equal to the float64 BM25 oracle, the routes equal up to ties; "
        f"counts default route {json.dumps(default_counts)}, device route {json.dumps(device_counts)}; {cfg['fusion']} "
        f"fused orders equal a plain RRF of their shard responses; semantic-only recall@10 {recall:.4f} over {n_sem}; "
        f"{cfg['filtered']} label-filtered and {cfg['secured']} security requests per route inside their filters, "
        f"paragraph legs equal to the masked oracle, vector legs recall@10 {np.mean(filt_recall):.4f} against the "
        f"masked exact oracle; card vs CPU on {n_c} requests equal within {NODE_CPU_RTOL} (CPU {t_cpu:.1f}s); "
        f"{n_req} requests from {cfg['threads']} threads equal their solo answers on both routes",
        flush=True,
    )
    print(
        f"find timings (host ms per /find over the counted pass of {n_req}; device busy ms per /find from "
        f"torch.profiler over 16, idle share against the p50): {json.dumps(timings)}; phases (ms, median of 16) "
        f"{json.dumps(phases)}; {n_req} requests one after "
        f"another (ms) {json.dumps({k: round(v, 1) for k, v in t_seq.items()})}, from {cfg['threads']} threads (ms) "
        f"{json.dumps({k: round(v, 1) for k, v in t_burst.items()})}; phase {time.perf_counter() - t_phase:.1f}s",
        flush=True,
    )
    del app, dev, shard, shard_dev, corpus
    if device == "cuda":
        torch.cuda.empty_cache()
    return SimpleNamespace(default=default_counts, device=device_counts)


def main() -> None:
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    from nucliadb_tpu_torch.ops import binary_scan, quant, slot_scan
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
    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc per source, together
        libs = list(pool.map(kernels.build, SOURCES))
    for src in SOURCES:
        kernels.load(src)
    print(f"build: {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t:.1f}s", flush=True)
    for line in ptxas_report(kernels, "int8_slot_scan"):
        print(f"ptxas int8_slot_scan.cu: {line}", flush=True)

    max_err, kernel_ms, plain_ms = phase_kernels(torch, slot_scan)
    print(
        f"kernel vs plain: bit-identical at {len(KERNEL_SHAPES)} shapes; at B,N,D,S={TIMED_SHAPE} "
        f"kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms",
        flush=True,
    )
    top1 = phase_top1_kernels(torch, slot_scan)
    for wrapper, (err, k_ms, p_ms) in top1.items():
        print(
            f"top-1 kernel vs plain ({wrapper}): bit-identical at {len(TOP1_SHAPES)} shapes; "
            f"at B,N,D,S={TOP1_TIMED[wrapper]} kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms",
            flush=True,
        )
    edge_err = phase_edge_kernels(torch, slot_scan)
    print(
        f"edge shapes: bit-identical at {sum(len(v) for v in EDGE_SHAPES.values())} shapes "
        f"(B in 1, 65, 2047; D in 64, 3072, 8192; N=65536; top-2 at S=32, top-1 at S=1024)",
        flush=True,
    )
    product_ms = product_library_ms(torch)
    print(f"torch._int_mm at B,N,D={TIMED_SHAPE[:3]} (the product alone, int32 out): {product_ms:.3f} ms", flush=True)
    bin_err, bin_ms, bin_plain_ms = phase_binary_kernel(torch, quant, binary_scan)
    print(
        f"binary kernel vs plain: bit-identical at {len(BINARY_SHAPES)} shapes; at B,N,D,S={BINARY_TIMED} "
        f"kernel {bin_ms:.3f} ms, plain {bin_plain_ms:.3f} ms",
        flush=True,
    )

    with tempfile.TemporaryDirectory() as tmp:
        corpus = Corpus(torch, tmp)
        searcher, top2_launches = phase_slice(torch, slot_scan, binary_scan, corpus)
        phase_breakdown(torch, searcher, corpus.q_np)
        del searcher
        torch.cuda.empty_cache()
        searcher, top1_launches = phase_int8_pallas_slice(torch, slot_scan, binary_scan, corpus)
        phase_int8_pallas_breakdown(torch, searcher, corpus.q_np)
        del searcher
        torch.cuda.empty_cache()
        searcher, binary_launches = phase_binary_slice(torch, slot_scan, binary_scan, corpus)
        phase_binary_breakdown(torch, searcher, corpus.q_np)
        del searcher
        corpus.free(torch)
    with tempfile.TemporaryDirectory() as tmp:
        phase_keyword(torch, tmp, KW_FULL)
    with tempfile.TemporaryDirectory() as tmp:
        node = phase_node(torch, tmp, NODE_FULL)
    with tempfile.TemporaryDirectory() as tmp:
        find = phase_find(torch, tmp, FIND_FULL)
    print(
        "note: int8_scan_slots_resident has no serving route in either package; its kernel is the "
        "top-1 mode of int8_slot_scan.cu, so its launches are that mode's on the int8 + pallas path",
        flush=True,
    )

    int8_src = "nucliadb_tpu_torch/csrc/int8_slot_scan.cu"
    top1_err, top1_ms, top1_plain = top1["int8_scan_slots"]
    res_err, res_ms, res_plain = top1["int8_scan_slots_resident"]
    entries = [  # name, source, replaces, launches, max_abs_err, ms, plain_ms, (bound_ms, bound_by)
        ("int8_scan_slots_resident2", int8_src, "nucliadb_tpu/ops/pallas_scan.py:350",
         top2_launches, max(max_err, edge_err[2]), kernel_ms, plain_ms, int8_bound_ms(*TIMED_SHAPE, 2)),
        ("int8_scan_slots", int8_src, "nucliadb_tpu/ops/pallas_scan.py:47",
         top1_launches, max(top1_err, edge_err[1]), top1_ms, top1_plain,
         int8_bound_ms(*TOP1_TIMED["int8_scan_slots"], 1)),
        ("int8_scan_slots_resident", int8_src, "nucliadb_tpu/ops/pallas_scan.py:213",
         top1_launches, res_err, res_ms, res_plain, int8_bound_ms(*TOP1_TIMED["int8_scan_slots_resident"], 1)),
        ("binary_scan_slots", "nucliadb_tpu_torch/csrc/binary_slot_scan.cu",
         "nucliadb_tpu/ops/pallas_scan.py:523", binary_launches, bin_err, bin_ms, bin_plain_ms,
         binary_bound_ms(*BINARY_TIMED)),
    ]
    rows = []
    for k, src, rep, n, err, k_ms, p_ms, (bound_ms, bound_by) in entries:
        mode = {"int8_scan_slots_resident2": "top2", "binary_scan_slots": "binary"}.get(k, "top1")
        row = {"name": k, "route": "cuda", "source": src, "replaces": rep, "launches": n,
               # launches on the node phase's and the /find phase's counted
               # paths (both keyword routes each)
               "node_launches": node.default.get(mode, 0) + node.device.get(mode, 0),
               "find_launches": find.default.get(mode, 0) + find.device.get(mode, 0),
               "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               # no single PyTorch call computes a slot table
               "library_ms": None, "share": bound_ms / k_ms}
        if src == int8_src:
            row["product_library_ms"] = product_ms  # torch._int_mm at TIMED_SHAPE: the product alone
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
