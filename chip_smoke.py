#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``nucliadb_tpu_torch``) on one card.

Run from the root of a checkout, on a machine with an NVIDIA card:

    python3 chip_smoke.py

It drives the port's vector-search paths, the semantic leg of /find, its
keyword leg, the index node, the product /find, the standalone HTTP
server, the opt-in ANN strategies, the beyond-HBM paged tiers,
multivector MaxSim, the mesh (the multi-shard groups and the
mesh-sharded indexes), component mode (the substrate, the gRPC planes
and the cluster's scatter-gather over searcher processes) and the ops path
(the tool and migrator CLIs, the SDK with spans exported over OTLP, a node
over S3-protocol storage) once at full size, in phases that each print one
line:

1. device: the card's name and power limit;
2. build: compiles every kernel of the paths from ``nucliadb_tpu_torch/csrc``
   (the int8 and binary slot scans and the BM25 program), one nvcc per
   source, all started together, and prints the int8 kernel's ``-Xptxas
   -v`` report (registers and spills of each instantiation);
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
   then paged: the same segments reopened with ``NDBTPU_VECTOR_ARENA_BUDGET``
   at 1 GiB (the ``host_rerank`` tier: 809.5 MB of int8 codes on the card,
   the f32 rows in host memory) and at 256 MiB (the ``stream`` tier: 16
   uploaded chunks of 65,536 rows). Counted on host_rerank: a batch of
   2048, a filtered, a min_score and a ``with_duplicates`` request; the
   top-2 kernel must launch for each, the device bytes of the open stay
   under the budget, recall@10 >= 0.95 and within 0.001 of the int8
   slice's. Stream: ids the exact oracle's up to ties within 1e-5, the
   filter and floor; each tier's open seconds, ms a batch, the card's busy
   ms and the bytes uploaded a batch;
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
   - on the device route every dispatch launches the BM25 program's hand
     kernel, ``csrc/bm25_program.cu``, once and its merge kernel once
     (``ops.bm25.LAUNCHES``); the launches a device-route request and the
     BM25 program's share of them (``torch.profiler``, no fewer than the
     wrappers counted; at most 9 a dispatch), the 64 threaded requests
     against the same one after another;
   - the kernel against its plain version at the OR 512, AND 512 and single
     request shapes, bit for bit (the rows mode's final rows, count rows,
     bitmaps or counts, and the cut path's cuts with their counts, bitmaps
     or match counts against ``ops/topk.py``'s cut of the whole rows), the
     merge kernel against its plain version on the kernel's tile cuts, the
     kernel's time on the cut path and in rows mode, the merge's, the plain
     program's, the whole program on the card, one ``index_add_`` of the
     batch's lanes as a yardstick (the scatter alone), the program's bound
     from this run's distinct rows, the tile width, tiles a row and the
     kernels' launches a dispatch;
   - a breakdown of the device program by stage (CUDA events) with the
     scatter's deterministic and atomic forms, host planning and hits, and
     whole batches on both routes;
   - a refresh adding 2,000 paragraphs: 3 groups reused, under a tenth of
     the first build's upload, answers bit-identical to a fresh build.
7. node: the index node end to end, ``EmbeddedNode(tmp, device="cuda")``
   with one shard of vectorset ``m`` (768-d, dot, int8): 680 resources of
   200 paragraphs (136,000, above the exact-scan threshold of 131,072 rows,
   so the int8 route; cut from 1,000 to keep the script inside its limit),
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
   8 of them answered by a searcher on the CPU over the same
   segments (equal within 1e-4); label, security, JSON ("and", "or"),
   key-prefix, creation-date and min_score filters, a graph and a document
   request; a deletion, then a delta of 20 resources (the arena extended
   in place, the paragraph group reused, answers equal to a fresh
   searcher's).
8. find: (with the node phase running beside it in a child interpreter,
   whose lines print after this phase's) the product ``/find`` in process, ``SearchService`` over
   ``KnowledgeBoxManager``, the ``Processor`` and the sqlite maindb, on an
   ``EmbeddedNode(tmp, device="cuda")``: one knowledge box with vectorset
   ``m`` (768-d, dot, int8) holding the node phase's 680 resources of 200
   paragraphs, each written through ``Processor.create_resource`` as an
   API payload (the paragraphs as one text field, an embedding per
   paragraph, labels of two labelsets, an access group on two resources in
   five); merge rounds, sync. Then, counted: 64 hybrid ``FindRequest``s
   (query + vector, top-20, rank fusion "rrf") on the default keyword route
   and again on the device route (``NDBTPU_TEXT_HOST_TIER=0`` before a
   second node opens): the top-2 kernel must launch for every vector leg;
   each paragraph leg equals the float64 BM25 oracle, the routes agree up
   to ties, 16 fused orders equal a plain RRF recomputed from their shard
   responses. Then 32 semantic-only requests (recall@10 >= 0.95 against the
   exact f32 oracle); 8 label-filtered and 8 security requests per route
   held to an oracle of the corpus's labels and groups (their paragraph
   legs to the masked BM25 oracle, their vector legs to the masked exact
   oracle); 8 requests through a ``SearchService`` over a node on the CPU
   (the same maindb and segments, equal within 1e-4); the /find p50 and
   p90 per route, the device's busy share and phase split over 8, and 16
   requests from 8 threads (each its solo answer) against the same 16 one
   after another.
9. http: the standalone server over the /find phase's directory
   (``maindb.db`` and ``node/``, no second knowledge box).
   ``StandaloneApp(data_dir, port=0, device="cuda")`` served on an
   event-loop thread with ``start_background(15)`` as the CLI starts it
   (boot seconds with the migrations; no rollover: the shard is the same);
   the kernel warm-up is waited for before counting. Boot A, the default
   keyword route, counted: the 64 hybrid ``FindRequest``s dumped to JSON by
   alias, posted from one keep-alive ``httpx`` client, each equal to the
   /find phase's in-process answer (ties, scores within 1e-5); top-2
   launches >= 64, no top-1 or popcount launch, no BM25 dispatch while the
   host tier is on. Client p50/p90 and response bytes, the server's
   ``debug=True`` split of 16 requests against the client's clock on each
   (what its phases leave of the client's ms is the HTTP layer's cost), the
   card's busy ms per /find (``torch.profiler``). 32 keep-alive clients send the 64 twice (each its
   solo answer): QPS, p50, p95. Boot B, the device route
   (``NDBTPU_TEXT_HOST_TIER=0``), a restart over the same directory: the
   same counted requests (BM25 dispatches >= 64) and timings; 16 new
   resources written over HTTP, each /find's top hit for one of its own
   vectors within a deadline, one deleted and gone. Then the CLI,
   ``python3 -m nucliadb_tpu_torch.standalone.run --device cuda``, as a
   subprocess: ready within a deadline, its /find equal to B's, vector
   coalescer dispatches > 0 in its ``/metrics``, SIGTERM, no traceback on
   its stderr.
10. ann: (in a child interpreter of its own beside the /find phase, like
   the node phase) the ``hnsw`` and ``ivf`` flags at BASELINE config 1's
   shape: 100,000 x 768 rows of ``tools/hnsw_build_bench.py``'s clustered
   recipe from ``SEED`` (rows 1 and 2 copies of row 0, the labels
   "/l/thirty" on 30 % and "/l/five" on 5 % of rows), 1,024 queries (rows
   plus noise) in batches of 64, top-10, dot. HNSW: ``create_segment`` on
   the card (the build timed, the host linker's share of it), a searcher
   opens it with ``hnsw.BUILDS`` unchanged, the counted walks (one per
   batch, no slot scan) reach recall@10 >= 0.95 against the exact oracle
   at the default regime (trips a walk, ms a batch, the card's busy
   share); the 30 % filter walks (recall >= 0.8 against the filtered
   oracle), the 5 % filter scans (>= 0.99); ``with_duplicates=False``
   keeps one of the three copies; a CPU searcher over the same files
   agrees (recall within 0.005, scores within 1e-4); two segments of
   50,000 stitched (``n_segments == 2``, recall >= 0.9). IVF: k-means
   timed at create, none at open (``ivf.KMEANS``), recall@10 at nprobe 16,
   ms a batch, the filters and the dedup. The node: ``EmbeddedNode(tmp,
   device="cuda")`` with a vectorset flagged ``hnsw``, 100 resources x 200
   paragraphs of the node phase's corpus indexed, merged (the merged
   graph built on the card) and synced; 16 hybrid requests whose vector
   legs walk the graph, held to the exact oracle (recall@10 >= 0.9) and
   the BM25 oracle.
11. multi: (in a child interpreter of its own beside the /find phase) a
   ColBERTv2-shaped late-interaction vectorset (Santhanam et al., 2022:
   128-d token vectors, queries of 32 tokens, passages of up to 180):
   50,000 paragraphs of 32-180 normalised token vectors from ``SEED``
   (p_pad 65,536, m_max 192, a 6.44 GB f32 slot arena on the card), two
   segments plus a deletion, paragraphs 1 and 2 copies of paragraph 0's
   block, a label on every tenth. Counted: a batch of 8 queries x 32
   tokens, 8 single vectors, a label filter, ``with_duplicates`` and a
   floor, each held to a float64 MaxSim oracle on the host (ids up to ties
   and scores within 1e-4); ms a batch and a single vector, the card's
   busy ms, the peak memory. Then a knowledge box whose vectorset is
   multivector, 100 resources x 20 paragraphs x 8-32 token vectors through
   the ``Processor``, merged and synced, answering 16 semantic /find
   requests with one query vector, each semantic hit its paragraph's
   float64 MaxSim.
12. mesh: (after the paged tiers, over the slices' corpus) the port's
   ``parallel/`` on a 4-member mesh of the one card (``make_mesh(4)``
   repeats it): ``MeshVectorGroup`` over the 4 segments as 4 shards of
   250,000 x 768 int8 (bench_suite.py's bench_scatter4 shape), counted: a
   batch of 64 and one of 2048, 4 top-2 launches each; every member's cut
   equal to its shard's own ``search`` bit for bit (and label-filtered), the
   merged recall@10 >= 0.95 on the 1,024-query oracle; the group's and 4
   sequential calls' ms, the card's busy ms, the group's own device bytes
   and the all-gather merge's ms. An uneven group (500,000 / 250,000 /
   250,000 rows, members padded, a padded member slot) bit for bit.
   ``MeshShardedVectorIndex`` over the 1M on a (4, 1) mesh: exact (the
   global oracle's ids up to ties) and int8 (recall@10 >= 0.95).
   The keyword half (the host tier off): 4 paragraph shards of 250,000 of
   config 3's corpus; ``MeshTextGroup`` on 32 requests equal to each
   shard's own search (hits, scores, totals), ``MeshShardedTextEngine``
   equal to the engines' merged cuts up to ties, ``MeshHybridIndex`` over
   the aligned (vector, text) shards equal to a host RRF of its two merged
   cuts. Then ``search_multi`` over an ``EmbeddedNode``'s 4 shards (40
   resources x 200 paragraphs, the int8 threshold lowered in process, the
   device listing replaced as the tests replace it) on both keyword routes:
   the mesh branch's responses equal the per-shard path's, 4 top-2 launches
   a request.

13. cluster: (after the HTTP phase, over the same files) component mode,
   each component a process of the port's runner (``python -m
   nucliadb_tpu_torch.component.run``): S, ``substrate --serve-substrate``
   over the /find phase's metadata, blobs and maindb (linked where the
   substrate opens them; the default ``--device cuda``, which a
   substrate-only process never resolves); W, ``writer ingest scheduler
   worker --substrate S --device cuda``; C1 and C2, ``searcher --substrate
   S --topology FILE --node-name c1|c2 --device cuda``, each with its own
   data directory, both owning the shard (replication 2). Each child
   reports its launch counters and CUDA state on SIGUSR1. Seconds until
   each replica answers (its sync of 136,000 paragraphs over the
   substrate included); counted: the node phase's 64 hybrid requests
   through ``DistributedSearcher`` (a ``TopologyWatcher`` over the same
   file, one ``NodeClient`` a replica), each equal to an in-process
   ``EmbeddedNode(tmp/node, device="cuda")``'s answer (ties, scores within
   1e-5), vector recall@10 >= 0.95 against the exact f32 oracle; the
   top-2 kernel launched once a vector leg in the primary replica and
   never in the other; one request over ``NidxSearcher``'s protobuf wire
   equal to its msgpack answer; the 64 from 8 client threads, each its
   solo answer; ``nvidia-smi``'s compute apps (the substrate process
   holds no CUDA context); the primary SIGKILLed after 16 answers of a
   threaded burst: every request answered by the other (its launches
   grow), no ``ShardError``, the same answers, the slowest request
   across the kill; a resource written through ``WriterClient`` until it
   is the top hit, under a deadline; client p50/p90 against the
   in-process node's, the gRPC layer's ms, each process's boot seconds.
14. ops: (after the cluster phase, over the same files) the ops path.
   ``python -m nucliadb_tpu_torch.tool --device cuda list-kbs`` and
   ``shards <kbid>`` (the vector index with at least the 136,000
   paragraphs, the shard writable) and ``python -m
   nucliadb_tpu_torch.migrator --device cuda --dry-run`` (nothing pending:
   the HTTP phase's boot ran the migrations) as subprocesses started
   together, each timed; meanwhile ``tests/cloud_fakes.py``'s S3 fake
   (SigV4 checked on every request), loaded by path, gets every object of
   the node's blob store through ``make_storage(StorageSettings(
   backend="s3", ...))`` from 8 threads. Then an OTLP/HTTP sink on
   127.0.0.1 and ``NDBTPU_TELEMETRY__OTLP`` pointing at it, the server
   booted as the HTTP phase boots it (default keyword route): 16 of the
   /find phase's requests over raw ``httpx``, then, counted, the same 16
   through the port's ``NucliaDBClient.find`` (16 top-2 launches), each
   equal to the raw answer (ties, scores within 1e-5); the exporter shut
   down and the sink's bodies decoded with the port's wire codec: 32
   ``search.find`` spans, each with its ``kbid`` and a 32-hex trace id;
   the 16 over raw ``httpx`` once more, untraced, so that two raw passes
   bracket the SDK's, and the three client p50s. Last, the metadata
   copied with sqlite's backup API and an ``EmbeddedNode(...,
   storage=<S3>, device="cuda")`` with no local blob store synced over
   signed GETs; counted, 16 of the node phase's hybrid
   shard requests (16 top-2 launches), each equal to a node's over the
   local files (ties, scores within 1e-5); the bytes and GETs served and
   the seconds from construction to the first answer. The phase must stay
   within 60 s.

The node, /find and HTTP phases' counted paths and the mesh phase check
that every BM25 dispatch on the card launched ``bm25_program.cu`` once; the
node phase also prints the launches a hybrid request on each route and
the threaded bursts against the same requests one after another. The
/find phase also holds the kernel bit for bit against its plain version
at its device-route engine's shape, and the mesh phase the single-arena
program (``MeshShardedTextEngine``'s) on member 0's own arena at its
shard's shape: final rows, count rows, bitmaps and cuts.

It then prints each phase's wall seconds, the kernels' JSON line (each
kernel's launches on its path and on the node, /find, HTTP, paged, mesh,
cluster and ops phases' counted paths, times, bound from this run's shapes
and its share of it; the BM25 program's and its merge's at the OR batch of
512; it fails if a kernel of the main path launched no time there)
and, last,
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
SOURCES = ("int8_slot_scan", "binary_slot_scan", "bm25_program")
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

    def __init__(self, torch, tmp, device="cuda"):
        from nucliadb_tpu_torch.index.vector import (
            Elem, Seq, SimpleOpenIndex, VectorConfig, create_segment,
        )

        t0 = time.perf_counter()
        self.vecs, self.queries = make_corpus(torch, N_ROWS, DIM, BATCH, device)
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
    corpus.resident_int8 = {"recall": recall, "ms": ms}  # phase_paged's yardstick
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
# the paged tiers: the slices' corpus reopened under an arena budget
# ---------------------------------------------------------------------------

PAGED_BUDGETS = {"host_rerank": 1 << 30, "stream": 256 << 20}  # NDBTPU_VECTOR_ARENA_BUDGET of each tier
PAGED_TIE_RTOL = 1e-5  # exact tiers: an id may differ from the oracle's only within this of its 10th score


def paged_searcher(torch, corpus, budget, device):
    """``VectorSearcher(..., device=device)`` over the slices' segments with
    ``NDBTPU_VECTOR_ARENA_BUDGET = budget``; (searcher, open s, device bytes
    the open added)."""
    import os

    from nucliadb_tpu_torch.index.vector import VectorConfig, VectorSearcher

    before = torch.cuda.memory_allocated()
    os.environ["NDBTPU_VECTOR_ARENA_BUDGET"] = str(budget)
    try:
        t = time.perf_counter()
        searcher = VectorSearcher(VectorConfig(dimension=DIM), corpus.open_index, device=device)
        t_open = time.perf_counter() - t
    finally:
        del os.environ["NDBTPU_VECTOR_ARENA_BUDGET"]
    return searcher, t_open, torch.cuda.memory_allocated() - before


def check_exact_up_to_ties(torch, corpus, hits, what) -> None:
    """Each query's ids are its exact top-10 (``corpus.oracle``) but for ids
    whose exact score lies within ``PAGED_TIE_RTOL`` of the oracle's 10th."""
    q = corpus.queries[: len(hits)]
    for r, row in enumerate(hits):
        got = [int(h.key.split("/")[0][1:]) * 10 + int(h.key.split("/")[2]) for h in row]
        want = corpus.oracle[r].tolist()
        if set(got) == set(want):
            continue
        exact = (corpus.vecs[torch.tensor(got + want, device=q.device)] @ q[r]).cpu().numpy()
        thr = exact[len(got):].min()
        check(bool((exact[: len(got)] >= thr - PAGED_TIE_RTOL * abs(thr)).all()),
              f"{what}: query {r} is not its exact top-{TOP_K} up to ties")


def host_rerank_breakdown(torch, idx, q_np, device) -> dict:
    """host_rerank's layers at a batch of ``BATCH``: ``candidates`` is
    ``_int8_candidates`` (quantise, the top-2 scan, slot top-c) on the card
    (CUDA events), ``candidates_fetched`` the same with its fetch (host
    clock); then on the host the candidate rows' ``gather``, the ``dedup``
    hash and the whole ``host_rerank_cut`` (gather, einsum, dedup, sort)."""
    from nucliadb_tpu_torch.index.vector import device as dv
    from nucliadb_tpu_torch.ops import quant
    from nucliadb_tpu_torch.utils.platform import device_fetch

    q = torch.from_numpy(q_np).to(device)
    mask = torch.from_numpy(idx.base_mask()).to(device)
    budget = quant.int8_rerank_budget(TOP_K)
    (cand,) = device_fetch(dv._int8_candidates(idx.codes, q, budget, mask))
    rows = idx.vectors_host[np.maximum(cand, 0)]
    timer = cuda_ms if device == "cuda" else host_ms
    out = {
        "candidates": timer(lambda: dv._int8_candidates(idx.codes, q, budget, mask), 5),
        "candidates_fetched": host_ms(lambda: device_fetch(dv._int8_candidates(idx.codes, q, budget, mask)), 3),
        "gather": host_ms(lambda: idx.vectors_host[np.maximum(cand, 0)], 3),
        "dedup": host_ms(lambda: dv._host_duplicate_mask(rows, cand >= 0), 3),
        "host_rerank_cut": host_ms(lambda: idx._host_rerank_cut(q_np, cand, TOP_K, None, True), 3),
    }
    print(f"breakdown host_rerank (ms, batch {q_np.shape[0]}, {cand.shape[1]} candidates a query): "
          f"{json.dumps({k: round(v, 3) for k, v in out.items()})}", flush=True)
    return out


def stream_breakdown(torch, idx, q_np, device) -> dict:
    """stream's layers at a batch of ``BATCH``, per chunk: ``upload`` of one
    chunk from pageable host memory (host clock until it is on the card)
    and ``chunk_topk`` (``_stream_chunk_topk`` at the dedup's 2k + 8,
    CUDA events); then ``host_rerank_cut`` over 2k + 8 candidates a query
    (host clock); ``upload_gb_per_s`` from the chunk's bytes."""
    from nucliadb_tpu_torch.index.vector import device as dv
    from nucliadb_tpu_torch.utils.platform import device_fetch

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    chunk = idx.vectors_host[: idx.chunk_rows]
    q = torch.from_numpy(q_np).to(device)
    m = torch.ones(idx.chunk_rows, dtype=torch.bool, device=device)
    k2 = 2 * TOP_K + 8

    def upload():
        t = torch.from_numpy(chunk).to(device)
        sync()
        return t

    chunk_t = upload()
    _, cand = device_fetch(*dv._stream_chunk_topk(chunk_t, q, m, k2))
    timer = cuda_ms if device == "cuda" else host_ms
    out = {
        "upload": host_ms(upload, 3),
        "chunk_topk": timer(lambda: dv._stream_chunk_topk(chunk_t, q, m, k2), 3),
        "host_rerank_cut": host_ms(lambda: idx._host_rerank_cut(q_np, cand, TOP_K, None, True), 3),
    }
    out["upload_gb_per_s"] = chunk.nbytes / out["upload"] / 1e6
    print(f"breakdown stream (ms, batch {q_np.shape[0]}, one chunk of {idx.chunk_rows} x "
          f"{idx.p_pad // idx.chunk_rows}): {json.dumps({k: round(v, 3) for k, v in out.items()})}", flush=True)
    return out


def phase_paged(torch, slot_scan, binary_scan, corpus, device="cuda"):
    """The slices' 1M x 768 corpus reopened under ``PAGED_BUDGETS``: 1 GiB
    holds the int8 codes (809.5 MB at p_pad 1,048,576), not the f32 arena
    (3.22 GB), so ``host_rerank``; 256 MiB holds neither, so ``stream`` in
    chunks of 65,536 rows. Returns the top-2 and the BM25 kernel's launches
    of the counted run."""
    from nucliadb_tpu_torch.index.vector import LabelAtom, VectorSearchRequest
    from nucliadb_tpu_torch.ops import bm25

    q_np = corpus.q_np
    out = {}

    def busy_ms(fn):
        return device_busy_ms(torch, fn) if device == "cuda" else float("nan")

    # ---- host_rerank -------------------------------------------------------
    searcher, t_open, added = paged_searcher(torch, corpus, PAGED_BUDGETS["host_rerank"], device)
    idx = searcher.index
    check(idx.paging == "host_rerank" and idx.vectors is None, f"1 GiB opened tier {idx.paging}")
    check(added < PAGED_BUDGETS["host_rerank"], f"host_rerank holds {added} device bytes, over its budget")
    # ---- the main path, counted -----------------------------------------
    reset_launches(slot_scan, binary_scan, bm25)
    batch_hits = searcher.search(VectorSearchRequest(vectors=q_np, top_k=TOP_K))
    filt_hits = searcher.search(VectorSearchRequest(vectors=q_np[:64], top_k=TOP_K, filter=LabelAtom("/l/tenth")))
    floor_hits = searcher.search(VectorSearchRequest(vectors=q_np[64:80], top_k=TOP_K, min_score=0.9))
    dup_hits = searcher.search(VectorSearchRequest(vectors=q_np[:64], top_k=TOP_K, with_duplicates=True))
    launches = dict(slot_scan.LAUNCHES, **binary_scan.LAUNCHES)
    bm25_launches = bm25.LAUNCHES.total()  # the BM25 kernels' (program, merge): a vector-only path has none
    # ----------------------------------------------------------------------
    check(launches.get("top2", 0) >= 4, f"top-2 slot-scan kernel launched {launches} on the host_rerank path")
    check(launches.get("top1", 0) == 0 and launches.get("binary", 0) == 0, f"host_rerank launched {launches}")
    check_batch(batch_hits, BATCH, "host_rerank")
    recall = recall_at_k(batch_hits[:ORACLE_QUERIES], corpus.oracle)
    resident = corpus.resident_int8
    check(recall >= RECALL_BAR and abs(recall - resident["recall"]) <= 0.001,
          f"host_rerank recall@10 {recall} (resident int8 {resident['recall']})")
    check_filter_and_floor(searcher, filt_hits, floor_hits, q_np[64:80], "host_rerank")
    # the corpus repeats no row, so the dedup drops nothing
    check([[h.key for h in r] for r in dup_hits] == [[h.key for h in r] for r in batch_hits[:64]],
          "host_rerank: with_duplicates=True differs on a corpus without repeated rows")
    ms, times = median_ms(lambda: searcher.search(VectorSearchRequest(vectors=q_np, top_k=TOP_K)), 3)
    busy = busy_ms(lambda: searcher.search(VectorSearchRequest(vectors=q_np, top_k=TOP_K)))
    upload = q_np.nbytes + idx.p_pad  # the queries and the mask, from the shapes
    out["host_rerank"] = {"open_s": t_open, "device_bytes": added, "recall": recall, "ms": ms, "busy_ms": busy,
                          "upload_bytes": upload, "launches": launches.get("top2", 0)}
    print(
        f"paged host_rerank: budget {PAGED_BUDGETS['host_rerank']} B, open {t_open:.1f}s, device bytes {added}; "
        f"recall@10 {recall:.4f} (resident int8 {resident['recall']:.4f}); batch {BATCH} {ms:.2f} ms "
        f"(median of 3: {', '.join(f'{t:.2f}' for t in times)}; resident int8 {resident['ms']:.2f} ms), "
        f"card busy {busy:.3f} ms ({busy / ms:.3f} of it); uploaded {upload} B a batch; launches {launches}",
        flush=True,
    )
    out["host_rerank"]["breakdown"] = host_rerank_breakdown(torch, idx, q_np, device)
    del searcher, idx
    torch.cuda.empty_cache()
    # ---- stream ------------------------------------------------------------
    searcher, t_open, added = paged_searcher(torch, corpus, PAGED_BUDGETS["stream"], device)
    idx = searcher.index
    chunks = idx.p_pad // idx.chunk_rows if idx.paging == "stream" else 0
    check(idx.paging == "stream" and idx.codes is None and chunks >= 2
          and idx.chunk_rows * DIM * 4 <= PAGED_BUDGETS["stream"],
          f"256 MiB opened tier {idx.paging} (chunk_rows {getattr(idx, 'chunk_rows', None)})")
    reset_launches(slot_scan, binary_scan)
    stream_hits = searcher.search(VectorSearchRequest(vectors=q_np, top_k=TOP_K))
    filt_hits = searcher.search(VectorSearchRequest(vectors=q_np[:64], top_k=TOP_K, filter=LabelAtom("/l/tenth")))
    floor_hits = searcher.search(VectorSearchRequest(vectors=q_np[64:80], top_k=TOP_K, min_score=0.9))
    launches = dict(slot_scan.LAUNCHES, **binary_scan.LAUNCHES)
    check(not any(launches.values()), f"the stream tier launched a slot scan: {launches}")
    check_batch(stream_hits, BATCH, "stream")
    check_exact_up_to_ties(torch, corpus, stream_hits[:ORACLE_QUERIES], "stream")
    check_filter_and_floor(searcher, filt_hits, floor_hits, q_np[64:80], "stream")
    s_recall = recall_at_k(stream_hits[:ORACLE_QUERIES], corpus.oracle)
    s_ms, s_times = median_ms(lambda: searcher.search(VectorSearchRequest(vectors=q_np, top_k=TOP_K)), 3)
    s_busy = busy_ms(lambda: searcher.search(VectorSearchRequest(vectors=q_np, top_k=TOP_K)))
    s_upload = idx.p_pad * DIM * 4 + idx.p_pad + q_np.nbytes  # every chunk, its masks, the queries
    out["stream"] = {"open_s": t_open, "device_bytes": added, "recall": s_recall, "ms": s_ms, "busy_ms": s_busy,
                     "upload_bytes": s_upload, "chunks": chunks}
    print(
        f"paged stream: budget {PAGED_BUDGETS['stream']} B, open {t_open:.1f}s, {chunks} chunks of "
        f"{idx.chunk_rows}; ids the exact oracle's up to ties on {ORACLE_QUERIES} queries (recall@10 "
        f"{s_recall:.4f}); batch {BATCH} {s_ms:.2f} ms (median of 3: {', '.join(f'{t:.2f}' for t in s_times)}), "
        f"card busy {s_busy:.3f} ms ({s_busy / s_ms:.3f} of it); uploaded {s_upload} B a batch",
        flush=True,
    )
    out["stream"]["breakdown"] = stream_breakdown(torch, idx, q_np, device)
    print(f"paged numbers: {json.dumps(out)}", flush=True)
    return out["host_rerank"]["launches"], bm25_launches


# ---------------------------------------------------------------------------
# the mesh: the multi-shard groups and the mesh-sharded indexes
# ---------------------------------------------------------------------------

MESH_FULL = {
    "members": 4,  # bench_suite.py's bench_scatter4: 4 shards, on a 4-member mesh of one card
    "batches": (64, 2048),
    "kw_paragraphs": 250_000,  # a keyword shard (4 x 250,000 = 1,000,000 paragraphs of config 3)
    "kw_requests": 32,  # paragraph requests through the text group
    "kw_engine_queries": 16,  # queries through MeshShardedTextEngine and MeshHybridIndex
    "hybrid_batch": 64,
    "node_resources": 40,  # 10 a shard x 200 paragraphs, written by the port's node
    "node_threshold": 1024,  # EXACT_SCAN_THRESHOLD lowered in process: 2,000-paragraph shards take the int8 route
    "node_requests": 16,
}
MESH_TOP_K = TOP_K


def mesh_merge_host(scores, ids, offsets, k):
    """The members' [S, B, k] cuts merged on the host: global ids
    (``offsets[s]`` + local), the k best of each row, the earlier member
    first among equal scores."""
    s_all = np.concatenate([scores[s] for s in range(len(offsets))], axis=1)
    i_all = np.concatenate([np.where(ids[s] >= 0, ids[s] + offsets[s], -1) for s in range(len(offsets))], axis=1)
    order = np.argsort(-s_all, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s_all, order, 1), np.take_along_axis(i_all, order, 1)


def mesh_recall(ids, oracle) -> float:
    return float(np.mean([len(set(ids[r].tolist()) & set(oracle[r].tolist())) / TOP_K for r in range(len(oracle))]))


def mesh_exact_up_to_ties(vecs_np, q_np, ids, oracle_ids, what, rtol=PAGED_TIE_RTOL) -> None:
    """Each row's ids are the oracle's, but for ids whose float64 score lies
    within ``rtol`` of the oracle's 10th."""
    for r in range(len(oracle_ids)):
        got, want = set(ids[r].tolist()), set(oracle_ids[r].tolist())
        if got == want:
            continue
        q = q_np[r].astype(np.float64)
        tenth = float(vecs_np[int(oracle_ids[r][-1])].astype(np.float64) @ q)
        for i in got ^ want:
            s = float(vecs_np[int(i)].astype(np.float64) @ q)
            check(abs(s - tenth) <= rtol * abs(tenth) + 1e-6, f"{what}: row {r} id {i} outside the ties of the 10th")


def group_kernel_check(torch, slot_scan, group, i, masks, q_np, what) -> dict:
    """Member ``i``'s top-2 slot table as the group computes it (the group's
    own codes, scale and mask, its bucketed and quantized queries), kernel
    against plain version, bit for bit."""
    from nucliadb_tpu_torch.ops import quant
    from nucliadb_tpu_torch.ops.distance import prepare_query
    from nucliadb_tpu_torch.utils.buckets import bucket

    dev, codes = group.devices[i], group.codes[i]
    qp = np.zeros((bucket(q_np.shape[0], minimum=8), q_np.shape[1]), np.float32)
    qp[: q_np.shape[0]] = q_np
    qc, _ = quant.quantize_rows(prepare_query(torch.from_numpy(qp).to(dev), group.similarity))
    args = (qc, codes.codes, codes.scale, torch.from_numpy(masks[i]).to(dev))
    same, err = same_table(torch, slot_scan.int8_scan_slots_resident2(*args),
                           slot_scan.int8_scan_slots_resident2_reference(*args))
    b, n = qc.shape[0], codes.codes.shape[0]
    check(same, f"{what}: member {i}'s top-2 kernel differs from its plain version at B={b}, N={n} "
                f"(max |diff| {err})")
    return {"b": b, "n": n, "max_abs_err": err}


def mesh_arena_check(torch, tmesh, queries) -> float:
    """The single-arena program of ``MeshShardedTextEngine`` against its
    plain version on member 0's own tiers, dense block and masks at its
    shard's shape, bit for bit: one launch over the member's layout (the
    DENSE_DIRECT base block) against ``engine._bm25_arena_final_plain``
    (final rows, count rows, bitmaps), and the cuts of ``_bm25_arena``
    against ``_bm25_arena_plain``, for ``queries`` as one batch and the
    first alone. Returns the largest |difference|."""
    from nucliadb_tpu_torch.index.text_engine import engine as teng
    from nucliadb_tpu_torch.ops import bm25

    t0 = time.perf_counter()
    dev = tmesh.devices[0]
    tiers, dense, dlen = tmesh.arenas[0]
    layout = tmesh.layouts[0]
    inputs = [tmesh.member_inputs(q)[0] for q in queries]
    err = 0.0
    for name, batch in ((f"batch of {len(inputs)}", inputs), ("single", inputs[:1])):
        rows, idfs, params, masks = (torch.from_numpy(np.stack([x[i] for x in batch])).to(dev) for i in range(4))
        got = bm25.launch_program(layout, tmesh.caps, masks, rows, idfs, params, True, False)[:3]
        want = teng._bm25_arena_final_plain(tiers, dense, None, dlen, masks, rows, idfs, params, tmesh.caps, 0, True)
        err = max(err, bm25_same(torch, got, want, f"mesh arena kernel, {name}"))
        del got, want
        k = queries[0].top_k
        kern = teng._bm25_arena(tiers, dense, None, dlen, masks, rows, idfs, params, k, tmesh.caps, 0, True,
                                layout=layout)
        plain = teng._bm25_arena_plain(tiers, dense, None, dlen, masks, rows, idfs, params, k, tmesh.caps, 0, True)
        err = max(err, bm25_same(torch, kern, plain, f"mesh arena program, {name}"))
    print(f"bm25 kernel vs plain, mesh arena (member 0, n_pad {dlen.shape[0]}, caps {tmesh.caps}): a batch of "
          f"{len(inputs)} and a single query, bit-identical final rows, counts, bitmaps and cuts "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return err


def phase_mesh(torch, slot_scan, corpus, tmp, cfg, device="cuda"):
    """The mesh on one card (see the module docstring): the vector group at
    bench_scatter4's shape over the slices' corpus, an uneven group, the
    sharded index (exact and int8), the keyword group, the sharded keyword
    and hybrid indexes, and ``search_multi``'s mesh branch over a node's 4
    shards. Returns the top-2 launches of the counted vector group run, the
    BM25 kernel's launches of the counted text group run and the largest
    |difference| of the arena kernel from its plain version (None on the
    CPU)."""
    import os

    import nucliadb_tpu_torch.index.vector.device as vdevice
    from nucliadb_tpu_torch.index.paragraph import ParagraphSearcher, ParagraphSearchRequest
    from nucliadb_tpu_torch.index.text_engine import TextQuery
    from nucliadb_tpu_torch.index.text_engine.builder import DocEntry, build_segment
    from nucliadb_tpu_torch.index.vector import (
        LabelAtom, Quantization, Seq, Similarity, SimpleOpenIndex, VectorConfig, VectorSearcher,
    )
    from nucliadb_tpu_torch.ops import bm25
    from nucliadb_tpu_torch.ops.topk import sharded_topk_allgather
    from nucliadb_tpu_torch.parallel import MeshHybridIndex, MeshShardedTextEngine, MeshShardedVectorIndex, make_mesh
    from nucliadb_tpu_torch.parallel import hybrid_mesh
    from nucliadb_tpu_torch.parallel import mesh as pmesh
    from nucliadb_tpu_torch.parallel.group import MeshVectorGroup
    from nucliadb_tpu_torch.parallel.text_group import MeshTextGroup

    cuda = device == "cuda"
    members = cfg["members"]
    grid = make_mesh(members, device=device)  # (shard, query) = (members, 1), one card repeated
    mesh1d = pmesh.Mesh(grid.devices.reshape(-1), ("shard",))
    out = {}

    def busy_ms(fn):
        return device_busy_ms(torch, fn) if cuda else float("nan")

    def allocated():  # on every card the members may live on
        return sum(torch.cuda.memory_allocated(i) for i in range(torch.cuda.device_count())) if cuda else 0

    # ---- the vector group: 4 shards of the slices' segments ----------------
    vcfg = VectorConfig(dimension=DIM, similarity=Similarity.DOT, quantization=Quantization.INT8)
    segs, dels = corpus.open_index.segment_list, corpus.open_index.deletion_list
    check(len(segs) == members, f"{len(segs)} segments for {members} members")
    per_seg = N_ROWS // N_SEGMENTS

    def shard(seg_ids):
        return VectorSearcher(vcfg, SimpleOpenIndex(segment_list=[segs[i] for i in seg_ids], deletion_list=dels),
                              device=device)

    t = time.perf_counter()
    shards = [shard([s]) for s in range(members)]
    t_open = time.perf_counter() - t
    check(all(isinstance(sh.index.codes, vdevice.quant.Int8Codes) for sh in shards), "a shard without int8 codes")
    before = allocated()
    t = time.perf_counter()
    group = MeshVectorGroup(shards, mesh1d)
    t_group = time.perf_counter() - t
    group_bytes, added = group.device_bytes, allocated() - before
    check(group.use_codes, "the group does not take the int8 route")
    check(all(v is sh.index.vectors and c.codes is sh.index.codes.codes
              for v, c, sh, d in zip(group.vectors, group.codes, shards, group.devices)
              if d == sh.index.vectors.device), "a member on its shard's card copied the arena")
    masks = [sh.index.base_mask() for sh in shards]
    offsets = [s * per_seg for s in range(members)]

    def same_as_sequential(g, shs, q, what, msks=None, filt=None):
        gs, gi = g.search(q, MESH_TOP_K, msks or [sh.index.base_mask() for sh in shs])
        for si, sh in enumerate(shs):
            es, ei = sh.index.search(q, MESH_TOP_K, para_mask=None if filt is None else filt[si])
            check(np.array_equal(gi[si], ei), f"{what}: member {si} ids differ from its sequential search")
            check(np.array_equal(gs[si].view(np.int32), es.view(np.int32)),
                  f"{what}: member {si} scores differ from its sequential search in their bits")
        return gs, gi

    # ---- the main path, counted -----------------------------------------
    reset_launches(slot_scan)
    cuts = {}
    for b in cfg["batches"]:
        cuts[b] = group.search(corpus.q_np[:b], MESH_TOP_K, masks)
    launches = slot_scan.LAUNCHES.get("top2", 0)
    # ----------------------------------------------------------------------
    check(launches == members * len(cfg["batches"]), f"top-2 kernel launched {launches} times on the group path")
    kernel_checks = [group_kernel_check(torch, slot_scan, group, 0, masks, corpus.q_np[:b], "group")
                     for b in cfg["batches"]]
    for b in cfg["batches"]:
        same_as_sequential(group, shards, corpus.q_np[:b], f"group at B={b}", masks)
    # a label filter: the members' masks from the same filter
    filt = []
    for sh in shards:
        m = np.zeros(sh.index.n_para, bool)
        m[sh.index.label_postings("/l/tenth")] = True
        filt.append(m)
    fmasks = [sh.index.base_mask() & np.pad(m, (0, sh.index.p_pad - m.shape[0])) for sh, m in zip(shards, filt)]
    gs_f, gi_f = same_as_sequential(group, shards, corpus.q_np[:64], "group, label-filtered", fmasks, filt)
    check(all(sh.index.keys[i].split("/")[2] == "0" for s, sh in enumerate(shards) for i in gi_f[s].reshape(-1)
              if i >= 0), "group: an unlabelled paragraph passed the filter")
    bmax = max(cfg["batches"])
    m_s, m_i = mesh_merge_host(*cuts[bmax], offsets, TOP_K)
    check([sh.index.keys[0] for sh in shards] == [key_of(o) for o in offsets], "a shard's rows out of order")
    recall = mesh_recall(m_i[:ORACLE_QUERIES], corpus.oracle)
    check(recall >= RECALL_BAR, f"group recall@10 {recall} < {RECALL_BAR}")
    check(not any(int(i) // 10 == int(DELETED[1:-1]) for i in m_i.reshape(-1)), "group: a deleted paragraph came back")

    timing = {}
    for b in cfg["batches"]:
        q = corpus.q_np[:b]
        g_ms, _ = median_ms(lambda: group.search(q, MESH_TOP_K, masks))
        s_ms, _ = median_ms(lambda: [sh.index.search(q, MESH_TOP_K) for sh in shards])
        busy = busy_ms(lambda: group.search(q, MESH_TOP_K, masks))
        timing[b] = {"group_ms": g_ms, "sequential_ms": s_ms, "busy_ms": busy}
    # the all-gather merge alone, on the card: the members' [B, 10] cuts
    cut_s = [torch.from_numpy(np.ascontiguousarray(cuts[bmax][0][s])).to(device) for s in range(members)]
    cut_i = [torch.from_numpy(np.ascontiguousarray(cuts[bmax][1][s]) + offsets[s]).to(device) for s in range(members)]
    merge = lambda: sharded_topk_allgather(cut_s, cut_i, TOP_K)  # noqa: E731
    merge_ms = cuda_ms(merge, 20) if cuda else median_ms(merge)[0]
    ms_dev, mi_dev = merge()
    check(np.array_equal(mi_dev.cpu().numpy(), m_i), "the device merge differs from the host merge")
    out["group"] = {"open_s": t_open, "build_s": t_group, "device_bytes": group_bytes, "allocated": added,
                    "recall": recall, "launches": launches, "timing": timing, "merge_ms": merge_ms}
    print(
        f"mesh group: {members} shards of {per_seg} x {DIM} (p_pad {shards[0].index.p_pad}) on a {members}-member "
        f"mesh of {sorted({str(d) for d in group.devices})}; open {t_open:.1f}s, group {t_group:.2f}s holding "
        f"{group_bytes} device bytes of copies (allocated {added}); every member's cut equals its sequential "
        f"search bit for bit at B in {cfg['batches']} and label-filtered; member 0's top-2 kernel bit for bit "
        f"against its plain version at (B, N) in {[(c['b'], c['n']) for c in kernel_checks]}; merged recall@10 "
        f"{recall:.4f}; top-2 launches {launches}; "
        + "; ".join(f"B={b}: group {v['group_ms']:.2f} ms, {members} sequential calls {v['sequential_ms']:.2f} ms, "
                    f"card busy {v['busy_ms']:.3f} ms ({v['busy_ms'] / v['group_ms']:.3f} of the group's)"
                    for b, v in timing.items())
        + f"; the all-gather merge of {members} x [{bmax}, {TOP_K}] {merge_ms:.4f} ms",
        flush=True,
    )
    del group, cut_s, cut_i

    # ---- an uneven group: 500k / 250k / 250k, a surplus member slot -------
    big = shard([0, 1])
    uneven = [big, shards[2], shards[3]]
    group_u = MeshVectorGroup(uneven, mesh1d)
    check(big.index.p_pad > shards[2].index.p_pad and group_u.s_pad == members,
          f"uneven group p_pad {[sh.index.p_pad for sh in uneven]}, s_pad {group_u.s_pad}")
    reset_launches(slot_scan)
    same_as_sequential(group_u, uneven, corpus.q_np[:bmax], "uneven group")
    check(slot_scan.LAUNCHES["top2"] == 2 * len(uneven), f"uneven group launches {dict(slot_scan.LAUNCHES)}")
    masks_u = [sh.index.base_mask() for sh in uneven]
    kernel_checks.append(group_kernel_check(torch, slot_scan, group_u, 0, masks_u, corpus.q_np[:bmax], "uneven group"))
    out["group"]["kernel_checks"] = kernel_checks
    print(f"mesh uneven group: members of {[sh.index.n_para for sh in uneven]} rows (p_pad "
          f"{[sh.index.p_pad for sh in uneven]}); equal to the sequential searches bit for bit at B={bmax}; the "
          f"{big.index.p_pad}-row member's top-2 kernel bit for bit against its plain version; "
          f"{group_u.device_bytes} device bytes of copies", flush=True)
    del group_u, big, uneven, shards
    if cuda:
        torch.cuda.empty_cache()

    # ---- the sharded index over the same 1M: exact and int8 ---------------
    vecs_np = corpus.vecs.cpu().numpy()
    q_o = corpus.q_np[:ORACLE_QUERIES]
    everything = torch.ones(N_ROWS, dtype=torch.bool, device=corpus.vecs.device)
    oracle_all = exact_oracle(torch, corpus.vecs, everything, corpus.queries[:ORACLE_QUERIES], TOP_K)
    sharded = {}
    for quantize in (False, True):
        t = time.perf_counter()
        idx = MeshShardedVectorIndex(vecs_np, grid, quantize=quantize)
        t_build = time.perf_counter() - t
        s_, i_ = idx.search(q_o, TOP_K)
        what = "sharded int8" if quantize else "sharded exact"
        check(s_.shape == (ORACLE_QUERIES, TOP_K) and bool((i_ >= 0).all()), f"{what}: result shape")
        if quantize:
            rec = mesh_recall(i_, oracle_all)
            check(rec >= RECALL_BAR, f"{what}: recall@10 {rec} < {RECALL_BAR}")
        else:
            mesh_exact_up_to_ties(vecs_np, q_o, i_, oracle_all, what)
            rec = mesh_recall(i_, oracle_all)
        ms, _ = median_ms(lambda: idx.search(q_o, TOP_K), 3)
        sharded["int8" if quantize else "exact"] = {"build_s": t_build, "recall": rec, "ms": ms}
        del idx
    out["sharded"] = sharded
    print(f"mesh sharded index: {N_ROWS} x {DIM} on a {grid.shape} mesh, {ORACLE_QUERIES} queries: exact "
          f"{sharded['exact']['ms']:.2f} ms, the global oracle's ids up to ties (recall@10 "
          f"{sharded['exact']['recall']:.4f}); int8 {sharded['int8']['ms']:.2f} ms, recall@10 "
          f"{sharded['int8']['recall']:.4f}", flush=True)
    del vecs_np
    if cuda:
        torch.cuda.empty_cache()

    # ---- the keyword half: 4 paragraph shards of config 3's corpus --------
    os.environ["NDBTPU_TEXT_HOST_TIER"] = "0"  # the device route: the group program runs on the card
    try:
        words = kw_vocab()
        n = cfg["kw_paragraphs"]
        t = time.perf_counter()
        texts, _ = kw_texts(words, members * n, 17)
        psearchers = []
        for s in range(members):
            docs = [DocEntry(key=key_of(s * n + i), text=texts[s * n + i],
                             facets=["/t/t", "/l/tenth"] if i % 10 == 0 else ["/t/t"]) for i in range(n)]
            seg = build_segment(f"{tmp}/mesh_kw{s}", docs, kind="paragraph")
            psearchers.append(ParagraphSearcher(SimpleOpenIndex(segment_list=[(seg, Seq(1))]), device=device))
        del texts
        t_kw = time.perf_counter() - t
        check(MeshTextGroup.eligible(psearchers), "the keyword shards are not group-eligible")
        tgroup = MeshTextGroup(psearchers, mesh1d)
        rng = np.random.default_rng(29)
        bodies = [f"{words[int(rng.integers(0, 2000))]} {words[int(rng.integers(0, 2000))]} "
                  f"{'quikc' if i % 2 else 'borwn'}" for i in range(cfg["kw_requests"])]
        reqs = [ParagraphSearchRequest(query=b, top_k=KW_TOP_K, fuzzy=True,
                                       filter=LabelAtom("/l/tenth") if i % 4 == 3 else None,
                                       all_terms=i % 8 == 5)
                for i, b in enumerate(bodies)]
        # ---- the text group's main path, counted ----
        bm25.DISPATCHES.clear()
        bm25.LAUNCHES.clear()
        grouped = []
        for req in reqs:
            queries = [p.plan_kernel_query(req) for p in psearchers]
            check(all(q is not None for q in queries), "a plannable request did not plan")
            top_s, top_ic, counts = tgroup.search(queries, req.top_k)
            grouped.append([p.finish_kernel(req, q, top_s[i], top_ic[i], int(counts[i]))
                            for i, (p, q) in enumerate(zip(psearchers, queries))])
        dispatched = bm25.DISPATCHES.total()
        tg_launches = bm25.LAUNCHES.get("program", 0)
        tg_merges = bm25.LAUNCHES.get("merge", 0)
        # ----
        check(dispatched == members * len(reqs), f"the text group dispatched {dispatched} programs")
        check(tg_launches == (dispatched if device == "cuda" else 0) and tg_merges == tg_launches,
              f"the text group launched bm25_program {tg_launches} times, its merge {tg_merges}")
        for req, got in zip(reqs, grouped):
            for p, g in zip(psearchers, got):
                want = p.search(req)
                check([(h.paragraph_id, h.score) for h in g.hits] == [(h.paragraph_id, h.score) for h in want.hits]
                      and g.total == want.total, f"text group differs from the sequential engine on {req.query!r}")
        tg_ms, _ = median_ms(lambda: tgroup.search([p.plan_kernel_query(reqs[0]) for p in psearchers], KW_TOP_K))
        ts_ms, _ = median_ms(lambda: [p.search(reqs[0]) for p in psearchers])

        # the sharded keyword engine: the single-arena program on each member
        engines = [p.engine for p in psearchers]
        tmesh = MeshShardedTextEngine(engines, grid)
        kq = [TextQuery(text=f"{words[int(rng.integers(0, 2000))]} {words[int(rng.integers(0, 2000))]}", top_k=KW_TOP_K)
              for _ in range(cfg["kw_engine_queries"])]
        arena_err = mesh_arena_check(torch, tmesh, kq) if cuda else None
        for q in kq:
            ms_s, ms_i = tmesh.search(q)
            parts = [e.search(q, need_matched=False)[0] for e in engines]
            want = sorted(((h.score, -(int(tmesh.offsets[s]) + h.doc_id)) for s, hs in enumerate(parts) for h in hs),
                          reverse=True)[: q.top_k]
            want_s = np.array([w[0] for w in want])
            check(len(ms_s) == len(want), f"sharded keyword engine: {len(ms_s)} hits, the engines' merge {len(want)}")
            check(bool(np.all(np.abs(ms_s - want_s) <= KW_RTOL * np.abs(want_s) + 1e-6)),
                  f"sharded keyword engine: scores differ on {q.text!r}")
            band = want_s[-1] * (1 + KW_RTOL) + 1e-6 if len(want) else 0
            check({int(i) for s, i in zip(ms_s, ms_i) if s > band} == {-w[1] for w in want if w[0] > band},
                  f"sharded keyword engine: ids differ on {q.text!r}")
        te_ms, _ = median_ms(lambda: tmesh.search(kq[0]))

        # the hybrid: aligned (vector, text) shards, RRF on the device
        hvecs = [corpus.vecs[s * per_seg : s * per_seg + n].cpu().numpy() for s in range(members)]
        hyb = MeshHybridIndex(list(zip(hvecs, engines)), grid)
        hq = corpus.q_np[: cfg["hybrid_batch"]]
        for q in kq[:4]:
            fs, fi = hyb.search(hq, q, TOP_K)
            check(fs.shape == (len(hq), TOP_K), "hybrid: result shape")
            (vg_s, vg_i, bg_s, bg_i), = list(hybrid_mesh._merged_legs(
                hyb, TOP_K, hq, hyb.text.member_inputs(q)))
            vg_i, bg_i = vg_i.cpu().numpy(), bg_i.cpu().numpy()[0]
            for r in range(len(hq)):
                fused = {}
                for lst in (vg_i[r], bg_i):
                    for rank, gid in enumerate(lst.tolist()):
                        if gid >= 0:
                            fused[gid] = fused.get(gid, np.float32(0)) + np.float32(1) / np.float32(60 + rank)
                want = sorted(fused, key=lambda g: (-fused[g], list(fused).index(g)))[:TOP_K]
                check(fi[r][: len(want)].tolist() == want, f"hybrid row {r} differs from the host RRF of its legs")
            # the vector leg: recall@10 against the exact oracle over the aligned rows
            allv = np.concatenate([np.pad(v, ((0, hyb.per_shard - v.shape[0]), (0, 0))) for v in hvecs])
            sc = hq @ allv.T
            for s in range(members):
                sc[:, s * hyb.per_shard + n:(s + 1) * hyb.per_shard] = -np.inf
            h_rec = mesh_recall(vg_i, np.argsort(-sc, axis=1)[:, :TOP_K])
            check(h_rec >= RECALL_BAR, f"hybrid vector leg recall@10 {h_rec}")
        hy_ms, _ = median_ms(lambda: hyb.search(hq, kq[0], TOP_K))
        out["keyword"] = {"build_s": t_kw, "group_ms": tg_ms, "sequential_ms": ts_ms, "engine_ms": te_ms,
                          "hybrid_ms": hy_ms, "hybrid_recall": h_rec}
        out["keyword"].update(text_group_launches=tg_launches, text_group_merges=tg_merges,
                              arena_max_abs_err=arena_err)
        print(f"mesh keyword: {members} shards of {n} paragraphs (written and opened in {t_kw:.1f}s); text group "
              f"= the sequential engines on {len(reqs)} requests ({dispatched} dispatches, {tg_launches} launches "
              f"of bm25_program, {tg_merges} of its merge), a request {tg_ms:.2f} ms "
              f"against {ts_ms:.2f} ms sequential; sharded engine = the engines' merge up to ties on {len(kq)} "
              f"queries, {te_ms:.2f} ms; hybrid of {len(hq)} x 1 = the host RRF of its merged legs, vector leg "
              f"recall@10 {h_rec:.4f}, {hy_ms:.2f} ms", flush=True)
        del tgroup, tmesh, hyb, engines, psearchers
    finally:
        os.environ.pop("NDBTPU_TEXT_HOST_TIER", None)
    if cuda:
        torch.cuda.empty_cache()

    # ---- serving: search_multi over a node's 4 shards ---------------------
    out["serving"] = mesh_serving(torch, slot_scan, tmp, cfg, device)
    print(f"mesh numbers: {json.dumps(out)}", flush=True)
    return launches, tg_launches, tg_merges, arena_err


def mesh_serving(torch, slot_scan, tmp, cfg, device):
    """``search_multi`` over 4 shards of an ``EmbeddedNode``: the mesh branch
    (the device listing replaced by the mesh's members, as the tests reach
    it) against the per-shard path (``NDBTPU_MESH_SERVING=0``), on the
    default keyword route and on the device route. A correctness smoke:
    its times are of toy-size shards (the int8 threshold lowered) on a mesh
    that repeats one card, where per-request host work dominates."""
    import os

    import nucliadb_tpu_torch.index.vector.device as vdevice
    from nucliadb_tpu_torch.index.vector import VectorConfig
    from nucliadb_tpu_torch.ops import bm25
    from nucliadb_tpu_torch.parallel import mesh as pmesh
    from nucliadb_tpu_torch.services import EmbeddedNode

    members = cfg["members"]
    ncfg = dict(NODE_FULL, resources=cfg["node_resources"], dim=DIM, delta=0, hybrid=cfg["node_requests"],
                threaded=cfg["node_requests"], cpu=cfg["node_requests"])
    corpus = NodeCorpus(torch, ncfg, device)
    real_threshold, real_listing = vdevice.EXACT_SCAN_THRESHOLD, pmesh.visible_devices
    vdevice.EXACT_SCAN_THRESHOLD = cfg["node_threshold"]
    pmesh.visible_devices = lambda dev="cuda": [torch.device(device)] * members
    out = {}
    try:
        node = EmbeddedNode(f"{tmp}/mesh_node", device=device)
        sids = [node.create_shard("kb", {"m": VectorConfig(dimension=DIM)}, shard_id=f"mesh{s}") for s in range(members)]
        t = time.perf_counter()
        for r in range(corpus.R):
            node.index(sids[r % members], corpus.resource(r))
        while True:  # merge rounds until no job is left
            stats = node.tick_background()
            if stats["jobs_enqueued"] == 0 and stats["merged"] == 0:
                break
        node.wait_for_sync()
        t_index = time.perf_counter() - t
        for route in ("default", "device"):
            if route == "device":
                os.environ["NDBTPU_TEXT_HOST_TIER"] = "0"
                node = EmbeddedNode(f"{tmp}/mesh_node", device=device)  # its searcher opens with the tier off
            reqs = [node_hybrid(corpus, i) for i in range(cfg["node_requests"])]
            os.environ["NDBTPU_MESH_SERVING"] = "0"
            per_shard = [node.search_multi(sids, r) for r in reqs]
            os.environ["NDBTPU_MESH_SERVING"] = "1"
            node.search_multi(sids, reqs[0])  # builds the groups
            reset_launches(slot_scan)
            d0 = bm25.DISPATCHES.total()
            t = time.perf_counter()
            meshed = [node.search_multi(sids, r) for r in reqs]
            wall = (time.perf_counter() - t) * 1e3 / len(reqs)
            launches, dispatches = slot_scan.LAUNCHES.get("top2", 0), bm25.DISPATCHES.total() - d0
            check(launches == members * len(reqs), f"{route}: search_multi's mesh branch launched {launches} top-2")
            check(len(node.searcher._mesh_groups) == 1, f"{route}: no vector group cached")
            # the device route's paragraph legs run as the text group (a
            # dispatch a member), its document legs per shard; the default
            # route's run on the host tier
            device_route = route == "device"
            check(dispatches >= members * len(reqs) if device_route else dispatches == 0,
                  f"{route}: {dispatches} BM25 dispatches on the mesh branch")
            check(len(node.searcher._mesh_text_groups) == int(device_route), f"{route}: text groups cached")
            for a, b in zip(meshed, per_shard):
                check(len(a) == len(b) == members, "search_multi: one response a shard")
                for s, (x, y) in enumerate(zip(a, b)):
                    node_same(x, y, 0.0, f"{route}: search_multi shard {s}, mesh against per shard")
            t = time.perf_counter()
            for r in reqs:
                node.search_multi(sids, r)
            os.environ["NDBTPU_MESH_SERVING"] = "0"
            t_mid = time.perf_counter()
            for r in reqs:
                node.search_multi(sids, r)
            per_ms = (time.perf_counter() - t_mid) * 1e3 / len(reqs)
            mesh_ms = (t_mid - t) * 1e3 / len(reqs)
            out[route] = {"launches": launches, "dispatches": dispatches, "mesh_ms": mesh_ms, "per_shard_ms": per_ms,
                          "first_pass_ms": wall}
        print(f"mesh serving: {corpus.R} resources x {corpus.P} paragraphs in {members} shards of one node "
              f"(indexed, merged and synced in {t_index:.1f}s); search_multi's mesh branch equals the per-shard "
              f"path on {cfg['node_requests']} hybrid requests on each keyword route; "
              + "; ".join(f"{k}: {v['launches']} top-2 launches, {v['dispatches']} BM25 dispatches, "
                          f"{v['mesh_ms']:.2f} ms a request (per shard {v['per_shard_ms']:.2f})" for k, v in out.items())
              + " (toy-size shards on one card: not a serving measurement)",
              flush=True)
    finally:
        vdevice.EXACT_SCAN_THRESHOLD, pmesh.visible_devices = real_threshold, real_listing
        os.environ.pop("NDBTPU_TEXT_HOST_TIER", None)
        os.environ.pop("NDBTPU_MESH_SERVING", None)
    return out


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


BM25_DISPATCH_KEYS = ("single", "batch", "arena", "arena_batch")


def bm25_kernel_served(counts, what, device) -> None:
    """On the card, every BM25 dispatch of a counted path launched
    ``csrc/bm25_program.cu`` and its merge once each (``counts`` holds
    ``bm25.DISPATCHES`` and ``bm25.LAUNCHES``); on the CPU the plain version
    counts no launch."""
    dispatched = sum(counts.get(key, 0) for key in BM25_DISPATCH_KEYS)
    launched, merged = counts.get("program", 0), counts.get("merge", 0)
    # every dispatch of these paths cuts 1 <= k <= KMAX: one merge a launch
    check(launched == (dispatched if device == "cuda" else 0) and merged == launched,
          f"{what}: {dispatched} BM25 dispatches, {launched} launches of bm25_program, {merged} of its merge")


def phase_keyword(torch, tmp, cfg, device="cuda"):
    """The keyword leg on ``device`` (see the module docstring); prints one
    line per part and returns the device-program dispatches and the
    kernel's launches of the counted main path, and (on the card) the
    kernel's numbers from ``phase_bm25_kernel``."""
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
    bm25.LAUNCHES.clear()
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
    t = time.perf_counter()
    kw_dispatched(bm25, lambda: [th.start() for th in threads] + [th.join(timeout=600) for th in threads], "threaded requests")
    t_burst = (time.perf_counter() - t) * 1e3
    doc_resps = [kw_dispatched(bm25, lambda r=r: docs.search(r), f"document request {i}") for i, r in enumerate(doc_reqs)]
    dispatches = dict(bm25.DISPATCHES)
    launches = dict(bm25.LAUNCHES)
    coalesced = coalescer.dispatches - coalesced0
    # -----------------------------------------------------------------------
    bm25_kernel_served(dict(dispatches, **launches), "keyword device route", device)
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
        f"both batches bit-identical on a second run; bm25_program launches {launches}",
        flush=True,
    )

    # ---- launches a request, the burst against one after another ----------
    t = time.perf_counter()
    for r in threaded:
        para.search(r)
    t_seq = (time.perf_counter() - t) * 1e3
    per_request = program = None
    if device == "cuda":
        per_request = device_launches(torch, lambda: [para.search(r) for r in threaded[:8]], 8)
        terms, required = engine._plan_terms(single_q)
        rows_np, idfs_np, params_np, caps = engine._device_inputs_planned(terms, required, single_q)
        single_in = [torch.from_numpy(a).to(engine.device) for a in (rows_np, idfs_np, params_np)]
        program = device_launches(torch, lambda: bm25.bm25_groups(
            engine._group_tensors(), engine._offsets(), engine.base_mask_device(), *single_in, KW_TOP_K, caps,
            tuple(engine._tier_group_counts()), False, layout=engine.program_layout(),
        ))
        check(program <= 9, f"a BM25 dispatch put {program} launches on the card (PR 14's program took 9)")
    print(
        f"keyword launches: {per_request} a device-route request (kernels, copies and fills on the card, "
        f"torch.profiler, mean of 8 ParagraphSearcher requests), {program} of them the BM25 program's (a single "
        f"query's bm25_groups alone: the kernel and its merge); {len(threaded)} requests from {cfg['threads']} threads "
        f"{t_burst:.1f} ms against {t_seq:.1f} ms one after another ({t_burst / t_seq:.3f}x)",
        flush=True,
    )

    # ---- the kernel against its plain version at the main path's shapes ----
    kernel = phase_bm25_kernel(torch, engine, or_q, and_q, single_q) if device == "cuda" else None

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
    return SimpleNamespace(dispatches=dispatches, launches=launches.get("program", 0),
                           merge_launches=launches.get("merge", 0), kernel=kernel)


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
    layout = engine.program_layout()  # None on the CPU: the plain version

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
        "topk_cut": timed(lambda: bm25.topk_cut(bm25.epilogue(scores[:, :L], None, mask, params[:, 1], params[:, 2])[0],
                                                None, k), 5),
        # what masked_topk's select path replaces: a stable sort of the whole axis
        "topk_full_stable_sort": timed(lambda: torch.sort(scores[:, :L], dim=-1, descending=True, stable=True), 3),
        "dense_columns": timed(
            lambda: bm25.add_dense_columns(scores[:, :L], None, groups, offs, rows, idfs, avgdl, caps, tc), 5
        ),
        "whole_program_or": timed(
            lambda: bm25.bm25_groups_batch(groups, offs, mask, rows, idfs, params, k, caps, tc,
                                           shared_mask=True, count_only=True, with_counts=False, layout=layout), 5
        ),
    }
    ka, caps_a, ra, ia, pa = engine.plan_batch(and_q)
    ra, ia, pa = (torch.from_numpy(a).to(dev) for a in (ra, ia, pa))
    out["whole_program_and"] = timed(
        lambda: bm25.bm25_groups_batch(groups, offs, mask, ra, ia, pa, ka, caps_a, tc,
                                       shared_mask=True, count_only=True, with_counts=True, layout=layout), 5
    )
    res = bm25.bm25_groups_batch(groups, offs, mask, rows, idfs, params, k, caps, tc,
                                 shared_mask=True, count_only=True, with_counts=False, layout=layout)
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
                               shared_mask=True, count_only=True, with_counts=False, layout=layout)
        torch.cuda.synchronize()
        out["peak_gib_or_batch"] = round(torch.cuda.max_memory_allocated() / 2**30, 3)
    out = {key: (round(v, 3) if isinstance(v, float) else v) for key, v in out.items()}
    return f"breakdown keyword (ms, batch {n_q}, {engine.n_docs} paragraphs): {json.dumps(out)}"


PROFILE_MARGIN_S = 0.25  # host time a profile is open before and after the profiled call
PROFILE_TAKES = 3  # profiles taken at most while one comes back short of device events


def profiled(torch, fn):
    """``fn()`` under ``torch.profiler`` (CUDA activity), after one warm-up
    call, the profile opened ``PROFILE_MARGIN_S`` before the call and
    closed as long after its last kernel. Kineto keeps only the device
    events whose timestamps fall inside the profile's host-clock window,
    and on the H100 a profile of a few short kernels has come back short
    of them: with no margin now and then, and with a 5 ms margin a single
    query's BM25 program (2 kernels) once empty in a run of this script. A
    take that holds no device event, or fewer than the hand kernels the
    port's wrappers launched in it, is taken again, at most
    ``PROFILE_TAKES`` times; the check fails if every take is short.
    Returns the complete take's events summed by key and the launches the
    wrappers counted in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nucliadb_tpu_torch.ops import binary_scan, bm25, slot_scan

    def wrapped():
        return sum(c.total() for c in (slot_scan.LAUNCHES, binary_scan.LAUNCHES, bm25.LAUNCHES))

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TAKES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            before = wrapped()
            fn()
            torch.cuda.synchronize()
            launched = wrapped() - before
            time.sleep(PROFILE_MARGIN_S)
        events = prof.key_averages()
        n = sum(e.count for e in events if e.device_type == DeviceType.CUDA)
        if n > 0 and n >= launched:
            return events, launched
    check(False, f"torch.profiler came back short in each of {PROFILE_TAKES} profiles: the last saw {n} device "
                 f"events where the port's kernel wrappers launched {launched}")


def device_launches(torch, fn, per: int = 1) -> float:
    """Kernels, copies and fills that ``fn()`` put on the card, counted by
    ``torch.profiler`` (``profiled``: no fewer than the hand kernels the
    wrappers launched), over ``per``."""
    from torch.autograd import DeviceType

    events, _ = profiled(torch, fn)
    return sum(e.count for e in events if e.device_type == DeviceType.CUDA) / per


def bm25_work(bm25, layout, caps, rows) -> dict:
    """What this run's data asks of the BM25 program, each input counted
    once a batch however many of its queries schedule it: the lanes of
    every distinct scheduled posting row (a record's row), the valid ones
    among them (a doc, not padding), and the bytes of each distinct
    scheduled dense row's window (1 B a column) and of each scheduled dense
    block's dl window (4 B a column)."""
    starts = np.concatenate([[0], np.cumsum(caps)])
    lanes = valid = dense_bytes = 0
    for rec in layout.records:
        block = rec.tensors[0]
        n_rows, width = block.shape
        lo, hi = int(starts[rec.slot]), int(starts[rec.slot + 1])
        if hi == lo:
            continue
        sel = rows[:, lo:hi].reshape(-1).long()
        sel = sel[(sel >= 0) & (sel < n_rows)].unique()
        if rec.kind == bm25.POSTING:
            lanes += int(sel.numel()) * width
            valid += int((block[sel] >= 0).sum())
        else:
            dense_bytes += int(sel.numel()) * width + 4 * width
    return {"lanes": lanes, "valid_lanes": valid, "dense_bytes": dense_bytes}


def bm25_bound_ms(work, masks, rows, with_counts: bool, count_only: bool, k: int, rows_mode: bool = False) -> tuple:
    """The least time of the BM25 program's own work on an H100, from this
    run's data (``bm25_work``), whatever implements it: its bytes at the
    HBM rate (its ~10 f32 operations a valid lane are far below the f32
    rate). Read once: the doc id of every lane of a distinct scheduled
    posting row (4 B), tf and dl of each of its valid lanes (8 B), the
    distinct dense windows, the mask, rows, idfs and params; written once:
    the cut (a score, an id and a count: 20 B an entry) and the matched
    bitmap (1 B a column) or the match counts (8 B a query). ``rows_mode`` adds final (4 B a column)
    and, with counts, the count row (4 B a column): the rows mode's outputs.
    Returns (ms, bytes)."""
    n_q, n_slots = rows.shape
    L = masks.shape[-1]
    total = (4 * work["lanes"] + 8 * work["valid_lanes"] + work["dense_bytes"] + masks.numel() + 8 * n_q * n_slots
             + 12 * n_q + 20 * n_q * k + (8 * n_q if count_only else n_q * L))
    if rows_mode:
        total += n_q * L * (8 if with_counts else 4)
    return total / HBM_BYTES_PER_S * 1e3, total


def bm25_merge_bound_ms(n_q, n_tiles, k, count_only) -> float:
    """The merge's bytes at the HBM rate: the tiles' cuts read once (20 B
    an entry; the tiles' match counts, 8 B each), the row's cut written
    once (20 B an entry; the match count, 8 B a query)."""
    total = 20 * n_q * n_tiles * k + 20 * n_q * k + (8 * n_q * (n_tiles + 1) if count_only else 0)
    return total / HBM_BYTES_PER_S * 1e3


def bm25_same(torch, got, want, what) -> float:
    """``got`` equals ``want`` bit for bit (tensors, or None on both
    sides): f32 as int32 bits, the rest exactly. Returns the largest
    |difference| of the f32 tensors (0.0)."""
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None or w is None:
            check(g is None and w is None, f"{what}: output {i} on one side only")
            continue
        check(g.dtype == w.dtype and g.shape == w.shape, f"{what}: output {i} {g.dtype} {tuple(g.shape)} "
              f"against {w.dtype} {tuple(w.shape)}")
        if g.dtype == torch.float32:
            check(torch.equal(g.view(torch.int32), w.view(torch.int32)), f"{what}: output {i} differs")
            err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
        else:
            check(torch.equal(g, w), f"{what}: output {i} differs")
    return err


def bm25_group_check(torch, engine, name, k, caps, rows, idfs, params, mask, with_counts, count_only) -> float:
    """The kernel against its plain version on ``engine``'s groups, bit for
    bit: one launch's final rows, count rows and bitmaps or counts against
    ``bm25.plain_final``, and the whole program (kernel, block cuts, merge)
    against ``bm25.plain_program``. Returns the largest |difference|."""
    from nucliadb_tpu_torch.ops import bm25

    groups, offs, tc = engine._group_tensors(), engine._offsets(), tuple(engine._tier_group_counts())
    layout = engine.program_layout()
    got = bm25.launch_program(layout, caps, mask, rows, idfs, params, with_counts, count_only)[:3]
    want = bm25.plain_final(groups, offs, mask, rows, idfs, params, caps, tc, with_counts)
    if count_only:
        want = (want[0], want[1], want[2].sum(dim=-1))
    err = bm25_same(torch, got, want, f"bm25 kernel, {name}")
    del got, want
    args = (groups, offs, mask, rows, idfs, params, k, caps, tc)
    kern = bm25._program(*args, with_counts, count_only, layout=layout)
    plain = bm25.plain_program(*args, with_counts, count_only)
    return max(err, bm25_same(torch, kern, plain, f"bm25 program, {name}"))


def bm25_engine_check(torch, engine, queries, what) -> float:
    """``bm25_group_check`` at ``engine``'s shape: ``queries`` as one batch
    (hit counts, the counts only) and the first alone (its bitmap)."""
    dev = engine.device

    def upload(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    t0 = time.perf_counter()
    k, caps, rows, idfs, params = engine.plan_batch(queries)
    err = bm25_group_check(torch, engine, f"{what}, batch of {len(queries)}", k, caps, *upload(rows, idfs, params),
                           engine.base_mask_device(), True, True)
    terms, required = engine._plan_terms(queries[0])
    rows, idfs, params, caps = engine._device_inputs_planned(terms, required, queries[0])
    err = max(err, bm25_group_check(torch, engine, f"{what}, single", min(queries[0].top_k, engine.n_pad), caps,
                                    *upload(rows[None], idfs[None], params[None]), engine.base_mask_device(),
                                    bool(queries[0].all_terms), False))
    print(f"bm25 kernel vs plain, {what} (L={engine.n_pad}, {len(engine.groups)} groups): a batch of "
          f"{len(queries)} and a single query, bit-identical final rows, counts, bitmaps and cuts "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return err


def phase_bm25_kernel(torch, engine, or_q, and_q, single_q) -> dict:
    """``csrc/bm25_program.cu`` against its plain version on the keyword
    phase's engine, at the main path's three shapes: the OR batch of 512
    (no counts, the counts only), the AND batch (hit counts) and a single
    request (its bitmap), bit for bit (``bm25_group_check``: the rows mode's
    rows, the cut path's cut, counts and bitmap or match counts), and the
    merge kernel against ``bm25.merge_tile_cuts`` on the kernel's own tile
    cuts. Times (CUDA events): the kernel as the main path launches it (the
    tiles' cuts), the kernel in rows mode, the merge, its plain version and
    ``torch.topk`` of the tile cuts' scores (the merge's yardstick), the
    plain version of the program (rows and ``ops/topk.py``'s cut), the whole
    program on the card (the kernel and the merge), and a yardstick: one
    ``index_add_`` of all of the batch's lanes (the plain version's,
    padding sent to the sink column) into [Q, L + 1] (atomics in no fixed
    order: the scatter alone). The program's bound from this run's data
    (``bm25_bound_ms``). Prints one line a shape and returns the numbers."""
    from nucliadb_tpu_torch.ops import bm25

    t0 = time.perf_counter()
    groups, offs, tc = engine._group_tensors(), engine._offsets(), tuple(engine._tier_group_counts())
    layout = engine.program_layout()
    base_mask = engine.base_mask_device()
    L = base_mask.shape[0]
    dev = engine.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def upload(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    shapes = []
    for name, queries, with_counts in (("OR 512", or_q, False), ("AND 512", and_q, True)):
        k, caps, rows, idfs, params = engine.plan_batch(queries)
        shapes.append((name, k, caps, *upload(rows, idfs, params), base_mask, with_counts, True))
    terms, required = engine._plan_terms(single_q)
    rows, idfs, params, caps = engine._device_inputs_planned(terms, required, single_q)
    shapes.append(("single", KW_TOP_K, caps, *upload(rows[None], idfs[None], params[None]), base_mask,
                   bool(single_q.all_terms), False))

    out = {}
    for name, k, caps, rows, idfs, params, mask, with_counts, count_only in shapes:
        err = bm25_group_check(torch, engine, name, k, caps, rows, idfs, params, mask, with_counts, count_only)
        n_q = rows.shape[0]
        args = (groups, offs, mask, rows, idfs, params, k, caps, tc)
        reps = 3 if n_q > 1 else 20
        tile, n_tiles = bm25.tiling(n_q, L, sms, layout.dir_cols)
        # the merge kernel against its plain version on the kernel's tile cuts
        _, _, part, cut = bm25.launch_program(layout, caps, mask, rows, idfs, params, with_counts, count_only, k)
        part = part if count_only else None
        merged = bm25.merge_program_cuts(cut, part, k)
        merge_err = bm25_same(torch, merged[:2], bm25.merge_tile_cuts(*cut, k), f"bm25 merge, {name}")
        if count_only:
            check(torch.equal(merged[2], part.sum(dim=1)), f"bm25 merge, {name}: match counts differ")
        parts = bm25.gather_weights(groups, offs, rows, idfs, params[:, 0], caps, tc, L)
        base = torch.arange(n_q, device=dev)[:, None, None] * (L + 1)
        all_idx = torch.cat([(ids + base).reshape(-1) for ids, _, _ in parts])
        all_w = torch.cat([w.reshape(-1) for _, w, _ in parts])
        acc = torch.zeros(n_q * (L + 1), device=dev)
        del parts
        row = {
            "ms": cuda_ms(lambda: bm25.launch_program(layout, caps, mask, rows, idfs, params, with_counts,
                                                      count_only, k), reps),
            "rows_ms": cuda_ms(lambda: bm25.launch_program(layout, caps, mask, rows, idfs, params, with_counts,
                                                           count_only), reps),
            "merge_ms": cuda_ms(lambda: bm25.merge_program_cuts(cut, part, k), reps),
            "merge_plain_ms": cuda_ms(lambda: bm25.merge_tile_cuts(*cut, k), reps),
            "merge_library_ms": cuda_ms(lambda: torch.topk(cut[0].view(n_q, -1), k, dim=1), reps),
            "plain_ms": cuda_ms(lambda: bm25.plain_program(*args, with_counts, count_only), reps),
            "program_ms": cuda_ms(lambda: bm25._program(*args, with_counts, count_only, layout=layout), reps),
            "library_ms": cuda_ms(lambda: acc.index_add_(0, all_idx, all_w), reps),
            "max_abs_err": err, "merge_max_abs_err": merge_err,
        }
        del all_idx, all_w, acc, cut, merged
        work = bm25_work(bm25, layout, caps, rows)
        row["bound_ms"], row["bytes"] = bm25_bound_ms(work, mask, rows, with_counts, count_only, k)
        row["rows_bound_ms"] = bm25_bound_ms(work, mask, rows, with_counts, count_only, 0, rows_mode=True)[0]
        row["merge_bound_ms"] = bm25_merge_bound_ms(n_q, n_tiles, k, count_only)
        row["share"] = row["bound_ms"] / row["ms"]
        row["program_share"] = row["bound_ms"] / row["program_ms"]
        row["rows_share"] = row["rows_bound_ms"] / row["rows_ms"]
        before = bm25.LAUNCHES.total()
        bm25._program(*args, with_counts, count_only, layout=layout)
        row.update(work, tile_cols=tile, blocks_a_row=n_tiles, table_records=len(layout.table(caps, L)[0]),
                   kernel_launches_a_dispatch=bm25.LAUNCHES.total() - before)
        out[name] = row
        print(f"bm25 kernel vs plain, {name} (Q={n_q}, L={L}, k={k}, with_counts={with_counts}, "
              f"count_only={count_only}): bit-identical rows, counts, bitmaps and cuts, the merge bit-identical "
              f"to merge_tile_cuts; {json.dumps({key: round(v, 4) if isinstance(v, float) else v for key, v in row.items()})}",
              flush=True)
        torch.cuda.empty_cache()
    print(f"bm25 kernel phase: {time.perf_counter() - t0:.1f}s (layout: {layout.n_sorted} posting rows sorted, "
          f"{sum(d is not None for d in layout.directories)} tiers with a lane directory every {layout.dir_cols} "
          f"columns, {sum(d.numel() * 4 for d in layout.directories if d is not None) / 2**20:.1f} MiB)", flush=True)
    return out


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
    # 136,000 paragraphs: above EXACT_SCAN_THRESHOLD (131,072 rows), so the
    # int8 route and the top-2 kernel (p_pad 196,608); cut from 1,000
    # resources so the script keeps inside its time limit on a slow host
    "resources": 680,
    # paragraphs per resource
    "paragraphs": 200,
    "dim": DIM,
    "hybrid": 64,  # single hybrid requests on each keyword route
    "threads": 8,
    "threaded": 64,  # hybrid requests through the coalescers from the threads
    "delta": 20,  # resources indexed after the deletion
    "cpu": 8,  # hybrid requests answered again by a searcher on the CPU
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
    ``torch.profiler`` (``profiled``, CUDA activity only)."""
    events, _ = profiled(torch, fn)
    total_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
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
    bm25.LAUNCHES.clear()
    default_out = [node.search(sid, r) for r in reqs]
    default_counts = dict(slot_scan.LAUNCHES, **binary_scan.LAUNCHES, **bm25.DISPATCHES, **bm25.LAUNCHES)
    os.environ["NDBTPU_TEXT_HOST_TIER"] = "0"  # set before the device-route node's searcher opens
    node_dev = EmbeddedNode(node_dir, device=device)  # a second node over the same data directory
    t = time.perf_counter()
    shard_dev = node_dev.searcher.shard(sid)
    sync()
    t_open_dev = time.perf_counter() - t
    reset_launches(slot_scan, binary_scan)
    bm25.DISPATCHES.clear()
    bm25.LAUNCHES.clear()
    device_out = [node_dev.search(sid, r) for r in reqs]
    device_counts = dict(slot_scan.LAUNCHES, **binary_scan.LAUNCHES, **bm25.DISPATCHES, **bm25.LAUNCHES)
    # ---------------------------------------------------------------------------
    if device == "cuda":  # on the CPU the wrappers take their plain versions, which count nothing
        check(default_counts.get("top2", 0) >= n_h, f"default route: the top-2 kernel launched {default_counts}")
        check(device_counts.get("top2", 0) >= n_h, f"device route: the top-2 kernel launched {device_counts}")
    check(device_counts.get("single", 0) + device_counts.get("batch", 0) >= n_h,
          f"device route: the BM25 program dispatched {device_counts}")
    bm25_kernel_served(device_counts, "node, device route", device)
    bm25_kernel_served(default_counts, "node, default route", device)
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
            # kernels, copies and fills on the card a request (torch.profiler)
            timings[f"launches_per_hybrid_{name}"] = device_launches(
                torch, lambda: [node_x.search(sid, r) for r in reqs[:16]], 16)

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
        f"share against the unprofiled median): {json.dumps(timings)}; threaded bursts (ms) {json.dumps(t_burst)}; "
        f"burst against one after another: device route {t_burst['device'] / t_seq['device']:.3f}x, default route "
        f"{t_burst['default'] / t_seq['default']:.3f}x",
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
    "resources": 680,
    "paragraphs": 200,  # 136,000 paragraphs: the node phase's corpus generator and scale
    "dim": DIM,
    "requests": 64,  # hybrid FindRequests on each keyword route
    "filtered": 8,  # with a label filter_expression, on each route
    "secured": 8,  # with security groups, on each route
    "cpu": 8,  # answered again by a SearchService over a node on the CPU
    "fusion": 16,  # fused orders recomputed from their shard responses
    "semantic": 32,  # semantic-only requests held to the exact f32 oracle
    "threads": 8,
    "burst": 16,  # requests one after another and from the threads, on each route
    "timed": 8,  # requests of the debug split and the profile, on each route
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
    main path (the hybrid requests on both keyword routes), with what
    ``phase_http`` serves again: the kbid, the requests, their answers and
    shard responses on each route, and the corpus (host arrays only)."""
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
    # the directory as StandaloneApp lays it out, so phase_http boots over it
    driver = Driver(f"{tmp}/maindb.db")
    node_dir = f"{tmp}/node"
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
    kb_bytes = os.path.getsize(f"{tmp}/maindb.db")
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
    bm25.LAUNCHES.clear()
    default_out, default_ms = timed(app.search, reqs)
    default_counts = dict(slot_scan.LAUNCHES, **binary_scan.LAUNCHES, **bm25.DISPATCHES, **bm25.LAUNCHES)
    default_resp = [r[0] for r in seen]
    os.environ["NDBTPU_TEXT_HOST_TIER"] = "0"  # set before the device-route node's searcher opens
    dev = stack(EmbeddedNode(node_dir, device=device))  # a second node over the same data directory
    shard_dev = dev.node.searcher.shard(sid)
    sync()
    seen_dev = find_capture(dev.node)
    reset_launches(slot_scan, binary_scan)
    bm25.DISPATCHES.clear()
    bm25.LAUNCHES.clear()
    device_out, device_ms = timed(dev.search, reqs)
    device_counts = dict(slot_scan.LAUNCHES, **binary_scan.LAUNCHES, **bm25.DISPATCHES, **bm25.LAUNCHES)
    device_resp = [r[0] for r in seen_dev]
    # ---------------------------------------------------------------------------
    check(len(default_resp) == len(device_resp) == n_req, "a /find did not make exactly one shard fan-out")
    if device == "cuda":  # on the CPU the wrappers take their plain versions, which count nothing
        check(default_counts.get("top2", 0) >= n_req, f"default route: the top-2 kernel launched {default_counts}")
        check(device_counts.get("top2", 0) >= n_req, f"device route: the top-2 kernel launched {device_counts}")
    check(device_counts.get("single", 0) + device_counts.get("batch", 0) >= n_req,
          f"device route: the BM25 program dispatched {device_counts}")
    bm25_kernel_served(device_counts, "/find, device route", device)
    bm25_kernel_served(default_counts, "/find, default route", device)
    find_kernel_err = None
    if device == "cuda":  # the kernel against its plain version at this engine's shape, outside the count
        find_kernel_err = bm25_engine_check(
            torch, shard_dev.paragraph.engine, [TextQuery(text=r.query, top_k=FIND_TOP_K) for r in reqs[:8]],
            "/find device-route engine")
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
    n_t = min(cfg["timed"], n_req)
    phases = {}  # SearchService's own per-phase seconds (debug=True), median of n_t requests, in ms
    for name, app_x in (("default", app), ("device", dev)):
        split = [app_x.search.find(kbid, find_request(corpus, i, debug=True)).timings for i in range(n_t)]
        phases[name] = {k: round(float(np.median([t[k] for t in split])) * 1e3, 3) for k in split[0]}
    if device == "cuda":
        for name, app_x in (("default", app), ("device", dev)):
            busy = device_busy_ms(torch, lambda: [app_x.search.find(kbid, r) for r in reqs[:n_t]]) / n_t
            timings[f"device_busy_per_find_{name}"] = busy
            timings[f"device_idle_share_{name}"] = 1.0 - busy / timings[f"find_p50_{name}"]
    t_burst, t_seq = {}, {}
    n_b = min(cfg["burst"], n_req)
    for name, app_x, solo, resp in (("device", dev, device_out, device_resp), ("default", app, default_out, default_resp)):
        t = time.perf_counter()
        for r in reqs[:n_b]:  # the same requests one after another, warm
            app_x.search.find(kbid, r)
        t_seq[name] = (time.perf_counter() - t) * 1e3
        t_out, errors = [None] * n_b, []

        def worker(ix):
            try:
                for i in ix:
                    t_out[i] = app_x.search.find(kbid, reqs[i])
            except BaseException as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(range(w, n_b, cfg["threads"]),)) for w in range(cfg["threads"])]
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
        f"{n_b} requests from {cfg['threads']} threads equal their solo answers on both routes",
        flush=True,
    )
    print(
        f"find timings (host ms per /find over the counted pass of {n_req}; device busy ms per /find from "
        f"torch.profiler over {n_t}, idle share against the p50): {json.dumps(timings)}; phases (ms, median of {n_t}) "
        f"{json.dumps(phases)}; {n_b} requests one after "
        f"another (ms) {json.dumps({k: round(v, 1) for k, v in t_seq.items()})}, from {cfg['threads']} threads (ms) "
        f"{json.dumps({k: round(v, 1) for k, v in t_burst.items()})}; phase {time.perf_counter() - t_phase:.1f}s",
        flush=True,
    )
    del app, dev, shard, shard_dev
    corpus.vecs = None  # phase_http needs the host arrays only
    if device == "cuda":
        torch.cuda.empty_cache()
    return SimpleNamespace(
        default=default_counts, device=device_counts, kbid=kbid, sid=sid, reqs=reqs, corpus=corpus, rows=rows,
        default_out=default_out, device_out=device_out, default_resp=default_resp, device_resp=device_resp,
        kernel_err=find_kernel_err,
    )


# ---------------------------------------------------------------------------
# the standalone server: /find and the v1 REST API over HTTP
# ---------------------------------------------------------------------------

HTTP_FULL = {
    "clients": 32,  # keep-alive clients of the concurrent pass (bench_suite.py config 5)
    "rounds": 2,  # the concurrent pass sends the counted requests this many times
    "timed": 16,  # requests of the debug split, the in-process pass and the profile
    "writes": 16,  # resources written over HTTP on the device route
    "deadline": 240.0,  # seconds a write or a deletion may take to show in /find
    "bg_interval": 15.0,  # the CLI's default background interval
}


class HttpServer:
    """A ``StandaloneApp`` served on an event-loop thread, as the front
    end's tests serve it, with its background loop started as the CLI
    starts it; ``client`` is one keep-alive ``httpx.Client`` on its port."""

    def __init__(self, tmp, device, bg_interval):
        import asyncio
        import threading

        import httpx

        from nucliadb_tpu_torch.standalone import StandaloneApp

        t = time.perf_counter()
        self.app = StandaloneApp(data_dir=tmp, host="127.0.0.1", port=0, device=device)
        self.boot_s = time.perf_counter() - t  # migrations included
        self.loop = asyncio.new_event_loop()
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(self.app.server.start())
            started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        check(started.wait(60), "the HTTP server did not start")
        self.app.start_background(bg_interval)
        self.app._warmup_thread.join(600)
        check(self.app.warmup_seconds is not None, "the kernel warm-up failed (its traceback is above)")
        self.base = f"http://127.0.0.1:{self.app.server.port}"
        self.client = httpx.Client(base_url=self.base, timeout=600)

    def find(self, kbid, body, client=None):
        """(status, parsed FindResults, response bytes, client ms)."""
        from nucliadb_tpu_torch.models.api import KnowledgeboxFindResults

        t = time.perf_counter()
        resp = (client or self.client).post(f"/api/v1/kb/{kbid}/find", json=body)
        ms = (time.perf_counter() - t) * 1e3
        check(resp.status_code == 200, f"/find over HTTP answered {resp.status_code}: {resp.text[:300]}")
        return KnowledgeboxFindResults.model_validate_json(resp.content), len(resp.content), ms

    def stop(self):
        import asyncio

        self.client.close()
        self.app.stop_background()
        asyncio.run_coroutine_threadsafe(self.app.server.stop(), self.loop).result(60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(60)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_body(req) -> dict:
    """A FindRequest as a client posts it: JSON by alias, the fields set."""
    return req.model_dump(mode="json", by_alias=True, exclude_unset=True)


def http_cli_command(tmp, port, device) -> list:
    """The normal entry point, as a user starts it."""
    import sys

    return [sys.executable, "-m", "nucliadb_tpu_torch.standalone.run", "--data-dir", tmp, "--host", "127.0.0.1",
            "--port", str(port), "--device", device]


def http_new_payload(corpus, r: int, seed: int):
    """Resource r's text and labels with fresh unit vectors (a write's own
    paragraph vectors, which no other paragraph carries), as JSON."""
    payload = find_payload(corpus, r, {})
    rng = np.random.default_rng(seed)
    for emb in payload.embeddings["m"]["body"]:
        v = rng.standard_normal(len(emb.vector)).astype(np.float32)
        emb.vector = (v / np.linalg.norm(v)).tolist()
    return payload.model_dump(mode="json", by_alias=True, exclude_none=True)


def http_lazy_routes(srv) -> list:
    """The routes whose modules import a library lazily, each called only
    where its library imports: export and import (msgpack), a learning
    secret encrypted at rest (cryptography; the app booted with
    ``NDBTPU_ENCRYPTION_KEY``), a streamed trainset (flatbuffers). On a
    knowledge box of three resources; returns what ran and what did not."""
    import importlib.util

    from nucliadb_tpu_torch.learning_proxy import LEARNING_KEY

    c, ran = srv.client, []
    kbid = c.post("/api/v1/kbs", json={"slug": "routes"}).json()["uuid"]
    for i in range(3):
        resp = c.post(f"/api/v1/kb/{kbid}/resources", json={
            "title": f"routes {i}", "texts": {"t": {"body": f"sentence {i}. another sentence."}},
            "usermetadata": {"classifications": [{"labelset": "topic", "label": "a"}]},
        })
        check(resp.status_code == 201, f"routes: write {i} answered {resp.status_code}")
    found = importlib.util.find_spec
    if found("msgpack"):
        blob = c.get(f"/api/v1/kb/{kbid}/export").content
        copy = c.post("/api/v1/kbs/import?slug=routes-copy", content=blob)
        check(copy.status_code == 201, f"routes: import answered {copy.status_code}")
        n = [c.post(f"/api/v1/kb/{k}/catalog", json={}).json()["total"] for k in (kbid, copy.json()["uuid"])]
        check(n == [3, 3], f"routes: the imported copy holds {n[1]} of {n[0]} resources")
    ran.append(f"export/import {'ran' if found('msgpack') else 'skipped (no msgpack)'}")
    if found("cryptography") and srv.app.learning.endecryptor.active:
        c.patch(f"/api/v1/kb/{kbid}/configuration", json={"openai_key": "sk-secret"})
        check(c.get(f"/api/v1/kb/{kbid}/configuration").json().get("openai_key") == "sk-secret",
              "routes: the learning secret did not come back")
        with srv.app.driver as txn:
            stored = json.loads(txn.get(LEARNING_KEY.format(kbid=kbid)))
        check(stored["openai_key"].startswith("enc::"), "routes: the learning secret is stored in the clear")
    ran.append(f"encrypted secret {'ran' if found('cryptography') else 'skipped (no cryptography)'}")
    if found("flatbuffers"):
        part = c.get(f"/api/v1/kb/{kbid}/trainset").json()["partitions"][0]
        resp = c.post(f"/api/v1/kb/{kbid}/trainset/{part}", json={"type": "FIELD_CLASSIFICATION", "batch_size": 8})
        check(resp.status_code == 200 and resp.content, f"routes: the trainset stream answered {resp.status_code}")
    ran.append(f"trainset {'ran' if found('flatbuffers') else 'skipped (no flatbuffers)'}")
    return ran


def phase_http(torch, tmp, find, cfg, device="cuda"):
    """The standalone server over ``phase_find``'s directory (see the module
    docstring); prints one line per part and returns the launch and
    dispatch counts of its counted main path (the hybrid requests over HTTP
    on both keyword routes)."""
    import importlib.util
    import os
    import signal
    import threading

    import httpx

    from nucliadb_tpu_torch.models.api import FindRequest, KnowledgeboxFindResults, SearchFeature
    from nucliadb_tpu_torch.ops import binary_scan, bm25, slot_scan

    t_phase = time.perf_counter()
    kbid, reqs, n_req = find.kbid, find.reqs, len(find.reqs)
    bodies = [http_body(r) for r in reqs]
    counts, timings = {}, {}
    os.environ.pop("NDBTPU_TEXT_HOST_TIER", None)

    def serve_route(name, solo, resp):
        """Boot, the counted pass, its checks and timings on one route."""
        srv = HttpServer(tmp, device, cfg["bg_interval"])
        app = srv.app
        shards = app.kbs.get_shards(kbid).shards
        check(shards == [find.sid], f"{name}: the boot rolled the knowledge box over ({shards} != {[find.sid]})")
        t = time.perf_counter()
        app._sync(force=True)  # opens the shard's searcher (prewarm) before the counted pass
        t_open = time.perf_counter() - t
        # ---- the main path, counted: the 64 hybrid requests over HTTP ------
        reset_launches(slot_scan, binary_scan)
        bm25.DISPATCHES.clear()
        bm25.LAUNCHES.clear()
        out = [srv.find(kbid, b) for b in bodies]
        c = dict(slot_scan.LAUNCHES, **binary_scan.LAUNCHES, **bm25.DISPATCHES, **bm25.LAUNCHES)
        # ----------------------------------------------------------------------
        tier = app.node.searcher.shard(shards[0]).paragraph.engine.host_tier()
        if device == "cuda":  # on the CPU the wrappers take their plain versions, which count nothing
            check(c.get("top2", 0) >= n_req, f"{name}: the top-2 kernel launched {c}")
        check(c.get("top1", 0) == 0 and c.get("binary", 0) == 0, f"{name}: a kernel of another route launched {c}")
        bm25_n = c.get("single", 0) + c.get("batch", 0)
        bm25_kernel_served(c, f"HTTP, {name} route", device)
        if name == "device":
            check(tier is None and bm25_n >= n_req, f"device route: the BM25 program dispatched {c}")
        elif tier is not None:
            check(bm25_n == 0, f"default route: the host tier dispatched {c}")
        for i, (res, _, _) in enumerate(out):
            find_results_ok(res, f"{name} route, HTTP find {i}")
            find_same(res, solo[i], find_tied(resp[i]), KW_RTOL, f"{name} route, HTTP find {i} vs in process")
        ms = [m for _, _, m in out]
        nbytes = [n for _, n, _ in out]
        tm = {"boot_s": srv.boot_s, "open_s": t_open, "warmup_s": app.warmup_seconds,
              "p50_ms": float(np.percentile(ms, 50)), "p90_ms": float(np.percentile(ms, 90)),
              "bytes_median": float(np.median(nbytes))}
        # the server's own split (debug=True) against the client's clock on
        # the same request: what SearchService's phases leave of the
        # client's ms is the HTTP layer's (parse, validation, routing, the
        # pool hop, the audit event, the JSON dump)
        n_t = min(cfg["timed"], n_req)
        dbg = [srv.find(kbid, dict(b, debug=True)) for b in bodies[:n_t]]
        phases = {k: float(np.median([r.timings[k] for r, _, _ in dbg])) * 1e3 for k in dbg[0][0].timings}
        tm["debug_client_ms_median"] = float(np.median([m for _, _, m in dbg]))
        tm["http_layer_ms"] = float(np.median([m - 1e3 * sum(r.timings.values()) for r, _, m in dbg]))
        tm["phases_ms"] = {k: round(v, 3) for k, v in phases.items()}
        if device == "cuda":
            busy = device_busy_ms(torch, lambda: [srv.find(kbid, b) for b in bodies[:n_t]]) / n_t
            tm["device_busy_per_find_ms"] = busy
            tm["device_idle_share"] = 1.0 - busy / tm["p50_ms"]
        counts[name], timings[name] = c, tm
        return srv, out

    # ---- boot A: the default keyword route ------------------------------------
    srv, out_a = serve_route("default", find.default_out, find.default_resp)
    # ---- 32 keep-alive clients, 128 requests (bench_suite.py config 5) --------
    n_cl, work = cfg["clients"], [i for _ in range(cfg["rounds"]) for i in range(n_req)]
    results, errors, lat = [None] * len(work), [], [None] * len(work)

    def client_worker(w):
        try:
            with httpx.Client(base_url=srv.base, timeout=600) as cl:
                for j in range(w, len(work), n_cl):
                    results[j], _, lat[j] = srv.find(kbid, bodies[work[j]], client=cl)
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=client_worker, args=(w,)) for w in range(n_cl)]
    t = time.perf_counter()
    [th.start() for th in threads]
    [th.join(timeout=1200) for th in threads]
    wall = time.perf_counter() - t
    check(not errors and all(r is not None for r in results), f"concurrent /find failed: {errors[:1]}")
    for j, res in enumerate(results):
        i = work[j]
        find_same(res, out_a[i][0], find_tied(find.default_resp[i]), KW_RTOL, f"concurrent find {j} vs its solo answer")
    conc = {"clients": n_cl, "requests": len(work), "qps": len(work) / wall, "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)), "wall_s": wall}
    srv.stop()
    del srv

    # ---- boot B: the device route, a restart over the same directory ----------
    os.environ["NDBTPU_TEXT_HOST_TIER"] = "0"
    if importlib.util.find_spec("cryptography"):  # B stores learning secrets encrypted
        from nucliadb_tpu_torch.utils.encryption import Endecryptor

        os.environ["NDBTPU_ENCRYPTION_KEY"] = Endecryptor.generate_key()
    srv, _ = serve_route("device", find.device_out, find.device_resp)
    lazy_routes = http_lazy_routes(srv)
    # ---- writes over HTTP: new resources, visible through /find; a deletion ---
    corpus, rng = find.corpus, np.random.default_rng(SEED + 7)
    new = []
    t = time.perf_counter()
    for k in range(cfg["writes"]):
        payload = http_new_payload(corpus, k, SEED + 100 + k)
        resp = srv.client.post(f"/api/v1/kb/{kbid}/resources", json=payload)
        check(resp.status_code == 201, f"write {k} answered {resp.status_code}: {resp.text[:300]}")
        j = int(rng.integers(0, len(payload["embeddings"]["m"]["body"])))
        new.append((resp.json()["uuid"], payload["embeddings"]["m"]["body"][j]["vector"]))
    t_write = time.perf_counter() - t

    def semantic(vector):
        return http_body(FindRequest(query="", vector=vector, features=[SearchFeature.SEMANTIC], top_k=FIND_TOP_K))

    def wait_until(ok, what):
        t0 = time.perf_counter()
        while not ok():
            check(time.perf_counter() - t0 < cfg["deadline"], f"{what} did not show within {cfg['deadline']}s")
            time.sleep(0.5)
        return time.perf_counter() - t0

    def top_is(rid, vector):
        best = srv.find(kbid, semantic(vector))[0].best_matches
        return bool(best) and best[0].startswith(rid + "/")

    t_visible = wait_until(lambda: all(top_is(rid, v) for rid, v in new), f"the {len(new)} writes")
    gone, gone_v = new[0]
    check(srv.client.delete(f"/api/v1/kb/{kbid}/resource/{gone}").status_code == 204, "the deletion was refused")
    t_deleted = wait_until(lambda: gone not in srv.find(kbid, semantic(gone_v))[0].resources, "the deletion")
    check(srv.client.get(f"/api/v1/kb/{kbid}/resource/{gone}").status_code == 404, "the deleted resource is readable")
    final_body = bodies[0]
    seen = find_capture(srv.app.node)
    final_b = srv.find(kbid, final_body)[0]
    final_tied = find_tied(seen[0][0])
    srv.stop()
    del srv, seen
    if device == "cuda":
        torch.cuda.empty_cache()

    # ---- the normal entry point, as a subprocess -------------------------------
    port = free_port()
    t = time.perf_counter()
    with open(f"{tmp}/cli.err", "w+") as log_err:
        # NDBTPU_TEXT_HOST_TIER=0 still set: the CLI serves boot B's route
        proc = subprocess.Popen(http_cli_command(tmp, port, device), stdout=subprocess.DEVNULL, stderr=log_err,
                                cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            with httpx.Client(base_url=f"http://127.0.0.1:{port}", timeout=600) as cl:
                while True:
                    check(proc.poll() is None, f"the CLI exited with {proc.returncode}")
                    check(time.perf_counter() - t < cfg["deadline"], "the CLI did not become ready")
                    try:
                        if cl.get("/health/ready").status_code == 200:
                            break
                    except httpx.TransportError:
                        time.sleep(0.2)
                t_ready = time.perf_counter() - t
                resp = cl.post(f"/api/v1/kb/{kbid}/find", json=final_body)
                check(resp.status_code == 200, f"the CLI's /find answered {resp.status_code}")
                cli_res = KnowledgeboxFindResults.model_validate_json(resp.content)
                find_same(cli_res, final_b, final_tied, KW_RTOL, "the CLI's /find vs boot B's")
                metrics = cl.get("/metrics").text
                m = re.search(r'^ndbtpu_coalescer_dispatches\{index="vector"\} ([0-9.e+]+)$', metrics, re.M)
                check(m is not None and float(m.group(1)) > 0, "the CLI's /metrics shows no vector-coalescer dispatch")
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        log_err.seek(0)
        err = log_err.read()
    os.environ.pop("NDBTPU_TEXT_HOST_TIER", None)
    os.environ.pop("NDBTPU_ENCRYPTION_KEY", None)
    check("Traceback" not in err, f"the CLI's stderr holds a traceback:\n{err[-3000:]}")

    def rounded(d):
        return {k: (rounded(v) if isinstance(v, dict) else round(v, 3)) for k, v in d.items()}

    print(
        f"http requests: {n_req} hybrid /find over HTTP from one keep-alive client on each keyword route, each equal "
        f"to phase_find's in-process answer (ties, scores within {KW_RTOL}); counts default route "
        f"{json.dumps(counts['default'])}, device route {json.dumps(counts['device'])}; {len(work)} requests from "
        f"{n_cl} keep-alive clients equal their solo answers; {len(new)} writes over HTTP in {t_write:.1f}s, each "
        f"/find's top hit for its own vector after {t_visible:.1f}s, a deletion gone after {t_deleted:.1f}s; "
        f"{', '.join(lazy_routes)}; the CLI "
        f"ready in {t_ready:.1f}s, its /find equal to boot B's, exited on SIGTERM ({proc.returncode}) with no traceback",
        flush=True,
    )
    print(
        f"http timings (client ms per /find over the counted pass; boot and open seconds; the server's debug split and "
        f"the client's ms less its phases, medians of {cfg['timed']}): {json.dumps(rounded(timings))}; concurrent "
        f"{json.dumps(rounded(conc))}; phase {time.perf_counter() - t_phase:.1f}s",
        flush=True,
    )
    return SimpleNamespace(default=counts["default"], device=counts["device"])


# ---------------------------------------------------------------------------
# component mode: the substrate, the writer and two searcher replicas, each a
# process of its own, and the cluster's scatter-gather over them
# ---------------------------------------------------------------------------

CLUSTER_FULL = {
    "requests": 64,  # hybrid shard requests through DistributedSearcher (the node phase's shape)
    "threads": 8,  # client threads of the threaded pass and the failover burst
    "kill_after": 16,  # answers of the failover burst before the primary replica is killed
    "cpu": 0,  # answers held again to an in-process node on the CPU (the card tests use it)
    "boot_deadline": 600.0,  # seconds a replica may take to open its port and to answer
    "deadline": 120.0,  # seconds a write may take to be the top hit
}

# A component process as ``python -m nucliadb_tpu_torch.component.run`` runs
# it, whose launch counters (the port's own, ``slot_scan.LAUNCHES`` and
# ``binary_scan.LAUNCHES``), CUDA state and allocator reserve are written to
# the file named by its first argument on SIGUSR1.
CLUSTER_CHILD = """
import json, os, signal, sys
import torch
from nucliadb_tpu_torch.ops import binary_scan, bm25, slot_scan
counts = sys.argv.pop(1)
def report(*_):
    out = dict(slot_scan.LAUNCHES, **binary_scan.LAUNCHES, **bm25.LAUNCHES, cuda_initialized=torch.cuda.is_initialized())
    if out["cuda_initialized"]:  # what its caching allocator holds on the card (its context not included)
        out["torch_reserved_mib"] = torch.cuda.memory_reserved() / 2**20
    with open(counts + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(counts + ".tmp", counts)
signal.signal(signal.SIGUSR1, report)
sys.argv[0] = "run"
from nucliadb_tpu_torch.component.run import main
main()
"""


def cluster_child_command(args: list, counts: str) -> list:
    """The component runner with ``args``, in a process that reports its
    launch counts (see ``CLUSTER_CHILD``)."""
    import sys

    return [sys.executable, "-c", CLUSTER_CHILD, counts, *args]


class ClusterChild:
    """One component process: its command, log, counts file and port."""

    def __init__(self, tmp, name, args, port):
        import os

        self.name, self.port = name, port
        self.counts = f"{tmp}/{name}.counts.json"
        self.log = open(f"{tmp}/{name}.log", "w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cluster_child_command(args, self.counts), stdout=self.log,
                                     stderr=subprocess.STDOUT, cwd=os.path.dirname(os.path.abspath(__file__)))
        self.boot_s = None

    def alive(self, what):
        check(self.proc.poll() is None, f"{what}: {self.name} exited with {self.proc.returncode}:\\n{self.tail()}")

    def tail(self, n=3000) -> str:
        self.log.flush()
        self.log.seek(0)
        return self.log.read()[-n:]

    def wait_port(self, deadline):
        import socket

        while True:
            self.alive("boot")
            try:
                socket.create_connection(("127.0.0.1", self.port), timeout=1).close()
                break
            except OSError:
                check(time.perf_counter() - self.t0 < deadline, f"{self.name}: port {self.port} never opened")
                time.sleep(0.1)
        self.boot_s = time.perf_counter() - self.t0

    def launches(self) -> dict:
        """The child's counters now (SIGUSR1, then its file)."""
        import os
        import signal

        if os.path.exists(self.counts):
            os.remove(self.counts)
        self.alive("counts")
        self.proc.send_signal(signal.SIGUSR1)
        t = time.perf_counter()
        while not os.path.exists(self.counts):
            check(time.perf_counter() - t < 30, f"{self.name} did not report its counts")
            time.sleep(0.02)
        with open(self.counts) as f:
            return json.load(f)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        self.log.close()


def nvidia_smi(query: str) -> list:
    """The rows of ``nvidia-smi --query-<query> --format=csv,noheader,nounits``."""
    out = subprocess.run(["nvidia-smi", f"--query-{query}", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return [[x.strip() for x in line.split(",")] for line in out.strip().splitlines()]


def delta(after: dict, before: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0) for k in ("top1", "top2", "binary", "program")}


def proto_search(address, sid, req) -> dict:
    """``req`` sent as a protobuf ``nidx.NidxSearcher/Search`` (the port's
    own wire codec), its response decoded."""
    import grpc

    from nucliadb_tpu_torch.grpc_plane import protowire as pw

    payload = {"shard_ids": [sid], "body": req.body, "result_per_page": req.top_k, "paragraph": req.paragraph,
               "document": req.document, "vector": [float(x) for x in req.vector], "vectorset": "m"}
    with grpc.insecure_channel(address) as channel:
        fn = channel.unary_unary("/nidx.NidxSearcher/Search", request_serializer=lambda b: b,
                                 response_deserializer=lambda b: b)
        return pw.decode(pw.SEARCH_RESPONSE, fn(pw.encode(pw.SEARCH_REQUEST, payload), timeout=600))


def proto_same(proto, resp, what):
    """A protobuf SearchResponse against the msgpack answer of the same
    request: the same hits in the same order, scores within 1e-6 (the
    protobuf wire carries f32)."""
    legs = (
        ("paragraph", [(r["paragraph"], r["score"]["bm25"]) for r in proto.get("paragraph", {}).get("results", [])],
         [(h.paragraph_id, h.score) for h in resp.paragraph.hits]),
        ("document", [(f"{r['uuid']}/{r['field']}", r["score"]["bm25"])
                      for r in proto.get("document", {}).get("results", [])],
         [(h.key, h.score) for h in resp.document.hits]),
        ("vector", [(r["doc_id"]["id"], r["score"]) for r in proto.get("vector", {}).get("documents", [])],
         [(h.key, h.score) for h in resp.vector]),
    )
    for leg, got, want in legs:
        check(bool(want) and [k for k, _ in got] == [k for k, _ in want], f"{what}: {leg} hits differ")
        check(all(abs(a - b) <= 1e-6 * abs(b) + 1e-7 for (_, a), (_, b) in zip(got, want)), f"{what}: {leg} scores")


def phase_cluster(torch, tmp, find, cfg, device="cuda"):
    """Component mode over ``phase_find``'s knowledge box (see the module
    docstring); prints one line per part and returns the replicas' launch
    counts on the counted main path (the hybrid requests through
    ``DistributedSearcher``)."""
    import os
    import signal
    import threading

    import grpc

    from nucliadb_tpu_torch.cluster import DistributedSearcher, TopologyWatcher
    from nucliadb_tpu_torch.grpc_plane import NodeClient, WriterClient
    from nucliadb_tpu_torch.services import EmbeddedNode
    from nucliadb_tpu_torch.shard import ShardSearchRequest

    t_phase = time.perf_counter()
    corpus, sid, kbid, rows = find.corpus, find.sid, find.kbid, find.rows
    n_req = cfg["requests"]
    reqs = [node_hybrid(corpus, i) for i in range(n_req)]
    base = f"{tmp}/cluster"
    # the substrate's files are the /find phase's: its metadata and blobs
    # (the node's) and its maindb, linked where SubstrateServer opens them
    os.makedirs(f"{base}/s/substrate")
    for name, target in (("metadata.db", f"{tmp}/node/metadata.db"), ("blobs", f"{tmp}/node/blobs"),
                         ("maindb.db", f"{tmp}/maindb.db")):
        os.symlink(target, f"{base}/s/substrate/{name}")
    ports = {name: free_port() for name in ("s", "w", "c1", "c2")}
    topology = f"{base}/nodes.json"
    with open(topology, "w") as f:
        json.dump([{"name": c, "address": f"127.0.0.1:{ports[c]}"} for c in ("c1", "c2")], f)
    sub = f"127.0.0.1:{ports['s']}"
    children = {}
    watcher = writer = None
    try:
        # S: substrate only, and the default --device (cuda): it never
        # resolves it, so it holds no CUDA context
        children["s"] = ClusterChild(base, "s", ["substrate", "--serve-substrate", sub, "--data-dir", f"{base}/s"],
                                     ports["s"])
        children["s"].wait_port(cfg["boot_deadline"])
        children["w"] = ClusterChild(base, "w", [
            "writer", "ingest", "scheduler", "worker", "--substrate", sub, "--device", device,
            "--data-dir", f"{base}/w", "--writer-address", f"127.0.0.1:{ports['w']}"], ports["w"])
        for c in ("c1", "c2"):
            children[c] = ClusterChild(base, c, [
                "searcher", "--substrate", sub, "--topology", topology, "--node-name", c, "--device", device,
                "--data-dir", f"{base}/{c}", "--grpc-address", f"127.0.0.1:{ports[c]}"], ports[c])
        # the in-process node over the same files opens while the replicas boot
        t = time.perf_counter()
        local = EmbeddedNode(f"{tmp}/node", device=device)
        check(sid in local.wait_for_sync(), "the in-process node did not open the shard")
        t_local = time.perf_counter() - t
        for name in ("w", "c1", "c2"):
            children[name].wait_port(cfg["boot_deadline"])
        probe = ShardSearchRequest(body=corpus.bodies[0], vector=corpus.q_np[0], top_k=1, paragraph=True)
        answer_s = {}
        for c in ("c1", "c2"):  # each replica: sync over the substrate, open, first answer
            client, err = NodeClient(f"127.0.0.1:{ports[c]}", timeout=cfg["boot_deadline"]), None
            while True:
                children[c].alive("sync")
                try:
                    resp = client.search(sid, probe)
                    if resp.vector and resp.paragraph and resp.paragraph.hits:
                        break
                except grpc.RpcError as e:  # the shard is not synced yet: asked again until the deadline
                    err = e
                check(time.perf_counter() - children[c].t0 < cfg["boot_deadline"], f"{c} never answered: {err}")
                time.sleep(0.5)
            answer_s[c] = time.perf_counter() - children[c].t0
            client.close()
        print(
            f"cluster boot: ports open after (s) {json.dumps({n: round(c.boot_s, 3) for n, c in children.items()})}, "
            f"replicas answer after (s) {json.dumps({c: round(v, 3) for c, v in answer_s.items()})} (their sync over "
            f"the substrate and open included); the in-process node opened in {t_local:.1f}s",
            flush=True,
        )
        watcher = TopologyWatcher(topology, make_backend=lambda name, address: NodeClient(address, timeout=600))
        cluster = DistributedSearcher(watcher.backends, watcher.selector)
        primary, other = watcher.selector.nodes_for_shard(sid)
        check({primary, other} == {"c1", "c2"}, "both replicas must own the shard")

        def ask(req):
            resp, errors = cluster.search([sid], req)
            check(errors == [], f"ShardError: {errors}")
            return resp

        # ---- the main path, counted: the hybrid requests over the replicas ----
        before = {c: children[c].launches() for c in ("c1", "c2")}
        out, ms = [], []
        for req in reqs:
            t = time.perf_counter()
            out.append(ask(req))
            ms.append((time.perf_counter() - t) * 1e3)
        after = {c: children[c].launches() for c in ("c1", "c2")}
        # ------------------------------------------------------------------
        counted = {c: delta(after[c], before[c]) for c in ("c1", "c2")}
        if device == "cuda":  # on the CPU the wrappers take their plain versions, which count nothing
            check(counted[primary]["top2"] >= n_req, f"the answering replica launched {counted[primary]}")
            check(counted[other]["top2"] == 0, f"the idle replica launched {counted[other]}")
        check(all(v["top1"] == v["binary"] == 0 for v in counted.values()), f"a kernel of another route: {counted}")
        local_out, local_ms = [], []
        for req in reqs:
            t = time.perf_counter()
            local_out.append(local.search(sid, req))
            local_ms.append((time.perf_counter() - t) * 1e3)
        for i, (a, b) in enumerate(zip(out, local_out)):
            node_same(a, b, KW_RTOL, f"cluster request {i} vs the in-process node")
            check(len(a.vector) == NODE_TOP_K and a.paragraph is not None and a.document is not None,
                  f"cluster request {i}: a leg is missing")
        check(all(sum(len(getattr(r, leg).hits) for r in out) for leg in ("paragraph", "document")),
              "no keyword leg matched anything")
        q_dev = torch.from_numpy(corpus.q_np[:n_req]).to(device)
        vecs = torch.from_numpy(corpus.vecs_np).to(device)
        oracle = exact_oracle(torch, vecs, torch.ones(len(vecs), dtype=torch.bool, device=device), q_dev, TOP_K)
        del vecs, q_dev

        def row(key):
            parts = key.split("/")
            return rows.get("/".join(parts[:-2] + parts[-1:]), -1)

        recall = float(np.mean([len({row(h.key) for h in r.vector[:TOP_K]} & set(oracle[i].tolist())) / TOP_K
                                for i, r in enumerate(out)]))
        check(recall >= RECALL_BAR, f"cluster vector recall@10 {recall} < {RECALL_BAR}")
        n_c = cfg["cpu"]
        if n_c:  # the card's replica against the CPU, over the same segments
            cpu = EmbeddedNode(f"{tmp}/node", device="cpu")
            for i in range(n_c):
                node_same(out[i], cpu.search(sid, reqs[i]), NODE_CPU_RTOL, f"cluster request {i} vs a CPU node")
            del cpu

        # ---- the protobuf wire: one request through NidxSearcher -------------
        proto_same(proto_search(f"127.0.0.1:{ports[primary]}", sid, reqs[0]), out[0], "protobuf Search")

        # ---- 8 client threads: each answer its solo answer --------------------
        def burst(indices, kill=None):
            """``reqs[i]`` for i in ``indices`` from the client threads;
            (answers, [(start, end)] seconds); ``kill`` runs once
            ``cfg['kill_after']`` answers are in."""
            got, spans, errors, done = [None] * len(indices), [None] * len(indices), [], []
            lock = threading.Lock()

            def worker(w):
                try:
                    for j in range(w, len(indices), cfg["threads"]):
                        t0 = time.perf_counter()
                        got[j] = ask(reqs[indices[j]])
                        spans[j] = (t0, time.perf_counter())
                        with lock:
                            done.append(j)
                            if kill is not None and len(done) == cfg["kill_after"]:
                                kill()
                except BaseException as e:  # reported below
                    errors.append(e)

            threads = [threading.Thread(target=worker, args=(w,)) for w in range(cfg["threads"])]
            [th.start() for th in threads]
            [th.join(timeout=600) for th in threads]
            check(not errors and all(g is not None for g in got), f"a threaded request failed: {errors[:1]}")
            return got, spans

        t = time.perf_counter()
        for req in reqs:  # the same requests one after another, warm
            ask(req)
        t_warm = (time.perf_counter() - t) * 1e3
        before = {c: children[c].launches() for c in ("c1", "c2")}
        t = time.perf_counter()
        threaded, _ = burst(list(range(n_req)))
        t_threads = (time.perf_counter() - t) * 1e3
        for i, r in enumerate(threaded):
            node_same(r, out[i], KW_RTOL, f"threaded cluster request {i} vs its solo answer")
        threaded_launches = {c: delta(children[c].launches(), before[c]) for c in ("c1", "c2")}

        # ---- memory and contexts on the card, every process alive ------------
        contexts = {}
        if device == "cuda":
            # nvidia-smi lists pids of its own namespace, which may not be
            # these processes' (then no child pid appears among them)
            apps = {int(pid): (float(mib) if mib.replace(".", "", 1).isdigit() else None)
                    for pid, mib in nvidia_smi("compute-apps=pid,used_memory")}
            for name, child in children.items():
                state = child.launches()
                contexts[name] = {"cuda_initialized": state["cuda_initialized"],
                                  "torch_reserved_mib": state.get("torch_reserved_mib"),
                                  "listed": child.proc.pid in apps, "nvidia_smi_mib": apps.get(child.proc.pid)}
            contexts["parent"] = {"torch_reserved_mib": torch.cuda.memory_reserved() / 2**20}
            contexts["card"] = {"compute_apps_listed": len(apps),
                                "memory_used_mib": float(nvidia_smi("gpu=memory.used")[0][0])}
            check(not contexts["s"]["cuda_initialized"] and not contexts["s"]["listed"],
                  f"the substrate process holds a CUDA context: {contexts['s']}")
            check(all(contexts[c]["cuda_initialized"] for c in ("c1", "c2")), f"a replica never used the card: {contexts}")

        # ---- failover: the primary replica killed mid-burst -------------------
        before_other = children[other].launches()
        killed = {}

        def kill():
            killed["t"] = time.perf_counter()
            children[primary].proc.send_signal(signal.SIGKILL)

        got, spans = burst(list(range(n_req)), kill=kill)
        check("t" in killed, "the primary was never killed")
        children[primary].proc.wait(timeout=60)
        for i, r in enumerate(got):
            node_same(r, out[i], KW_RTOL, f"failover request {i} vs its answer before the kill")
        after_kill = [(s, e) for s, e in spans if e > killed["t"]]
        failover_ms = max(e - s for s, e in after_kill) * 1e3
        after_kill_p50_ms = float(np.percentile([e - s for s, e in after_kill], 50)) * 1e3
        started_after = sum(1 for s, _ in spans if s > killed["t"])
        took_over = delta(children[other].launches(), before_other)
        check(started_after > 0, "no request started after the kill")
        if device == "cuda":  # its coalescer may serve concurrent requests with one launch
            check(took_over["top2"] > 0, f"{other} launched {took_over} for {started_after} requests")

        # ---- a write through the writer plane, until it is the top hit --------
        writer = WriterClient(f"127.0.0.1:{ports['w']}", timeout=600)
        payload = http_new_payload(corpus, 0, SEED + 500)
        vector = np.asarray(payload["embeddings"]["m"]["body"][3]["vector"], np.float32)
        t = time.perf_counter()
        rid = writer.process_message(kbid, "create", payload=payload)["rid"]
        t_ack = time.perf_counter() - t
        semantic = ShardSearchRequest(vector=vector, top_k=NODE_TOP_K, paragraph=False)
        while True:
            resp = ask(semantic)
            if resp.vector and resp.vector[0].key.startswith(rid + "/"):
                break
            check(time.perf_counter() - t < cfg["deadline"], f"the write was not the top hit within {cfg['deadline']}s")
            time.sleep(0.2)
        t_visible = time.perf_counter() - t
        for name, child in children.items():
            if name != primary:
                child.alive("the end of the phase")
    finally:
        if writer is not None:
            writer.close()
        if watcher is not None:
            for client in watcher.backends.values():
                client.close()
        for child in children.values():
            child.stop()
    for name, child in children.items():
        check("Traceback" not in open(f"{base}/{name}.log").read(), f"{name} logged a traceback")
    del local
    if device == "cuda":
        torch.cuda.empty_cache()

    timings = {
        "boot_s": {n: round(c.boot_s, 3) for n, c in children.items()},
        "answers_after_s": {c: round(v, 3) for c, v in answer_s.items()},
        "in_process_open_s": round(t_local, 3),
        "client_p50_ms": float(np.percentile(ms, 50)), "client_p90_ms": float(np.percentile(ms, 90)),
        "in_process_p50_ms": float(np.percentile(local_ms, 50)), "in_process_p90_ms": float(np.percentile(local_ms, 90)),
        "grpc_layer_ms": float(np.median(np.array(ms) - np.array(local_ms))),
        "first_request_ms": ms[0], "sequential_ms": t_warm, "threads_ms": t_threads,
        "failover_ms": failover_ms, "after_kill_p50_ms": after_kill_p50_ms,
        "write_ack_s": t_ack, "write_visible_s": t_visible,
    }
    print(
        f"cluster requests: substrate process over the /find phase's files, writer/ingest/scheduler/worker and two "
        f"searcher replicas (--device {device}, topology file, replication 2), each its own process; {n_req} hybrid "
        f"requests through DistributedSearcher equal the in-process node's (ties, scores within {KW_RTOL}), vector "
        f"recall@10 {recall:.4f}; launches {json.dumps(counted)} (primary {primary}); {n_c} equal to a CPU node "
        f"within {NODE_CPU_RTOL}; the protobuf Search equals the msgpack answer; {n_req} requests from "
        f"{cfg['threads']} threads equal their solo answers (launches {json.dumps(threaded_launches)}); {primary} "
        f"killed after {cfg['kill_after']} answers of a burst: every request answered with the same answers, "
        f"{started_after} started after the kill, {other} launched {json.dumps(took_over)}; a write the top hit",
        flush=True,
    )
    print(
        f"cluster timings (host clock; client ms per request through DistributedSearcher over gRPC against the "
        f"in-process node's on the same requests; the {n_req} one after another, warm, and from {cfg['threads']} "
        f"threads; the slowest request across the kill and the p50 of those ending after it): {json.dumps({k: (round(v, 3) if isinstance(v, float) else v) for k, v in timings.items()})}; "
        f"contexts {json.dumps(contexts)}; phase {time.perf_counter() - t_phase:.1f}s",
        flush=True,
    )
    return SimpleNamespace(launches=counted[primary], idle=counted[other], took_over=took_over,
                           started_after=started_after, timings=timings, contexts=contexts)


# ---------------------------------------------------------------------------
# the ops path: the tool and migrator CLIs, the SDK with spans exported over
# OTLP, and a node whose segments come over the S3 protocol
# ---------------------------------------------------------------------------

OPS_FULL = {
    "requests": 16,  # /find requests of each SDK pass and hybrid shard requests of the S3-backed node
    "cli_timeout": 120.0,  # seconds each CLI may take
    "budget_s": 60.0,  # the phase's own limit
}


class OtlpSink:
    """An OTLP/HTTP collector on 127.0.0.1: keeps the body of every
    ``POST /v1/traces``."""

    def __init__(self):
        import http.server
        import threading

        bodies = self.bodies = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                if self.path == "/v1/traces" and self.headers.get("Content-Type") == "application/x-protobuf":
                    bodies.append(body)
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.endpoint = f"http://127.0.0.1:{self.server.server_port}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def spans(self) -> list:
        """Every span of every body, decoded by the port's wire codec with
        ``otlp.py``'s schema."""
        from nucliadb_tpu_torch.grpc_plane.protowire import decode
        from nucliadb_tpu_torch.telemetry.otlp import EXPORT_TRACE_SERVICE_REQUEST

        return [s for body in self.bodies for rs in decode(EXPORT_TRACE_SERVICE_REQUEST, body)["resource_spans"]
                for ss in rs.get("scope_spans", []) for s in ss.get("spans", [])]

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


def load_cloud_fakes():
    """``tests/cloud_fakes.py`` loaded by its path (it imports only the
    standard library)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "cloud_fakes.py")
    spec = importlib.util.spec_from_file_location("cloud_fakes", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def counting_fake_s3(fakes, bucket, access_key, secret_key):
    """``make_fake_s3`` (SigV4 checked on every request) whose handler also
    counts the object GETs it serves, their bytes and its refusals."""
    import threading

    server, endpoint, blobs = fakes.make_fake_s3(bucket, access_key, secret_key)
    served = {"gets": 0, "get_bytes": 0, "puts": 0, "refused": 0}
    lock = threading.Lock()  # the fake serves each request on a thread of its own
    base = server.RequestHandlerClass

    class Counting(base):
        def _send(self, status, body=b"", content_type="application/xml", headers=None):
            with lock:
                if status == 403:
                    served["refused"] += 1
                elif self.command == "GET" and content_type == "application/octet-stream":
                    served["gets"] += 1
                    served["get_bytes"] += len(body)
                elif self.command == "PUT" and status == 200:
                    served["puts"] += 1
            return super()._send(status, body, content_type, headers)

    server.RequestHandlerClass = Counting
    return server, endpoint, blobs, served


def phase_ops(torch, tmp, find, cfg, device="cuda"):
    """The ops path over ``phase_find``'s knowledge box, after the HTTP and
    cluster phases (see the module docstring); prints one line per part and
    returns the top-2 launches of its counted passes (the SDK's and the
    S3-backed node's)."""
    import os
    import sqlite3
    import sys

    from nucliadb_tpu_torch.metadata import MetadataStore
    from nucliadb_tpu_torch.ops import binary_scan, bm25, slot_scan
    from nucliadb_tpu_torch.sdk import NucliaDBClient
    from nucliadb_tpu_torch.services import EmbeddedNode
    from nucliadb_tpu_torch.settings import StorageSettings
    from nucliadb_tpu_torch.storage import LocalStorage, make_storage
    from nucliadb_tpu_torch.telemetry import tracing
    from nucliadb_tpu_torch.telemetry.otlp import OTLPHttpExporter

    t_phase = time.perf_counter()
    corpus, sid, kbid, rows = find.corpus, find.sid, find.kbid, find.rows
    n_req = cfg["requests"]
    # the S3 fake, and every object of the node's blob store put into it
    # through the port's S3 backend while the CLIs run in processes of their
    # own (the parent only waits on them)
    fakes = load_cloud_fakes()
    server, endpoint, blobs, served = counting_fake_s3(fakes, "ndb", "AKID", "sekrit")
    s3 = make_storage(StorageSettings(backend="s3", endpoint=endpoint, bucket="ndb", access_key="AKID",
                                      secret_key="sekrit"))
    local_blobs = LocalStorage(f"{tmp}/node/blobs")

    def put(key):
        data = local_blobs.get(key)
        s3.put(key, data)
        return len(data)

    def upload():
        t = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:  # some 2,000 objects: their round trips overlap
            return sum(pool.map(put, local_blobs.list())), time.perf_counter() - t

    uploader = ThreadPoolExecutor(1)
    uploading = uploader.submit(upload)
    s3_node = local = None
    try:
        # ---- 1. the CLIs on the card, as subprocesses (started together) ------
        tool = [sys.executable, "-m", "nucliadb_tpu_torch.tool", "--data-dir", tmp, "--device", device]
        commands = {"list-kbs": tool + ["list-kbs"], "shards": tool + ["shards", kbid],
                    "migrator --dry-run": [sys.executable, "-m", "nucliadb_tpu_torch.migrator", "--data-dir", tmp,
                                           "--device", device, "--dry-run"]}
        procs = {}
        for what, argv in commands.items():
            procs[what] = (time.perf_counter(), subprocess.Popen(
                argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=os.path.dirname(os.path.abspath(__file__))))
        cli_out, cli_s = {}, {}
        for what, (t0, proc) in procs.items():
            out, err = proc.communicate(timeout=cfg["cli_timeout"])
            cli_s[what] = time.perf_counter() - t0
            check(proc.returncode == 0, f"{what} exited with {proc.returncode}:\n{err[-3000:]}")
            check("Traceback" not in err, f"{what} logged a traceback:\n{err[-3000:]}")
            cli_out[what] = out
        check(any(line.startswith(f"{kbid}  slug=") for line in cli_out["list-kbs"].splitlines()),
              f"list-kbs does not list {kbid}: {cli_out['list-kbs'][:500]}")
        shard_lines = cli_out["shards"].splitlines()
        check(f"shard {sid} (writable)" in shard_lines, f"shards: no writable {sid}: {cli_out['shards'][:500]}")
        m = re.search(r"^  vector/m: (\d+) segments, (\d+) records, (\d+) bytes$", cli_out["shards"], re.M)
        check(m is not None, f"shards: no line for the vector index: {cli_out['shards'][:500]}")
        vector_records = int(m.group(2))
        check(vector_records >= len(rows), f"shards: the vector index holds {vector_records} < {len(rows)} records")
        check(cli_out["migrator --dry-run"].strip().endswith("pending: []"),
              f"the migrator's dry run: {cli_out['migrator --dry-run'][:500]}")
        print(
            f"ops CLIs (--device {device}, as subprocesses started together): list-kbs lists {kbid}; shards reports "
            f"{sid} (writable), vector/m {m.group(1)} segments, {vector_records} records, {m.group(3)} bytes; the "
            f"migrator's dry run lists nothing pending; seconds {json.dumps({k: round(v, 3) for k, v in cli_s.items()})}",
            flush=True,
        )

        put_bytes, t_put = uploading.result()  # before the SDK's timings
        check(served["puts"] > 0 and served["refused"] == 0, f"the S3 puts: {served}")

        # ---- 2. the SDK against the server, spans exported over OTLP -----------
        reqs = find.reqs[:n_req]
        bodies = [http_body(r) for r in reqs]
        sink = OtlpSink()
        saved_env = {k: os.environ.get(k) for k in ("NDBTPU_TELEMETRY__OTLP", "NO_PROXY", "no_proxy")}
        saved_tracer = tracing._tracer
        os.environ["NDBTPU_TELEMETRY__OTLP"] = sink.endpoint
        # the sink is local: no proxy of the environment may stand between
        os.environ["NO_PROXY"] = os.environ["no_proxy"] = "127.0.0.1,localhost"
        os.environ.pop("NDBTPU_TEXT_HOST_TIER", None)
        srv = None
        try:
            if tracing._OTEL:
                # the OpenTelemetry SDK would take the export: the port's
                # exporter goes on the built-in tracer instead, so it is the
                # one exercised
                tracing.setup_tracing(exporter=OTLPHttpExporter(sink.endpoint))
                tracer_kind = "built-in tracer, the port's OTLPHttpExporter attached by the phase (the OTel SDK imports)"
            else:
                tracing.setup_tracing()
                tracer_kind = "setup_tracing: the built-in tracer with the port's OTLPHttpExporter (no OTel SDK)"
            check(isinstance(tracing._tracer, tracing._MiniTracer)
                  and isinstance(tracing._tracer.exporter, OTLPHttpExporter), f"no OTLP exporter: {tracing._tracer!r}")
            exporter = tracing._tracer.exporter
            srv = HttpServer(tmp, device, HTTP_FULL["bg_interval"])
            srv.app._sync(force=True)
            seen = find_capture(srv.app.node)
            raw = [srv.find(kbid, b) for b in bodies]
            raw_resp = [s[0] for s in seen[-n_req:]]
            sdk = NucliaDBClient(srv.base, timeout=600)
            try:
                # ---- the main path, counted: the SDK's /find --------------------
                reset_launches(slot_scan, binary_scan, bm25)
                sdk_out, sdk_ms = [], []
                for req in reqs:
                    t = time.perf_counter()
                    sdk_out.append(sdk.find(kbid, req))
                    sdk_ms.append((time.perf_counter() - t) * 1e3)
                sdk_launches = dict(slot_scan.LAUNCHES, **binary_scan.LAUNCHES, **bm25.LAUNCHES)
                # ------------------------------------------------------------------
            finally:
                sdk.close()
            tracing.teardown_tracing()  # flushes the exporter
            exporter._thread.join(30)
            check(not exporter._thread.is_alive(), "the OTLP exporter's flusher did not stop")
            # raw httpx again (untraced), as warm as the SDK's pass was: the
            # two raw passes bracket it, so the order does not decide the p50s
            raw_after = [srv.find(kbid, b) for b in bodies]
            check(type(sdk_out[0]).__module__ == "nucliadb_tpu_torch.models.api", "the SDK parsed into another package")
            for i, (res, (want, _, _), (again, _, _)) in enumerate(zip(sdk_out, raw, raw_after)):
                find_results_ok(res, f"SDK find {i}")
                find_same(res, want, find_tied(raw_resp[i]), KW_RTOL, f"SDK find {i} vs raw httpx")
                find_same(again, want, find_tied(raw_resp[i]), KW_RTOL, f"raw httpx find {i}, second pass")
            if device == "cuda":  # on the CPU the wrappers take their plain versions, which count nothing
                check(sdk_launches.get("top2", 0) == n_req, f"the SDK pass launched {sdk_launches}")
            check(sdk_launches.get("top1", 0) == sdk_launches.get("binary", 0) == 0,
                  f"the SDK pass launched a kernel of another route: {sdk_launches}")
            srv.stop()
            srv = None
        finally:
            if srv is not None:
                srv.stop()
            tracing._tracer = saved_tracer
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            sink.stop()
        spans = sink.spans()
        finds = [s for s in spans if s.get("name") == "search.find"]
        check(len(finds) == 2 * n_req, f"the sink decoded {len(finds)} search.find spans of {2 * n_req}")
        for s in finds:
            attrs = {a["key"]: a["value"].get("string_value") for a in s.get("attributes", [])}
            check(attrs.get("kbid") == kbid, f"a search.find span without its kbid: {attrs}")
            check(len(s["trace_id"]) == 16 and re.fullmatch("[0-9a-f]{32}", s["trace_id"].hex()) is not None,
                  f"a search.find span's trace id: {s['trace_id']!r}")
        raw_p50 = float(np.percentile([ms for _, _, ms in raw], 50))
        raw_after_p50 = float(np.percentile([ms for _, _, ms in raw_after], 50))
        sdk_p50 = float(np.percentile(sdk_ms, 50))
        print(
            f"ops SDK: {n_req} NucliaDBClient.find answers equal raw httpx's on the same server (ties, scores within "
            f"{KW_RTOL}); launches {json.dumps(sdk_launches)}; client p50 raw httpx {raw_p50:.3f} ms, then SDK "
            f"{sdk_p50:.3f} ms, then raw httpx again {raw_after_p50:.3f} ms; OTLP: {tracer_kind}; the sink got {len(sink.bodies)} POST /v1/traces, "
            f"{len(spans)} spans, {len(finds)} search.find spans with their kbid and a 32-hex trace id",
            flush=True,
        )

        # ---- 3. a node whose segments come over the S3 protocol ---------------
        remote = f"{tmp}/ops_s3_node"
        os.makedirs(remote)
        src = sqlite3.connect(f"{tmp}/node/metadata.db")
        dst = sqlite3.connect(f"{remote}/metadata.db")
        src.backup(dst)  # the file is in WAL mode: a copy of the file alone may miss commits
        src.close()
        dst.close()
        t = time.perf_counter()
        s3_node = EmbeddedNode(remote, metadata=MetadataStore(f"{remote}/metadata.db"), storage=s3, device=device)
        synced = s3_node.wait_for_sync()
        t_sync = time.perf_counter() - t
        check(sid in synced, "the S3-backed node did not open the shard")
        check(not os.path.exists(f"{remote}/blobs"), "the S3-backed node wrote a local blob store")
        reqs_node = [node_hybrid(corpus, i) for i in range(n_req)]
        # ---- the main path, counted: the S3-backed node's hybrid requests ------
        reset_launches(slot_scan, binary_scan, bm25)
        s3_out, s3_ms = [], []
        for req in reqs_node:
            t = time.perf_counter()
            s3_out.append(s3_node.search(sid, req))
            s3_ms.append((time.perf_counter() - t) * 1e3)
        s3_launches = dict(slot_scan.LAUNCHES, **binary_scan.LAUNCHES, **bm25.LAUNCHES)
        # ----------------------------------------------------------------------
        t_first = t_sync + s3_ms[0] / 1e3
        segments = [seg for index in s3_node.metadata.get_indexes(sid)
                    for seg in s3_node.metadata.ready_segments(index.id)]
        check(served["gets"] >= len(segments) and served["refused"] == 0,
              f"the fake served {served} for {len(segments)} segments of the shard")
        local = EmbeddedNode(f"{tmp}/node", device=device)
        check(sid in local.wait_for_sync(), "the in-process node over the local files did not open the shard")
        for i, req in enumerate(reqs_node):
            node_same(s3_out[i], local.search(sid, req), KW_RTOL, f"S3-backed node request {i} vs the local node")
            check(len(s3_out[i].vector) == NODE_TOP_K and s3_out[i].paragraph is not None,
                  f"S3-backed node request {i}: a leg is missing")
        if device == "cuda":
            check(s3_launches.get("top2", 0) == n_req, f"the S3-backed node launched {s3_launches}")
        check(s3_launches.get("top1", 0) == s3_launches.get("binary", 0) == 0,
              f"the S3-backed node launched a kernel of another route: {s3_launches}")
    finally:
        del s3_node, local
        uploader.shutdown(wait=True)
        server.shutdown()
        server.server_close()
    if device == "cuda":
        torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(
        f"ops S3: {len(blobs)} objects, {put_bytes} bytes put through the port's S3Storage (SigV4 checked by the "
        f"fake) from 8 threads in {t_put:.3f}s; an EmbeddedNode over a copy of the metadata and the S3 storage (no local blob "
        f"store) synced in {t_sync:.3f}s, {served['gets']} signed GETs of {served['get_bytes']} bytes for "
        f"{len(segments)} segments, 0 refused; construction to first answer {t_first:.3f}s; {n_req} hybrid "
        f"requests equal the local node's (ties, scores within {KW_RTOL}), launches {json.dumps(s3_launches)}, "
        f"p50 {float(np.percentile(s3_ms, 50)):.3f} ms; phase {phase_s:.1f}s",
        flush=True,
    )
    check(phase_s <= cfg["budget_s"], f"phase_ops took {phase_s:.1f}s > {cfg['budget_s']}s")
    return SimpleNamespace(sdk=sdk_launches, s3=s3_launches,
                           launches={k: sdk_launches.get(k, 0) + s3_launches.get(k, 0) for k in ("top1", "top2", "binary", "program")},
                           timings={"cli_s": cli_s, "sdk_p50_ms": sdk_p50, "raw_p50_ms": raw_p50,
                                    "raw_after_p50_ms": raw_after_p50, "s3_put_s": t_put,
                                    "s3_sync_s": t_sync, "first_answer_s": t_first, "phase_s": phase_s},
                           served=served, spans=len(finds))


# ---------------------------------------------------------------------------
# the opt-in ANN strategies: the HNSW graph and IVF, through the vector index
# and the node
# ---------------------------------------------------------------------------

ANN_FULL = {
    # BASELINE config 1's shape: one segment of 100,000 x 768 (below the
    # reference's 200k merge cap), dot over normalised rows, top-10
    "rows": 100_000,
    "dim": 768,
    "centers": 4096,  # tools/hnsw_build_bench.py's recipe
    "queries": 1024,
    "batch": 64,
    "cpu_batch": 64,  # the first batch answered again by a searcher on the CPU
    # the node: a shard whose vectorset is flagged hnsw
    "node": {"resources": 100, "paragraphs": 200, "dim": DIM, "hybrid": 16, "threaded": 16, "delta": 0, "cpu": 0},
}
ANN_NPROBE = 16
# filtered recall of the graph walk under the 30 % label filter: 0.86 at
# 100,000 x 768 on the card (PERF.md §6), below the 0.9 that
# tests/test_hnsw.py holds at 2,000 rows (the JAX package's walk, which the
# port's equals)
ANN_FILTER_BAR = 0.8
ANN_STITCHED_BAR = 0.9  # stitched graphs (tests/test_vector_hnsw_strategy.py's bar)
# the node's vector leg on the walk: the JAX package's bar for the hnsw
# strategy through the vector index (tests/test_vector_hnsw_strategy.py).
# The walk over the node's corpus reaches 0.944 on these 16 requests, as
# the JAX package's walk does on it (PERF.md §6); phase_node's int8 scan
# is held to RECALL_BAR
ANN_NODE_BAR = 0.9


def ann_elems(vecs_np):
    """One paragraph per row: ``key_of(i)``, the label "/l/thirty" on rows
    i % 10 < 3 (30 %) and "/l/five" on rows i % 20 == 0 (5 %)."""
    from nucliadb_tpu_torch.index.vector import Elem

    def labels(i):
        return (["/l/thirty"] if i % 10 < 3 else []) + (["/l/five"] if i % 20 == 0 else [])

    return [Elem(key=key_of(i), vectors=vecs_np[i], labels=labels(i)) for i in range(vecs_np.shape[0])]


def ann_search_all(searcher, q_np, batch, **kw):
    from nucliadb_tpu_torch.index.vector import VectorSearchRequest

    hits = []
    for lo in range(0, q_np.shape[0], batch):
        hits += searcher.search(VectorSearchRequest(vectors=q_np[lo : lo + batch], top_k=TOP_K, **kw))
    return hits


def ann_recall(hits, oracle) -> float:
    return float(np.mean([
        len({h.key for h in row[:TOP_K]} & {key_of(int(i)) for i in oracle[r] if i >= 0}) / TOP_K
        for r, row in enumerate(hits)
    ]))


def phase_ann(torch, tmp, cfg, device="cuda"):
    """The ``hnsw`` and ``ivf`` strategies on ``device`` (module docstring,
    part 10); prints one line per part and returns the counts of the
    counted paths."""
    from nucliadb_tpu_torch.index.vector import (
        LabelAtom, Seq, SimpleOpenIndex, VectorConfig, VectorSearcher, VectorSearchRequest, create_segment,
    )
    from nucliadb_tpu_torch.ops import binary_scan, hnsw, ivf, slot_scan
    from nucliadb_tpu_torch.services import EmbeddedNode
    from nucliadb_tpu_torch.tools.hnsw_build_bench import LinkTimer, clustered_corpus, near_queries

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t_phase = time.perf_counter()
    n, d, n_q, bsz = cfg["rows"], cfg["dim"], cfg["queries"], cfg["batch"]
    n_batches = -(-n_q // bsz)
    vecs = clustered_corpus(n, d, device=device, seed=SEED, n_centers=cfg["centers"])
    queries = near_queries(vecs, n_q, seed=SEED + 1)
    vecs[1:3] = vecs[0]  # planted duplicates of row 0
    vecs_np, q_np = vecs.cpu().numpy(), queries.cpu().numpy()
    elems = ann_elems(vecs_np)
    # the oracles: rows 1 and 2 repeat row 0, which the dedup keeps alone
    alive = torch.ones(n, dtype=torch.bool, device=vecs.device)
    alive[1:3] = False
    oracle = exact_oracle(torch, vecs, alive, queries, TOP_K)
    rows = torch.arange(n, device=vecs.device)
    thirty, five = alive & (rows % 10 < 3), alive & (rows % 20 == 0)
    filt_q = queries[:bsz]
    oracle30 = exact_oracle(torch, vecs, thirty, filt_q, TOP_K)
    oracle5 = exact_oracle(torch, vecs, five, filt_q, TOP_K)
    dup_q = vecs_np[0] + np.float32(1e-3) * np.random.default_rng(SEED).standard_normal(d).astype(np.float32)
    dup_keys = {key_of(0), key_of(1), key_of(2)}
    out = {}

    def busy_share(fn, wall_ms):
        return device_busy_ms(torch, fn) / wall_ms if device == "cuda" else None

    def check_filtered(searcher):
        """The 30 % and 5 % label filters: only labelled rows, held to the
        filtered oracle; the walk answers the first, the scan the second
        (``hnsw.SEARCHES`` grows by one and by none)."""
        res = {}
        for label, want, bar, walks in (("/l/thirty", oracle30, ANN_FILTER_BAR, 1), ("/l/five", oracle5, 0.99, 0)):
            before = hnsw.SEARCHES["search"]
            hits = searcher.search(VectorSearchRequest(vectors=q_np[:bsz], top_k=TOP_K, filter=LabelAtom(label)))
            check(hnsw.SEARCHES["search"] - before == walks, f"hnsw, {label}: {hnsw.SEARCHES['search'] - before} walks")
            check(all(label in h.labels for row in hits for h in row), f"hnsw, {label}: an unlabelled row passed")
            res[label] = ann_recall(hits, want)
            check(res[label] >= bar, f"hnsw, {label}: filtered recall@10 {res[label]} < {bar}")
        return res

    def check_dedup(searcher, what):
        for with_dup, copies in ((False, 1), (True, 3)):
            hits = searcher.search(VectorSearchRequest(vectors=dup_q, top_k=TOP_K, with_duplicates=with_dup))[0]
            got = len({h.key for h in hits} & dup_keys)
            check(got == copies, f"{what}: with_duplicates={with_dup} returned {got} of the 3 copies")

    # ---- HNSW: the graph built at create, opened without a build ------------
    cfg_h = VectorConfig(dimension=d, flags=["hnsw"])
    builds = hnsw.BUILDS["graph"]
    t = time.perf_counter()
    with LinkTimer(hnsw) as link:
        meta = create_segment(f"{tmp}/hnsw", elems, cfg_h, device=device)
        sync()
    build_s = time.perf_counter() - t
    check(hnsw.BUILDS["graph"] == builds + 1 and meta.index_metadata["has_graph"], "create_segment built no graph")
    open_index = SimpleOpenIndex(segment_list=[(meta, Seq(1))])
    t = time.perf_counter()
    searcher = VectorSearcher(cfg_h, open_index, device=device)
    sync()
    open_s = time.perf_counter() - t
    idx = searcher.index
    check(hnsw.BUILDS["graph"] == builds + 1, "the searcher rebuilt the persisted graph")
    check(idx.graph is not None and idx.graph.n_segments == 1 and idx.codes is None and not idx.host_resident(),
          "the hnsw index is not on the graph route")
    ef, trips = hnsw.default_search_params(n)
    # the counted path: every batch walks the graph, no slot scan launches
    reset_launches(slot_scan, binary_scan)
    hnsw.SEARCHES.clear()
    sync()
    t = time.perf_counter()
    hits = ann_search_all(searcher, q_np, bsz)
    walk_s = time.perf_counter() - t
    counts = dict(hnsw.SEARCHES)
    check(counts.get("search", 0) == n_batches, f"hnsw: {counts} walks for {n_batches} batches")
    check(not slot_scan.LAUNCHES and not binary_scan.LAUNCHES, "hnsw: a slot scan launched")
    check_batch(hits, n_q, "hnsw")
    recall_h = ann_recall(hits, oracle)
    check(recall_h >= RECALL_BAR, f"hnsw recall@10 {recall_h} < {RECALL_BAR} (ef {ef}, {trips} trips)")
    req = VectorSearchRequest(vectors=q_np[:bsz], top_k=TOP_K)
    ms_h, _ = median_ms(lambda: searcher.search(req))
    trips_walk = counts.get("trips", 0) / max(counts.get("search", 1), 1)
    print(
        f"ann hnsw: {n} x {d} on {device}; graph built at create in {build_s:.1f}s, of it the host linker "
        f"{link.seconds:.1f}s ({link.calls} waves of {hnsw.WAVE}, {hnsw.WAVES_PER_CALL} per call, native "
        f"{hnsw._native is not None}), opened in {open_s:.1f}s "
        f"without a build; {n_batches} batches of {bsz}: recall@10 {recall_h:.4f} (ef {ef}, >= {trips} trips, "
        f"{trips_walk:.2f} trips a walk), {ms_h:.3f} ms a batch",
        flush=True,
    )
    filt_h = check_filtered(searcher)
    check_dedup(searcher, "hnsw")
    # the same files on the CPU: the same batch of 64, recall and scores
    cpu = VectorSearcher(cfg_h, open_index, device="cpu")
    cpu_hits = cpu.search(VectorSearchRequest(vectors=q_np[: cfg["cpu_batch"]], top_k=TOP_K))
    card_rows = hits[: cfg["cpu_batch"]]
    cpu_gap = abs(ann_recall(cpu_hits, oracle) - ann_recall(card_rows, oracle))
    check(cpu_gap <= 0.005, f"hnsw: the CPU's recall differs from the card's by {cpu_gap}")
    score_gap = max(
        (abs(a.score - b.score) for ra, rb in zip(card_rows, cpu_hits) for a in ra for b in rb if a.key == b.key),
        default=0.0,
    )
    check(score_gap <= 1e-4, f"hnsw: scores on shared ids differ by {score_gap} between the card and the CPU")
    out["hnsw"] = {
        "build_s": build_s, "link_s": link.seconds, "open_s": open_s, "recall": recall_h, "ef": ef, "min_trips": trips,
        "trips_per_walk": trips_walk, "ms_per_batch": ms_h,
        "walk_all_s": walk_s, "busy_share": busy_share(lambda: searcher.search(req), ms_h),
        "filtered_recall": filt_h, "cpu_recall_gap": cpu_gap, "cpu_score_gap": score_gap,
    }
    del searcher, cpu, idx

    # ---- two segments of 50k stitched ----------------------------------------
    half = n // 2
    t = time.perf_counter()
    metas = [create_segment(f"{tmp}/hnsw{s}", elems[s * half : (s + 1) * half], cfg_h, device=device) for s in (0, 1)]
    sync()
    build2_s = time.perf_counter() - t
    builds = hnsw.BUILDS["graph"]
    searcher = VectorSearcher(cfg_h, SimpleOpenIndex(segment_list=[(m, Seq(i + 1)) for i, m in enumerate(metas)]),
                              device=device)
    check(hnsw.BUILDS["graph"] == builds and searcher.index.graph.n_segments == 2, "the two graphs were not stitched")
    recall_s = ann_recall(ann_search_all(searcher, q_np, bsz), oracle)
    check(recall_s >= ANN_STITCHED_BAR, f"stitched hnsw recall@10 {recall_s} < {ANN_STITCHED_BAR}")
    out["stitched"] = {"build_s": build2_s, "recall": recall_s, "ms_per_batch": median_ms(lambda: searcher.search(req))[0]}
    del searcher
    print(
        f"ann hnsw: filtered recall {json.dumps(filt_h)} (30 % walks, 5 % scans), one copy of planted duplicates; "
        f"the CPU over the same files: recall gap {cpu_gap:.4f}, score gap {score_gap:.2e}; two segments of "
        f"{half} stitched: built in {build2_s:.1f}s, recall@10 {recall_s:.4f}, "
        f"{out['stitched']['ms_per_batch']:.3f} ms a batch; card busy {out['hnsw']['busy_share']} of a batch",
        flush=True,
    )

    # ---- IVF: k-means at create, one assignment pass at open -----------------
    cfg_i = VectorConfig(dimension=d, flags=["ivf"])
    runs = ivf.KMEANS["kmeans"]
    t = time.perf_counter()
    meta = create_segment(f"{tmp}/ivf", elems, cfg_i, device=device)
    sync()
    kmeans_s = time.perf_counter() - t
    check(ivf.KMEANS["kmeans"] == runs + 1 and meta.index_metadata["has_ivf"], "create_segment ran no k-means")
    t = time.perf_counter()
    searcher = VectorSearcher(cfg_i, SimpleOpenIndex(segment_list=[(meta, Seq(1))]), device=device)
    sync()
    open_i = time.perf_counter() - t
    check(ivf.KMEANS["kmeans"] == runs + 1 and searcher.index.ivf is not None, "the searcher ran k-means again")
    ivf.SEARCHES.clear()
    hits = ann_search_all(searcher, q_np, bsz)
    check(ivf.SEARCHES["search"] == n_batches, f"ivf: {dict(ivf.SEARCHES)} probe scans for {n_batches} batches")
    check_batch(hits, n_q, "ivf")
    recall_i = ann_recall(hits, oracle)
    ms_i, _ = median_ms(lambda: searcher.search(req))
    filt_i = {}
    for label, want in (("/l/thirty", oracle30), ("/l/five", oracle5)):
        f_hits = searcher.search(VectorSearchRequest(vectors=q_np[:bsz], top_k=TOP_K, filter=LabelAtom(label)))
        check(all(label in h.labels for row in f_hits for h in row), f"ivf, {label}: an unlabelled row passed")
        filt_i[label] = ann_recall(f_hits, want)
    check_dedup(searcher, "ivf")
    out["ivf"] = {
        "kmeans_create_s": kmeans_s, "open_s": open_i, "clusters": int(searcher.index.ivf.centroids.shape[0]),
        "block": searcher.index.ivf.block, "nprobe": ANN_NPROBE, "recall": recall_i, "ms_per_batch": ms_i,
        "busy_share": busy_share(lambda: searcher.search(req), ms_i), "filtered_recall": filt_i,
    }
    del searcher
    print(
        f"ann ivf: segment with k-means at create in {kmeans_s:.1f}s ({out['ivf']['clusters']} clusters, blocks of "
        f"{out['ivf']['block']}), opened in {open_i:.1f}s without a k-means; recall@10 at nprobe {ANN_NPROBE} "
        f"{recall_i:.4f}, {ms_i:.3f} ms a batch of {bsz}; filtered recall {json.dumps(filt_i)}",
        flush=True,
    )
    del vecs, queries
    if device == "cuda":
        torch.cuda.empty_cache()

    # ---- the node: a shard whose vectorset is flagged hnsw -------------------
    ncfg = cfg["node"]
    corpus = NodeCorpus(torch, ncfg, device)
    R, P = corpus.R, corpus.P

    def oracles(shard):
        cached = getattr(corpus, "_oracles", None)
        if cached is None or cached[0] is not shard:
            cached = corpus._oracles = (shard, KwOracle(shard.paragraph.engine), KwOracle(shard.text.engine))
        return cached[1:]

    corpus.oracles = oracles
    node = EmbeddedNode(f"{tmp}/node", device=device)
    sid = node.create_shard("kb", {"m": VectorConfig(dimension=ncfg["dim"], flags=["hnsw"])}, shard_id="ann0")
    node.configure_shards([{"shard_id": sid, "prewarm_enabled": True}])  # sync opens the searcher
    builds = hnsw.BUILDS["graph"]
    t = time.perf_counter()
    for r in range(R):
        node.index(sid, corpus.resource(r))
    t_index = time.perf_counter() - t
    index_builds = hnsw.BUILDS["graph"] - builds
    t = time.perf_counter()
    while True:
        stats = node.tick_background()
        if stats["jobs_enqueued"] == 0 and stats["merged"] == 0:
            break
    t_merge = time.perf_counter() - t
    merge_builds = hnsw.BUILDS["graph"] - builds - index_builds
    t = time.perf_counter()
    check(node.wait_for_sync() == [sid], "sync did not open the ann shard")
    sync()
    t_sync = time.perf_counter() - t
    # the sync stitches the segments' graphs (up to 8), else builds one
    sync_builds = hnsw.BUILDS["graph"] - builds - index_builds - merge_builds
    check(sync_builds <= 1, f"the sync built {sync_builds} graphs")
    shard = node.searcher.shard(sid)
    graph = shard.vectors["m"].index.graph
    check(graph is not None, "the node's vector index has no graph")
    segments = [s.records for index in node.metadata.get_indexes(sid) if index.kind == "vector"
                for s in node.metadata.ready_segments(index.id)]
    alive_n = torch.ones(corpus.vecs.shape[0], dtype=torch.bool, device=corpus.vecs.device)
    q_dev = torch.from_numpy(corpus.q_np).to(corpus.vecs.device)
    n_oracle = exact_oracle(torch, corpus.vecs, alive_n, q_dev, TOP_K)
    reqs = [node_hybrid(corpus, i) for i in range(ncfg["hybrid"])]
    # the counted path: every request's vector leg walks the graph
    reset_launches(slot_scan, binary_scan)
    hnsw.SEARCHES.clear()
    resps = [node.search(sid, r) for r in reqs]
    node_walks = hnsw.SEARCHES["search"]
    check(node_walks >= len(reqs), f"the node's vector legs walked the graph {node_walks} times for {len(reqs)}")
    check(not slot_scan.LAUNCHES and not binary_scan.LAUNCHES, "the node launched a slot scan")
    for i, (rq, resp) in enumerate(zip(reqs, resps)):
        check(len(resp.vector) == NODE_TOP_K and resp.paragraph is not None, f"ann node, hybrid {i}: a leg is missing")
        node_check_keyword(corpus, shard, rq, resp, f"ann node, hybrid {i}")
    recall_n = node_recall(corpus, [resp.vector for resp in resps], n_oracle)
    out["node"] = {
        "resources": R, "paragraphs": R * P, "index_s": t_index, "merge_s": t_merge, "sync_s": t_sync,
        "graph_builds_indexing": index_builds, "graph_builds_merging": merge_builds, "graph_builds_sync": sync_builds,
        "segments": segments,
        "components": graph.n_segments, "walks": node_walks, "recall": recall_n,
        "hybrid_ms": host_ms(lambda: node.search(sid, reqs[0]), 5),
    }
    print(
        f"ann node: {R} resources x {P} paragraphs on {device}, vectorset flagged hnsw; indexed in {t_index:.1f}s "
        f"({index_builds} graphs), merges {t_merge:.1f}s ({merge_builds} graphs) -> vector segments {segments}, "
        f"sync {t_sync:.1f}s ({graph.n_segments} component(s), {sync_builds} graph built); {len(reqs)} hybrid "
        f"requests: {node_walks} graph "
        f"walks, recall@10 {recall_n:.4f}, BM25 legs equal the oracle; a request {out['node']['hybrid_ms']:.2f} ms",
        flush=True,
    )
    check(recall_n >= ANN_NODE_BAR, f"ann node: vector leg recall@10 {recall_n} < {ANN_NODE_BAR}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"ann numbers: {json.dumps(out)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# multivector MaxSim: a ColBERTv2-shaped late-interaction vectorset
# ---------------------------------------------------------------------------

MULTI_FULL = {
    # ColBERTv2 (Santhanam et al., 2022): 128-d token vectors, queries of 32
    # tokens, passages of up to 180 tokens; dot over normalised rows
    "paragraphs": 50_000,
    "tokens": (32, 180),  # token vectors a paragraph, drawn uniformly
    "dim": 128,
    "batch": 8,
    "query_tokens": 32,
    # the product: a knowledge box with a multivector vectorset
    "kb_resources": 100,
    "kb_paragraphs": 20,
    "kb_tokens": (8, 32),
    "finds": 16,
}
MULTI_DELETED = "m00012/"  # paragraphs 120..129
MULTI_RTOL = 1e-4


def multi_key(i: int) -> str:
    # zero-padded resources sort in generation order: paragraph id == i
    return f"m{i // 10:05d}/f/{i % 10}/0-10"


def multi_id(key: str) -> int:
    parts = key.split("/")
    return int(parts[0][1:]) * 10 + int(parts[2])


def maxsim_oracle(vecs, starts, q, qmask, chunk=2500):
    """float64 MaxSim of every query ([B, M, D], rows where ``qmask``)
    against every paragraph (its vectors ``vecs[starts[p]:starts[p+1]]``),
    on the host: one product a chunk of paragraphs, ``np.maximum.reduceat``
    over each paragraph's columns."""
    b, m, d = q.shape
    q64 = q.reshape(b * m, d).astype(np.float64)
    n = starts.shape[0] - 1
    out = np.empty((b, n))
    for p0 in range(0, n, chunk):
        p1 = min(n, p0 + chunk)
        cols = vecs[starts[p0] : starts[p1]].astype(np.float64)
        para = np.maximum.reduceat(q64 @ cols.T, starts[p0:p1] - starts[p0], axis=1).reshape(b, m, p1 - p0)
        out[:, p0:p1] = np.where(qmask[:, :, None], para, 0.0).sum(axis=1)
    return out


def check_maxsim(hits, oracle, allowed, what) -> None:
    """Each row: top-10 of the ``allowed`` paragraphs up to ties within
    ``MULTI_RTOL`` of its 10th oracle score, every score within
    ``MULTI_RTOL`` of the oracle's, none outside ``allowed``."""
    for r, row in enumerate(hits):
        want = np.where(allowed, oracle[r], -np.inf)
        n = min(TOP_K, int(allowed.sum()))
        check(len(row) == n, f"{what}: query {r} returned {len(row)} hits, not {n}")
        ids = np.array([multi_id(h.key) for h in row])
        check(bool(allowed[ids].all()), f"{what}: query {r} returned a paragraph outside the mask")
        thr = np.sort(want)[::-1][n - 1]
        exact = want[ids]
        check(bool((exact >= thr - MULTI_RTOL * abs(thr)).all()), f"{what}: query {r} is not its top-{TOP_K} up to ties")
        got = np.array([h.score for h in row])
        check(bool(np.allclose(got, exact, rtol=MULTI_RTOL, atol=MULTI_RTOL)),
              f"{what}: query {r} scores differ from the float64 MaxSim by {np.abs(got - exact).max()}")


def multi_corpus(torch, cfg, device):
    """Token counts uniform in ``cfg["tokens"]``, normalised random token
    vectors (made on ``device`` from ``SEED``, kept on the host), paragraphs
    1 and 2 copies of paragraph 0's block, 3 its first vectors but one (a
    different block). Returns (vectors, starts)."""
    rng = np.random.default_rng(SEED)
    n, (lo, hi), d = cfg["paragraphs"], cfg["tokens"], cfg["dim"]
    counts = rng.integers(lo, hi + 1, n)
    counts[1:3] = counts[0]
    counts[3] = counts[0] - 1
    starts = np.concatenate([[0], np.cumsum(counts)])
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    vecs = torch.randn(int(starts[-1]), d, generator=gen, device=device)
    vecs = (vecs / vecs.norm(dim=-1, keepdim=True)).cpu().numpy()
    for p in (1, 2):
        vecs[starts[p] : starts[p + 1]] = vecs[starts[0] : starts[1]]
    vecs[starts[3] : starts[4]] = vecs[starts[0] : starts[1] - 1]
    return vecs, starts


def phase_multi(torch, tmp, cfg, device="cuda"):
    """MULTI cardinality (module docstring, part 11): (a) the index over
    ``cfg["paragraphs"]`` ColBERTv2-shaped paragraphs in two segments plus a
    deletion, searched by batches of MaxSim queries and single vectors,
    held to a float64 MaxSim oracle on the host; (b) a knowledge box with a
    multivector vectorset, ingested through the ``Processor`` and answering
    ``/find`` with a single query vector. Returns its numbers."""
    from nucliadb_tpu_torch.index.vector import (
        Elem, LabelAtom, Seq, SimpleOpenIndex, VectorConfig, VectorSearcher, VectorSearchRequest, create_segment,
    )
    from nucliadb_tpu_torch.ops import binary_scan, slot_scan

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t_phase = time.perf_counter()
    n, d, bsz, m = cfg["paragraphs"], cfg["dim"], cfg["batch"], cfg["query_tokens"]
    t = time.perf_counter()
    vecs, starts = multi_corpus(torch, cfg, device)
    mcfg = VectorConfig(dimension=d, similarity="dot", cardinality="multi")
    segs = []
    for s, (lo, hi) in enumerate(((0, n // 2), (n // 2, n))):
        elems = [Elem(key=multi_key(i), vectors=vecs[starts[i] : starts[i + 1]],
                      labels=["/l/tenth"] if i % 10 == 0 else []) for i in range(lo, hi)]
        segs.append((create_segment(f"{tmp}/mv{s}", elems, mcfg, device=device), Seq(s + 1)))
        del elems
    oi = SimpleOpenIndex(segment_list=segs, deletion_list=[(MULTI_DELETED, Seq(3))])
    t_write = time.perf_counter() - t
    t = time.perf_counter()
    searcher = VectorSearcher(mcfg, oi, device=device)
    sync()
    t_open = time.perf_counter() - t
    idx = searcher.index
    arena_bytes = idx.vectors.numel() * idx.vectors.element_size()
    check(idx.multi and idx.codes is None and idx.vectors.device.type == device,
          f"the MULTI index is not a device slot arena ({idx.vectors.device})")
    check(idx.keys[:3] == [multi_key(0), multi_key(1), multi_key(2)], "paragraphs out of generation order")

    # queries: query j is paragraph pick[j]'s first tokens plus noise; the
    # single vectors are each query's first token
    rng = np.random.default_rng(SEED + 1)
    pick = np.concatenate([[0], rng.choice(np.arange(200, n), bsz - 1, replace=False)])
    noise = 0.3 / np.sqrt(d) * rng.standard_normal((bsz, m, d))  # norm 0.3 a token
    q = np.stack([vecs[starts[p] : starts[p] + m] for p in pick]) + noise
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    q[-1, -2:] = 0.0  # the last query has two padding rows
    single = np.ascontiguousarray(q[:, 0])
    alive = np.ones(n, bool)
    alive[120:130] = False
    kept = alive.copy()
    kept[1:3] = False  # the dedup keeps 0, the first of the planted block
    tenth = kept & (np.arange(n) % 10 == 0)
    t = time.perf_counter()
    oracle = maxsim_oracle(vecs, starts, q, np.abs(q).sum(-1) > 0)
    oracle1 = maxsim_oracle(vecs, starts, single[:, None, :], np.ones((bsz, 1), bool))
    t_oracle = time.perf_counter() - t

    # ---- the main path, counted -----------------------------------------
    reset_launches(slot_scan, binary_scan)
    batch_hits = searcher.search(VectorSearchRequest(vectors=q, top_k=TOP_K))
    single_hits = searcher.search(VectorSearchRequest(vectors=single, top_k=TOP_K))
    filt_hits = searcher.search(VectorSearchRequest(vectors=q, top_k=TOP_K, filter=LabelAtom("/l/tenth")))
    dup_hits = searcher.search(VectorSearchRequest(vectors=q[:1], top_k=TOP_K, with_duplicates=True))
    floor = float(np.float32(batch_hits[1][4].score))
    floor_hits = searcher.search(VectorSearchRequest(vectors=q, top_k=TOP_K, min_score=floor))
    launches = dict(slot_scan.LAUNCHES, **binary_scan.LAUNCHES)
    # ----------------------------------------------------------------------
    check(not any(launches.values()), f"MaxSim launched a slot scan: {launches}")
    check_maxsim(batch_hits, oracle, kept, "MaxSim batch")
    check_maxsim(single_hits, oracle1, kept, "MaxSim single vectors")
    check_maxsim(filt_hits, oracle, tenth, "MaxSim filtered")
    check({0, 1, 2} <= {multi_id(h.key) for h in dup_hits[0]}, "with_duplicates=True lost a copy of paragraph 0")
    check(multi_id(batch_hits[0][0].key) == 0 and not {1, 2} & {multi_id(h.key) for h in batch_hits[0]},
          "the dedup did not keep paragraph 0 alone of its block")
    for got, full in zip(floor_hits, batch_hits):
        check([h.key for h in got] == [h.key for h in full if h.score >= floor], "min_score: not the floored result")
    check(not any(h.key.startswith(MULTI_DELETED) for hs in (batch_hits, single_hits, filt_hits, dup_hits)
                  for row in hs for h in row), "a deleted paragraph came back")

    def batch():
        return searcher.search(VectorSearchRequest(vectors=q, top_k=TOP_K))

    ms, times = median_ms(batch)
    ms1, _ = median_ms(lambda: searcher.search(VectorSearchRequest(vectors=single[0], top_k=TOP_K)))
    peak, busy = None, None
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        batch()
        peak = torch.cuda.max_memory_allocated()
        busy = device_busy_ms(torch, batch)
    out = {"open_s": t_open, "write_s": t_write, "oracle_s": t_oracle, "p_pad": idx.p_pad, "m_max": idx.m_max,
           "vectors": int(starts[-1]), "arena_bytes": arena_bytes, "batch_ms": ms, "single_ms": ms1,
           "busy_ms": busy, "peak_bytes": peak}
    print(
        f"multi index: {n} paragraphs x {cfg['tokens'][0]}-{cfg['tokens'][1]} tokens ({int(starts[-1])} vectors) "
        f"x {d} on {device}, 2 segments + 1 deletion, p_pad {idx.p_pad}, m_max {idx.m_max}, arena {arena_bytes} B; "
        f"write {t_write:.1f}s, open {t_open:.1f}s, float64 oracle {t_oracle:.1f}s; batch {bsz} x {m} top-{TOP_K} "
        f"{ms:.2f} ms (median of 5: {', '.join(f'{t:.2f}' for t in times)}), one single vector {ms1:.2f} ms; "
        f"card busy {busy if busy is None else round(busy, 3)} ms a batch "
        f"({None if busy is None else round(busy / ms, 3)} of it); peak {peak} B "
        f"(arena resident {None if peak is None else base}); launches {launches}; every result the float64 "
        f"MaxSim's up to ties within {MULTI_RTOL}",
        flush=True,
    )
    out["breakdown"] = multi_breakdown(torch, idx, q, device)
    del searcher, idx
    out["find"] = multi_find(torch, tmp, cfg, device)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"multi numbers: {json.dumps(out)}", flush=True)
    return out


F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (TF32 is off)


def multi_breakdown(torch, idx, q, device) -> dict:
    """MaxSim's layers at one batch (CUDA events, mean of 3 after a warm-up):
    ``product`` the [B*M, D] x [P*m_max, D] f32 product, ``slot_mask`` the
    in-place NEG_INF fill of the slots past ``m_count``, ``slot_max`` the
    max over each paragraph's slots, ``whole`` and ``whole_dedup``
    ``_maxsim_core`` without and with the dedup; ``bound_ms`` the larger of
    the product's operations over the f32 peak and the arena's bytes over
    HBM."""
    from nucliadb_tpu_torch.index.vector import device as dv
    from nucliadb_tpu_torch.ops.distance import scores_matmul
    from nucliadb_tpu_torch.ops.topk import NEG_INF

    b, m, d = q.shape
    qt = torch.from_numpy(q).to(device)
    flat_q = qt.reshape(b * m, d)
    qmask = torch.from_numpy(np.abs(q).sum(-1) > 0).to(device)
    mask = torch.from_numpy(idx.base_mask()).to(device)
    floor = float(np.float32(NEG_INF))
    timer = cuda_ms if device == "cuda" else host_ms
    out = {"product": timer(lambda: scores_matmul(flat_q, idx.vectors), 3)}
    slots = scores_matmul(flat_q, idx.vectors).view(b, m, idx.p_pad, idx.m_max)
    invalid = ~(torch.arange(idx.m_max, device=slots.device) < idx.m_count[:, None])
    out["slot_mask"] = timer(lambda: slots.masked_fill_(invalid, NEG_INF), 3)
    out["slot_max"] = timer(lambda: slots.amax(dim=-1), 3)
    del slots
    for name, dedup in (("whole", False), ("whole_dedup", True)):
        out[name] = timer(lambda: dv._maxsim_core(idx.vectors, idx.m_count, qt, qmask, mask, floor, TOP_K,
                                                  idx.m_max, "dot", dedup), 3)
    ops = 2.0 * b * m * idx.vectors.shape[0] * d
    out["bound_ms"] = max(ops / F32_OPS_PER_S, idx.vectors.numel() * idx.vectors.element_size() / HBM_BYTES_PER_S) * 1e3
    print(f"breakdown multi (ms, batch {b} x {m}): {json.dumps({k: round(v, 3) for k, v in out.items()})}",
          flush=True)
    return out


def multi_find(torch, tmp, cfg, device):
    """A knowledge box whose vectorset ``mv`` is multivector: ``kb_resources``
    resources of ``kb_paragraphs`` paragraphs, each with ``kb_tokens``
    sentence embeddings, through ``Processor.create_resource``; merge
    rounds, sync; ``finds`` semantic /find requests with one query vector,
    each semantic hit's score the float64 MaxSim (M = 1) of its paragraph
    and the leg its top-10 up to ties."""
    from nucliadb_tpu_torch.common.kb import KnowledgeBoxManager
    from nucliadb_tpu_torch.ingest import Processor
    from nucliadb_tpu_torch.maindb import Driver
    from nucliadb_tpu_torch.models.api import (
        CreateResourcePayload, FindRequest, KnowledgeBoxConfig, SearchFeature, SentenceEmbedding, TextFieldPayload,
        VectorSetSpec,
    )
    from nucliadb_tpu_torch.search import SearchService
    from nucliadb_tpu_torch.services import EmbeddedNode

    rng = np.random.default_rng(SEED + 2)
    d, R, P, (lo, hi) = cfg["dim"], cfg["kb_resources"], cfg["kb_paragraphs"], cfg["kb_tokens"]
    driver = Driver(f"{tmp}/maindb.db")
    node = EmbeddedNode(f"{tmp}/node", device=device)
    kbs = KnowledgeBoxManager(driver, node)
    processor = Processor(driver, node, kbs)
    search = SearchService(node, kbs, processor)
    kbid = kbs.create(KnowledgeBoxConfig(slug="colbert", vectorsets={"mv": VectorSetSpec(dimension=d, multivector=True)}))
    blocks = {}  # (rid, start, end) -> the paragraph's token vectors
    t = time.perf_counter()
    for r in range(R):
        rid = f"{r:032x}"
        texts = [f"resource {r} paragraph {j}" + " late interaction" * int(rng.integers(1, 4)) for j in range(P)]
        embeddings, start = [], 0
        for text in texts:
            end = start + len(text)
            v = rng.standard_normal((int(rng.integers(lo, hi + 1)), d)).astype(np.float32)
            v /= np.linalg.norm(v, axis=-1, keepdims=True)
            blocks[(rid, start, end)] = v
            embeddings += [SentenceEmbedding(start=start, end=end, vector=row.tolist()) for row in v]
            start = end + 2
        payload = CreateResourcePayload(title=f"colbert {r}", texts={"text1": TextFieldPayload(body="\n\n".join(texts))},
                                        embeddings={"mv": {"text1": embeddings}})
        processor.create_resource(kbid, payload, rid=rid)
    t_ingest = time.perf_counter() - t
    t, rounds = time.perf_counter(), 0
    while True:
        stats = node.tick_background()
        rounds += 1
        if stats["jobs_enqueued"] == 0 and stats["merged"] == 0:
            break
    t_merge = time.perf_counter() - t
    (sid,) = kbs.get_shards(kbid).shards
    node.wait_for_sync()
    index = node.searcher.shard(sid).vectors["mv"].index
    check(index.multi and index.n_para == R * P, f"the knowledge box's MULTI index holds {index.n_para} paragraphs")
    keys = list(blocks)
    cols = np.concatenate([blocks[k] for k in keys])
    starts = np.concatenate([[0], np.cumsum([blocks[k].shape[0] for k in keys])])
    queries = rng.standard_normal((cfg["finds"], d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=-1, keepdims=True)
    oracle = maxsim_oracle(cols, starts, queries[:, None, :], np.ones((cfg["finds"], 1), bool))
    position = {k: i for i, k in enumerate(keys)}
    seen = find_capture(node)
    times = []
    for i, qv in enumerate(queries):
        req = FindRequest(query="", vector=qv.tolist(), vectorset="mv", features=[SearchFeature.SEMANTIC], top_k=TOP_K)
        t = time.perf_counter()
        res = search.find(kbid, req)
        times.append((time.perf_counter() - t) * 1e3)
        (resp,) = seen[-1]
        hits = resp.vector
        check(len(hits) >= TOP_K and res.best_matches, f"/find {i}: {len(hits)} semantic hits")
        ids = []
        for h in hits:  # a MULTI hit's key is its paragraph's: "{rid}/t/text1/{start}-{end}"
            rid, _, _, span = h.key.split("/")
            start, end = map(int, span.split("-"))
            ids.append(position[(rid, start, end)])
        exact = oracle[i, ids]
        thr = np.sort(oracle[i])[::-1][len(ids) - 1]
        check(bool(np.allclose([h.score for h in hits], exact, rtol=MULTI_RTOL, atol=MULTI_RTOL)),
              f"/find {i}: a semantic score is not its paragraph's MaxSim")
        check(bool((exact >= thr - MULTI_RTOL * abs(thr)).all()), f"/find {i}: the semantic leg is not its top-k")
    out = {"resources": R, "paragraphs": R * P, "ingest_s": t_ingest, "merge_s": t_merge, "rounds": rounds,
           "m_max": index.m_max, "find_p50_ms": float(np.median(times))}
    print(
        f"multi find: {R} resources x {P} paragraphs x {lo}-{hi} token vectors (dim {d}) through the Processor on "
        f"{device}: ingest {t_ingest:.1f}s, {rounds} background rounds {t_merge:.1f}s, m_max {index.m_max}; "
        f"{cfg['finds']} semantic /find with one query vector, each hit its paragraph's float64 MaxSim within "
        f"{MULTI_RTOL}, p50 {out['find_p50_ms']:.1f} ms",
        flush=True,
    )
    return out


def child_phase_start(tmp, name: str, call: str, result: str):
    """``chip_smoke.<call>`` in a child interpreter, so that its host-bound
    work overlaps the parent's phase (the two share nothing: each has its
    own data directory, counts and CUDA context). The child prints
    ``<name> counts: `` and the JSON of ``result`` (an expression of its
    ``out``). Returns the process and the file that keeps its lines."""
    import os
    import sys

    log = open(f"{tmp}/{name}_phase.log", "w+")
    code = (
        "import json, torch, chip_smoke\n"
        f"out = chip_smoke.{call}\n"
        f"print('{name} counts: ' + json.dumps({result}), flush=True)\n"
    )
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=log, stderr=subprocess.STDOUT)
    return proc, log


def child_phase_wait(proc, log, name: str) -> dict:
    """Waits for a child phase, prints its lines, and returns its counts."""
    proc.wait()
    log.seek(0)
    text = log.read()
    log.close()
    print(text, end="", flush=True)
    check(proc.returncode == 0, f"the {name} phase failed (exit {proc.returncode})")
    m = re.search(rf"^{name} counts: (.*)$", text, re.M)
    check(m is not None, f"the {name} phase printed no counts")
    return json.loads(m.group(1))


def node_phase_start(tmp):
    """``phase_node`` in a child interpreter beside ``phase_find`` (its
    host-bound indexing and merge rounds overlap the /find phase's)."""
    return child_phase_start(tmp, "node", f"phase_node(torch, {tmp!r}, chip_smoke.NODE_FULL)",
                             "{'default': out.default, 'device': out.device}")


def node_phase_wait(proc, log) -> SimpleNamespace:
    """Waits for the child's ``phase_node``, prints its lines, and returns
    its counts as ``phase_node`` returns them."""
    return SimpleNamespace(**child_phase_wait(proc, log, "node"))


def main() -> None:
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    from nucliadb_tpu_torch.ops import binary_scan, bm25, quant, slot_scan
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
    for src in ("int8_slot_scan", "bm25_program"):
        for line in ptxas_report(kernels, src):
            print(f"ptxas {src}.cu: {line}", flush=True)

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

    seconds = {"kernels": time.perf_counter() - t}  # each phase's wall seconds, for the time limit
    t = time.perf_counter()
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
        torch.cuda.empty_cache()
        paged_launches, paged_bm25 = phase_paged(torch, slot_scan, binary_scan, corpus)
        seconds["slices"], t = time.perf_counter() - t, time.perf_counter()
        mesh_launches, mesh_bm25, mesh_merge, mesh_bm25_err = phase_mesh(torch, slot_scan, corpus, tmp, MESH_FULL)
        corpus.free(torch)
    seconds["mesh"], t = time.perf_counter() - t, time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        keyword = phase_keyword(torch, tmp, KW_FULL)
    seconds["keyword"], t = time.perf_counter() - t, time.perf_counter()
    with (
        tempfile.TemporaryDirectory() as node_tmp,
        tempfile.TemporaryDirectory() as ann_tmp,
        tempfile.TemporaryDirectory() as multi_tmp,
        tempfile.TemporaryDirectory() as tmp,
    ):
        # the node, ANN and multivector phases run beside the /find phase,
        # each in its own interpreter (their lines print after the /find
        # phase's), then the HTTP phase runs alone
        node_proc, node_log = node_phase_start(node_tmp)
        ann_proc, ann_log = child_phase_start(ann_tmp, "ann", f"phase_ann(torch, {ann_tmp!r}, chip_smoke.ANN_FULL)",
                                              "out")
        multi_proc, multi_log = child_phase_start(
            multi_tmp, "multi", f"phase_multi(torch, {multi_tmp!r}, chip_smoke.MULTI_FULL)", "out"
        )
        try:
            find = phase_find(torch, tmp, FIND_FULL)
        except BaseException:
            for proc in (node_proc, ann_proc, multi_proc):
                proc.kill()
                proc.wait()
            raise
        node = node_phase_wait(node_proc, node_log)
        ann = child_phase_wait(ann_proc, ann_log, "ann")
        multi = child_phase_wait(multi_proc, multi_log, "multi")
        seconds["node, ann and multi beside find"], t = time.perf_counter() - t, time.perf_counter()
        http = phase_http(torch, tmp, find, HTTP_FULL)  # over phase_find's knowledge box
        seconds["http"], t = time.perf_counter() - t, time.perf_counter()
        cluster = phase_cluster(torch, tmp, find, CLUSTER_FULL)  # over the same files, in processes of its own
        seconds["cluster"], t = time.perf_counter() - t, time.perf_counter()
        ops = phase_ops(torch, tmp, find, OPS_FULL)  # the CLIs, the SDK with OTLP, the S3-backed node
    seconds["ops"] = time.perf_counter() - t
    seconds["ann (in its child)"] = ann["phase_s"]
    seconds["multi (in its child)"] = multi["phase_s"]
    print(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in seconds.items()})}", flush=True)
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
               # and on the HTTP phase's counted path (both keyword routes)
               "http_launches": http.default.get(mode, 0) + http.device.get(mode, 0),
               # the host_rerank tier's counted path (phase_paged); MaxSim
               # (phase_multi) launches no slot scan
               "paged_launches": paged_launches if mode == "top2" else 0,
               # the mesh vector group's counted path (phase_mesh: 4 members,
               # a batch of 64 and one of 2048)
               "mesh_launches": mesh_launches if mode == "top2" else 0,
               # the answering searcher replica's, on the cluster phase's
               # counted path (its own process, read from its counters)
               "cluster_launches": cluster.launches.get(mode, 0),
               # the ops phase's counted paths: the SDK's /find and the
               # S3-backed node's hybrid requests
               "ops_launches": ops.launches.get(mode, 0),
               "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               # no single PyTorch call computes a slot table
               "library_ms": None, "share": bound_ms / k_ms}
        if src == int8_src:
            row["product_library_ms"] = product_ms  # torch._int_mm at TIMED_SHAPE: the product alone
        rows.append(row)
    # the BM25 program (an XLA program in the JAX package, no Pallas kernel):
    # its numbers at the OR batch of 512 (phase_bm25_kernel prints all three
    # shapes), launches on each phase's counted path (the mesh's: the text
    # group's), the largest |difference| of every comparison
    bm = keyword.kernel["OR 512"]
    rows.append({
        "name": "bm25_program", "route": "cuda", "source": "nucliadb_tpu_torch/csrc/bm25_program.cu",
        "replaces": "nucliadb_tpu/index/text_engine/engine.py:1756", "launches": keyword.launches,
        "node_launches": node.default.get("program", 0) + node.device.get("program", 0),
        "find_launches": find.default.get("program", 0) + find.device.get("program", 0),
        "http_launches": http.default.get("program", 0) + http.device.get("program", 0),
        "paged_launches": paged_bm25, "mesh_launches": mesh_bm25,
        "cluster_launches": cluster.launches.get("program", 0), "ops_launches": ops.launches.get("program", 0),
        "max_abs_err": max([r["max_abs_err"] for r in keyword.kernel.values()] + [mesh_bm25_err, find.kernel_err]),
        "ms": bm["ms"],
        "plain_ms": bm["plain_ms"], "bound_ms": bm["bound_ms"], "bound_by": "bytes",
        # one index_add_ of all of the batch's lanes: the scatter alone
        "library_ms": bm["library_ms"], "share": bm["bound_ms"] / bm["ms"],
        "tile_cols": bm["tile_cols"], "blocks_a_row": bm["blocks_a_row"],
    })
    # its merge of a row's tile cuts (the second launch of a dispatch), at
    # the OR batch of 512 on the kernel's own tile cuts; torch.topk of the
    # tile cuts' scores is the yardstick
    rows.append({
        "name": "bm25_merge", "route": "cuda", "source": "nucliadb_tpu_torch/csrc/bm25_program.cu",
        "replaces": "nucliadb_tpu/index/text_engine/engine.py:1756", "launches": keyword.merge_launches,
        "node_launches": node.default.get("merge", 0) + node.device.get("merge", 0),
        "find_launches": find.default.get("merge", 0) + find.device.get("merge", 0),
        "http_launches": http.default.get("merge", 0) + http.device.get("merge", 0),
        "paged_launches": paged_bm25, "mesh_launches": mesh_merge,
        "cluster_launches": cluster.launches.get("merge", 0), "ops_launches": ops.launches.get("merge", 0),
        "max_abs_err": max(r["merge_max_abs_err"] for r in keyword.kernel.values()),
        "ms": bm["merge_ms"], "plain_ms": bm["merge_plain_ms"], "bound_ms": bm["merge_bound_ms"], "bound_by": "bytes",
        "library_ms": bm["merge_library_ms"], "share": bm["merge_bound_ms"] / bm["merge_ms"],
    })
    unused = [r["name"] for r in rows if not r["launches"] > 0]
    check(not unused, f"kernels of the main path launched no time there: {unused}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
