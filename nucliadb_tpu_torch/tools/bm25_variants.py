"""Time the BM25 program kernel on one card, and where a block's time goes.

``csrc/bm25_program.cu`` is built twice with the port's nvcc flags into
``build/kernels/variants/``: as it is (``base``), and with
``-DBM25_STAMPS`` (``phases``: each block's first thread keeps ``clock64``
and ``%globaltimer`` stamps at its phase boundaries: set-up, postings,
dense blocks, epilogue, cut). Each is launched through ``ops/bm25.py``
(the build's library stands in for the kernel's during its launches). The
shapes are the keyword phase's: bench_suite.py config 3 at 1M paragraphs
built by ``chip_smoke.KwCorpus`` (about a minute of host time), its OR
batch of 512, its AND batch of 512 and a single request.

The base kernel is also timed at other tile widths (``tiles``: the
``TILE_COLS`` and ``MIN_TILE_COLS`` of ``ops/bm25.py`` set for the call).
Run from the root of a checkout:

    python3 -m nucliadb_tpu_torch.tools.bm25_variants [tiles]

It prints the card's name and power limit, then one JSON line per
(build, shape) with the mean ms of two rounds taken in turns, and per
shape the clocks a block spends in each phase (mean over the blocks), a
block's ns, the kernel's span and the blocks in flight on average (the sum
of the blocks' ns over the span), on the cut path and in rows mode.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from contextlib import contextmanager

import numpy as np
import torch

from ..ops import bm25
from ..utils import kernels

STAMP_BLOCKS = 65536  # blocks whose stamps the kernel keeps (bm25_program.cu)
_PHASE_NAMES = ("setup", "postings", "dense", "epilogue", "cut")
BUILDS = {"base": (), "phases": ("-DBM25_STAMPS",)}  # each build's defines


def _build_all() -> dict:
    """Each build's library, the nvcc runs started together."""
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, defines in BUILDS.items():
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, *defines, "-o", str(out_dir / f"libbm25_{name}.so"),
               str(kernels.CSRC / "bm25_program.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for build {name}:\n{log}")
        regs = sorted({line.strip() for line in log.splitlines() if "registers" in line})
        print(f"{name}: {regs}", flush=True)
        libs[name] = ctypes.CDLL(str(out_dir / f"libbm25_{name}.so"))
    return libs


@contextmanager
def _library(lib):
    """``lib`` stands in for the kernel's library during the block."""
    saved = kernels._loaded.get("bm25_program")
    kernels._loaded["bm25_program"] = lib
    try:
        yield
    finally:
        if saved is None:
            kernels._loaded.pop("bm25_program", None)
        else:
            kernels._loaded["bm25_program"] = saved


@contextmanager
def _tiles(tile_cols: int, min_tile_cols: int):
    saved = bm25.TILE_COLS, bm25.MIN_TILE_COLS
    bm25.TILE_COLS, bm25.MIN_TILE_COLS = tile_cols, min_tile_cols
    try:
        yield
    finally:
        bm25.TILE_COLS, bm25.MIN_TILE_COLS = saved


def _ms(run, reps: int) -> float:
    run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _shapes(engine, corpus, single_q, top_k):
    dev = engine.device
    out = []
    for name, queries, with_counts in (("OR 512", corpus.or_q, False), ("AND 512", corpus.and_q, True)):
        k, caps, rows, idfs, params = engine.plan_batch(queries)
        out.append((name, k, caps, *(torch.from_numpy(a).to(dev) for a in (rows, idfs, params)), with_counts, True))
    terms, required = engine._plan_terms(single_q)
    rows, idfs, params, caps = engine._device_inputs_planned(terms, required, single_q)
    out.append(("single", top_k, caps, *(torch.from_numpy(a[None]).to(dev) for a in (rows, idfs, params)),
                bool(single_q.all_terms), False))
    return out


def _phases(lib, launch, n_blocks: int) -> dict:
    with _library(lib):
        launch()
        torch.cuda.synchronize()
    stamps = np.zeros(STAMP_BLOCKS * 8, np.uint64)
    err = lib.bm25_stamps(ctypes.c_void_p(stamps.ctypes.data))
    if err:
        raise RuntimeError(f"bm25_stamps: CUDA error {err}")
    st = stamps.reshape(-1, 8)[: min(n_blocks, STAMP_BLOCKS)].astype(np.float64)
    clocks = np.diff(st[:, :6], axis=1)
    ns = st[:, 7] - st[:, 6]
    span = st[:, 7].max() - st[:, 6].min()
    return {"blocks": len(st), **{f"{p}_clocks": float(clocks[:, i].mean()) for i, p in enumerate(_PHASE_NAMES)},
            "block_ns": float(ns.mean()), "span_ns": float(span), "in_flight": float(ns.sum() / span)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bm25_variants: needs an NVIDIA card")
    import chip_smoke  # the checkout's root: the keyword phase's corpus and queries
    from nucliadb_tpu_torch.index.paragraph import ParagraphSearcher
    from nucliadb_tpu_torch.index.text_engine.engine import TextQuery

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    unknown = set(sys.argv[1:]) - {"tiles"}
    if unknown:
        raise SystemExit(f"bm25_variants: unknown arguments {sorted(unknown)}")
    libs = _build_all()
    with tempfile.TemporaryDirectory() as tmp:
        corpus = chip_smoke.KwCorpus(tmp, chip_smoke.KW_FULL)
        engine = ParagraphSearcher(corpus.first, device="cuda").engine
        engine._host_tier_cached = None
        layout = engine.program_layout()
        mask = engine.base_mask_device()
        L = mask.shape[0]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        single_q = TextQuery(text="quick brown fxo", top_k=chip_smoke.KW_TOP_K, fuzzy=True, phrases=["quick brown"])
        shapes = _shapes(engine, corpus, single_q, chip_smoke.KW_TOP_K)
        base_out = {}
        for name, k, caps, rows, idfs, params, with_counts, count_only in shapes:
            with _library(libs["base"]):
                base_out[name] = bm25.run_kernel(layout, caps, mask, rows, idfs, params, k, with_counts, count_only)
        times: dict[tuple[str, str], list[float]] = {}
        for _ in range(2):
            for vname, lib in libs.items():
                for name, k, caps, rows, idfs, params, with_counts, count_only in shapes:
                    reps = 3 if rows.shape[0] > 1 else 20

                    def launch(k=k, caps=caps, rows=rows, idfs=idfs, params=params, wc=with_counts, co=count_only):
                        return bm25.launch_program(layout, caps, mask, rows, idfs, params, wc, co, k)

                    with _library(lib):
                        times.setdefault((vname, name), []).append(_ms(launch, reps))
                        if vname == "base":
                            times.setdefault(("base rows mode", name), []).append(
                                _ms(lambda: launch(k=0), reps))
        for (vname, name), ms in times.items():
            print(json.dumps({"build": vname, "shape": name, "ms": sum(ms) / len(ms), "rounds": ms}), flush=True)
        for name, k, caps, rows, idfs, params, with_counts, count_only in shapes:
            with _library(libs["base"]):
                got = bm25.run_kernel(layout, caps, mask, rows, idfs, params, k, with_counts, count_only)
            same = all(torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                                   w.view(torch.int32) if w.dtype == torch.float32 else w)
                       for g, w in zip(got, base_out[name]))
            print(json.dumps({"shape": name, "deterministic": same}), flush=True)
            n_blocks = rows.shape[0] * bm25.tiling(rows.shape[0], L, sms, layout.dir_cols)[1]
            for mode, kk in (("cut", k), ("rows", 0)):
                ph = _phases(libs["phases"], lambda kk=kk: bm25.launch_program(
                    layout, caps, mask, rows, idfs, params, with_counts, count_only, kk), n_blocks)
                print(json.dumps({"phases": name, "mode": mode, **ph}), flush=True)
        if "tiles" in sys.argv[1:]:
            for tile_cols, min_cols in ((4096, 2048), (16384, 2048), (8192, 4096), (8192, 8192)):
                with _tiles(tile_cols, min_cols), _library(libs["base"]):
                    for name, k, caps, rows, idfs, params, with_counts, count_only in shapes:
                        reps = 3 if rows.shape[0] > 1 else 20
                        ms = _ms(lambda: bm25.launch_program(layout, caps, mask, rows, idfs, params, with_counts,
                                                             count_only, k), reps)
                        tile = bm25.tiling(rows.shape[0], L, sms, layout.dir_cols)[0]
                        print(json.dumps({"tiles": [tile_cols, min_cols], "shape": name, "tile_cols": tile,
                                          "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
