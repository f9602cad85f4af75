"""Time design variants of the int8 slot-scan kernel on one card.

Each variant is ``csrc/int8_slot_scan.cu`` with one text substitution,
built with the port's nvcc flags into ``build/kernels/variants/`` and
launched through the same C entry as ``ops/slot_scan.py``. They answer
where the kernel's time goes at the timed shapes (B=2048, N=1,048,576,
D=768; top-2 at S=256, top-1 at S=1024):

- ``base``: the kernel as it is;
- ``one_chunk_per_stage``: the resident ring with one 128-byte K-chunk per
  stage (one full/empty barrier round per chunk) instead of up to a slot
  row;
- ``branchy_insert``: the top-KEEP insert as if / else-if branches;
- ``no_turns``: the two consumers issue their products without turns;
- ``no_code_fetch``: the producer loads no code tiles (the products run on
  stale shared memory: wrong tables, the time without the code traffic);
- ``no_insert``: the epilogue folds each accumulator into one register
  with an XOR instead of the insert (wrong tables, the time of the
  products and the data path);
- ``cluster_multicast``: CTAs in clusters of 2 (two query tiles) each load
  half of every code tile and multicast it to both;
- ``turn_after_products``: a consumer passes the turn once its products are
  done, not once they are issued;
- ``turn_before_last_chunk``: a consumer commits its products chunk by
  chunk and passes the turn once all but the last chunk are done;
- ``no_convert``: the epilogue reads the accumulator's bits as a float
  instead of converting it (``I2F``, 16 a clock on an SM; wrong tables,
  the time without the conversion);
- ``no_fetch_no_insert``: ``no_code_fetch`` and ``no_insert`` together
  (the products alone, without the code traffic from L2);
- ``phases``: the kernel with ``clock64`` stamps in each consumer's first
  thread: the clocks of a slot row spent loading scales and waiting for
  the turn, issuing the products (with the waits for full stages), passing
  the turn and waiting for the products, and inserting; printed per
  consumer as clocks per slot row, averaged over the CTAs (the stamps
  cost a little time of their own);
- ``prefetch_scales``: each slot row's scales and mask are loaded into
  registers a row ahead, so their latency hides under the products;
  ``prefetch_phases`` stamps that kernel as ``phases`` does;
- ``turn_at_half``, ``turn_at_two_thirds``, ``turn_at_first_chunk``: a
  consumer passes the turn once it has issued that share of a slot row's
  products (rounded up to whole K-chunks), not once it has issued them all;
- ``packed_rows``: the top-2 table keeps the best and the second row as two
  16-bit halves of one register instead of a register each: three more
  instructions a score, 32 fewer registers (the kernel's first design);
- ``two_chains``: with the query tile resident, a consumer accumulates the
  even and the odd k32 steps of a row in two accumulator sets (two
  independent product chains) and adds them before the insert.

All but the four variants with wrong tables are checked bit for bit
against the plain version first. Run from the root of a checkout, naming
the variants to time (all when none is named; ``base`` always runs):

    python3 -m nucliadb_tpu_torch.tools.slot_scan_variants [variant ...]

It prints the card's name and power limit, each variant's count of ptxas
warnings, then one JSON line per (variant, mode) with the mean ms of two
rounds taken in turns.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from ..ops import slot_scan
from ..utils import kernels

SHAPES = {2: (2048, 1048576, 768, 256), 1: (2048, 1048576, 768, 1024)}  # keep: (B, N, D, S)
INEXACT = ("no_code_fetch", "no_insert", "no_convert", "no_fetch_no_insert")  # wrong tables by design

_INSERT = """        const bool gt1 = x > s1[v];
        if (KEEP == 2) {
          const bool gt2 = x > s2[v];
          r2[v] = gt1 ? r1[v] : (gt2 ? rel : r2[v]);  // a new best demotes the old one
          s2[v] = gt1 ? s1[v] : (gt2 ? x : s2[v]);
        }
        r1[v] = gt1 ? rel : r1[v];
        s1[v] = gt1 ? x : s1[v];"""
_BRANCHY = """        if (x > s1[v]) {
          if (KEEP == 2) {
            s2[v] = s1[v];
            r2[v] = r1[v];
          }
          s1[v] = x;
          r1[v] = rel;
        } else if (KEEP == 2 && x > s2[v]) {
          s2[v] = x;
          r2[v] = rel;
        }"""
# the top-2 rows packed as two 16-bit halves of one register (ranges of at most 65535 slot rows)
_PACKED_ROWS = [
    ("          r2[v] = gt1 ? r1[v] : (gt2 ? rel : r2[v]);  // a new best demotes the old one\n",
     "          const uint32_t demoted = (r1[v] << 16) | rel;\n"
     "          const uint32_t second = (r1[v] & 0xFFFFu) | (rel << 16);\n"
     "          r1[v] = gt1 ? demoted : (gt2 ? second : r1[v]);\n"),
    ("        r1[v] = gt1 ? rel : r1[v];\n        s1[v] = gt1 ? x : s1[v];",
     "        if (KEEP == 1) r1[v] = gt1 ? rel : r1[v];\n        s1[v] = gt1 ? x : s1[v];"),
    ("        part_i[o] = r1[v] == NO_ROW ? -1 : (row0 + (int)r1[v]) * S + slot;\n        if (KEEP == 2) {\n",
     "        if (KEEP == 1) part_i[o] = r1[v] == NO_ROW ? -1 : (row0 + (int)r1[v]) * S + slot;\n        if (KEEP == 2) {\n"
     "          const uint32_t lo = r1[v] & 0xFFFF, hi = r1[v] >> 16;\n"
     "          part_i[o] = lo == 0xFFFF ? -1 : (row0 + (int)lo) * S + slot;\n"
     "          r2[v] = hi == 0xFFFF ? NO_ROW : hi;\n"),
]
_MULTICAST = [
    ("// wgmma descriptor of a K-major tile", """__device__ __forceinline__ void tma_load_multicast(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                                   uint16_t ctas) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1, {%3, %4}], [%2], %5;"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "h"(ctas)
      : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void release_stage(uint64_t* empty) {
  for (uint32_t cta = 0; cta < 2; ++cta) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_u32(empty)), "r"(cta));
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(remote) : "memory");
  }
}
// wgmma descriptor of a K-major tile"""),
    ("__global__ void __launch_bounds__(THREADS, 1) slot_scan_wgmma(",
     "__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1) slot_scan_wgmma("),
    ("mbar_init(&bars->empty[s], 8);", "mbar_init(&bars->empty[s], 16);"),
    ("""  }
  __syncthreads();
""", """  }
  asm volatile("barrier.cluster.arrive.release.aligned;\\nbarrier.cluster.wait.acquire.aligned;" ::: "memory");
"""),
    ("""  const int wg = threadIdx.x / 128;
""", """  const int wg = threadIdx.x / 128;
  const uint32_t rank = cluster_rank();
"""),
    ("""            tma_load(c_s + stage * stage_stride + j * C_TILE, &c_map, &bars->full[stage], (k + j) * BK,
                     r * S + group * W);
          }
          if (++stage == nstage) { stage = 0; phase ^= 1; }
        }
      }
    }""", """            tma_load_multicast(c_s + stage * stage_stride + j * C_TILE + rank * (C_TILE / 2), &c_map,
                               &bars->full[stage], (k + j) * BK, r * S + group * W + rank * (W / 2), 3);
          }
          if (++stage == nstage) { stage = 0; phase ^= 1; }
        }
      }
      for (int i = 0; i < nstage; ++i) {
        mbar_wait(&bars->empty[stage], phase ^ 1);
        if (++stage == nstage) { stage = 0; phase ^= 1; }
      }
    }"""),
    ("mbar_arrive(&bars->empty[s]);", "release_stage(&bars->empty[s]);"),
    ("if (prev >= 0 && lane == 0) mbar_arrive(&bars->empty[prev]);",
     "if (prev >= 0 && lane == 0) release_stage(&bars->empty[prev]);"),
    ("if (lane == 0) mbar_arrive(&bars->empty[prev]);", "if (lane == 0) release_stage(&bars->empty[prev]);"),
    ("!make_map(&c_map, codes, N, D, W)", "!make_map(&c_map, codes, N, D, W / 2)"),
    ("const dim3 grid((B + TILE_B - 1) / TILE_B, n_ranges, S / W);",
     "const dim3 grid(((B + TILE_B - 1) / TILE_B + 1) / 2 * 2, n_ranges, S / W);"),
]


_NO_FETCH = [
    ("mbar_expect_tx(&bars->full[stage], cps * C_TILE);", "mbar_arrive(&bars->full[stage]);"),
    ("            tma_load(c_s + stage * stage_stride + j * C_TILE, &c_map,",
     "            if (!RESIDENT) tma_load(c_s + stage * stage_stride + j * C_TILE, &c_map,"),
]
_NO_INSERT = (
    "const float x = __fadd_rn(__fmul_rn(__int2float_rn(acc[v]), sc[c]), bias[c]);",
    "s1[v] = __int_as_float(__float_as_int(s1[v]) ^ acc[v]); continue; const float x = 0.0f;",
)
_TURN_PASS = """        if (wg == 1) {
          turn_pass<2>();
        } else if (r + 1 < row1) {
          turn_pass<1>();
        }
"""
_TURN_WAIT = """        wgmma_wait<0>();
        fence_acc(acc);
"""
_CHUNK_PRODUCTS = """            for (int kk = 0; kk < BK / 32; ++kk) wgmma_k32(acc, da + 2 * kk, db + 2 * kk, ((k + j) | kk) != 0);
"""
_TWO_CHAINS = [
    ("    int acc[NACC];\n", "    int acc[NACC], acc2[NACC];\n"),
    ("        wgmma_fence();\n        fence_acc(acc);\n        for (int k = 0; k < kc; k += cps) {",
     "        wgmma_fence();\n        fence_acc(acc);\n        fence_acc(acc2);\n        for (int k = 0; k < kc; k += cps) {"),
    (_CHUNK_PRODUCTS, """            for (int kk = 0; kk < BK / 32; kk += 2) {
              wgmma_k32(acc, da + 2 * kk, db + 2 * kk, ((k + j) | kk) != 0);
              wgmma_k32(acc2, da + 2 * kk + 2, db + 2 * kk + 2, ((k + j) | kk) != 0);
            }
"""),
    (_TURN_PASS + _TURN_WAIT, _TURN_PASS + _TURN_WAIT + """        fence_acc(acc2);
#pragma unroll
        for (int v = 0; v < NACC; ++v) acc[v] += acc2[v];
"""),
]


def _substitute(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"variant anchor not found: {old[:60]!r}")
        src = src.replace(old, new)
    return src


_PHASES = [
    ('#include "slot_table.cuh"\n', """#include "slot_table.cuh"

__device__ unsigned long long g_phase[10];  // per consumer: 4 phases' clocks, slot rows
extern "C" int read_phases(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[10] = {0};
    err = cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
  }
  return (int)err;
}
"""),
    ("\n    for (int r = row0; r < row1; ++r) {\n",
     "\n    unsigned long long ph[4] = {0, 0, 0, 0};\n"
     "    for (int r = row0; r < row1; ++r) {\n      long long tp = clock64();\n"),
    ("        const int first = stage;\n",
     "        { long long tq = clock64(); ph[0] += tq - tp; tp = tq; }\n        const int first = stage;\n"),
    (_TURN_PASS + _TURN_WAIT, "        { long long tq = clock64(); ph[1] += tq - tp; tp = tq; }\n" + _TURN_PASS + _TURN_WAIT
     + "        { long long tq = clock64(); ph[2] += tq - tp; tp = tq; }\n"),
    ("        s1[v] = gt1 ? x : s1[v];\n      }\n    }\n",
     "        s1[v] = gt1 ? x : s1[v];\n      }\n      { long long tq = clock64(); ph[3] += tq - tp; }\n    }\n"
     "    if (t == 0) {\n      for (int i = 0; i < 4; ++i) atomicAdd(&g_phase[(wg - 1) * 5 + i], ph[i]);\n"
     "      atomicAdd(&g_phase[(wg - 1) * 5 + 4], (unsigned long long)(row1 - row0));\n    }\n"),
]
_PREFETCH = [("""    for (int r = row0; r < row1; ++r) {
      const size_t jb = static_cast<size_t>(r) * S + col0;
      float sc[NCOL], bias[NCOL];
#pragma unroll
      for (int i = 0; i < W / 8; ++i) {
        const float2 s = __ldg(reinterpret_cast<const float2*>(scale + jb + 8 * i));
        const uchar2 m = __ldg(reinterpret_cast<const uchar2*>(mask + jb + 8 * i));
        sc[2 * i] = s.x;
        sc[2 * i + 1] = s.y;
        bias[2 * i] = m.x ? 0.0f : NEG_INF;
        bias[2 * i + 1] = m.y ? 0.0f : NEG_INF;
      }
""", """    float2 next_s[W / 8];
    uchar2 next_m[W / 8];
#pragma unroll
    for (int i = 0; i < W / 8; ++i) {
      const size_t j = static_cast<size_t>(row0) * S + col0 + 8 * i;
      next_s[i] = __ldg(reinterpret_cast<const float2*>(scale + j));
      next_m[i] = __ldg(reinterpret_cast<const uchar2*>(mask + j));
    }
    for (int r = row0; r < row1; ++r) {
      float sc[NCOL], bias[NCOL];
#pragma unroll
      for (int i = 0; i < W / 8; ++i) {
        sc[2 * i] = next_s[i].x;
        sc[2 * i + 1] = next_s[i].y;
        bias[2 * i] = next_m[i].x ? 0.0f : NEG_INF;
        bias[2 * i + 1] = next_m[i].y ? 0.0f : NEG_INF;
      }
      if (r + 1 < row1) {
#pragma unroll
        for (int i = 0; i < W / 8; ++i) {
          const size_t j = static_cast<size_t>(r + 1) * S + col0 + 8 * i;
          next_s[i] = __ldg(reinterpret_cast<const float2*>(scale + j));
          next_m[i] = __ldg(reinterpret_cast<const uchar2*>(mask + j));
        }
      }
""")]
PHASE_NAMES = ("scales_and_turn_wait", "issue", "pass_and_product_wait", "insert")


def _turn_at(chunks: str) -> list:
    """Pass the turn once the row's first ``chunks`` K-chunks are issued."""
    return [
        (_CHUNK_PRODUCTS + "          }\n",
         _CHUNK_PRODUCTS + f"            if (k + j + 1 == {chunks}) {{\n"
         "              if (wg == 1) {\n                turn_pass<2>();\n              } else if (r + 1 < row1) {\n"
         "                turn_pass<1>();\n              }\n            }\n          }\n"),
        (_TURN_PASS + _TURN_WAIT, _TURN_WAIT),
    ]


def variants(src: str) -> dict[str, str]:
    return {
        "base": src,
        "branchy_insert": _substitute(src, [(_INSERT, _BRANCHY)]),
        "no_turns": _substitute(src, [
            ("if (wg == 1) turn_wait<1>(); else turn_wait<2>();", ";"),
            ("turn_pass<2>();", ";"), ("turn_pass<1>();", ";"),
        ]),
        "no_code_fetch": _substitute(src, _NO_FETCH),
        "one_chunk_per_stage": _substitute(src, [("  if (RESIDENT) {\n    for (int cps = kc;", "  if (false) {\n    for (int cps = kc;")]),
        "no_insert": _substitute(src, [_NO_INSERT]),
        "no_convert": _substitute(src, [("__int2float_rn(acc[v])", "__int_as_float(acc[v])")]),
        "no_fetch_no_insert": _substitute(src, [*_NO_FETCH, _NO_INSERT]),
        "cluster_multicast": _substitute(src, _MULTICAST),
        "turn_after_products": _substitute(src, [(_TURN_PASS + _TURN_WAIT, _TURN_WAIT + _TURN_PASS)]),
        "two_chains": _substitute(src, _TWO_CHAINS),
        "packed_rows": _substitute(src, _PACKED_ROWS),
        "turn_at_half": _substitute(src, _turn_at("(kc + 1) / 2")),
        "turn_at_two_thirds": _substitute(src, _turn_at("(2 * kc + 2) / 3")),
        "turn_at_first_chunk": _substitute(src, _turn_at("1")),
        "phases": _substitute(src, _PHASES),
        "prefetch_scales": _substitute(src, _PREFETCH),
        "prefetch_phases": _substitute(_substitute(src, _PREFETCH), _PHASES),
        "turn_before_last_chunk": _substitute(src, [
            (_CHUNK_PRODUCTS + "          }\n          wgmma_commit();\n",
             _CHUNK_PRODUCTS + "            wgmma_commit();\n          }\n"),
            (_TURN_PASS + "        wgmma_wait<0>();\n", "        wgmma_wait<1>();\n" + _TURN_PASS + "        wgmma_wait<0>();\n"),
        ]),
    }


def _build_all(texts: dict[str, str]) -> dict:
    """Each variant's library, all nvcc builds started together."""
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o", str(out_dir / f"lib{name}.so"),
               str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        spills = sorted({line.strip() for line in log.splitlines() if "spill" in line and " 0 bytes spill stores" not in line})
        warnings = sorted({line.strip() for line in log.splitlines() if "warning" in line})
        print(f"{name}: {len(warnings)} distinct ptxas warnings {warnings or ''}; spilling functions: {spills or 'none'}",
              flush=True)
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        lib.int8_slot_scan.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.int8_slot_scan.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _runner(fn, q, codes, scale, mask, slots, keep):
    b, d = q.shape
    n = codes.shape[0]
    n_range, n_ranges = slot_scan.kernel_tiling(b, n, slots, torch.cuda.get_device_properties(0).multi_processor_count)
    width = keep * slots
    out_s = torch.empty((b, width), device="cuda")
    out_i = torch.empty((b, width), dtype=torch.int32, device="cuda")
    part_s = torch.empty((n_ranges, b, width), device="cuda")
    part_i = torch.empty((n_ranges, b, width), dtype=torch.int32, device="cuda")

    def run():
        err = fn(q.data_ptr(), codes.data_ptr(), scale.data_ptr(), mask.data_ptr(), part_s.data_ptr(),
                 part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), b, n, d, slots, n_range, keep,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return out_s, out_i

    return run


def _ms(run, reps: int = 5) -> float:
    run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("slot_scan_variants: needs an NVIDIA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    texts = variants((kernels.CSRC / "int8_slot_scan.cu").read_text())
    wanted = sys.argv[1:] or list(texts)
    unknown = set(wanted) - set(texts)
    if unknown:
        raise SystemExit(f"slot_scan_variants: unknown variants {sorted(unknown)}")
    libs = _build_all({name: texts[name] for name in texts if name == "base" or name in wanted})
    fns = {name: lib.int8_slot_scan for name, lib in libs.items()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    b, n, d, _ = SHAPES[2]
    codes = torch.randint(-127, 128, (n, d), generator=gen, device="cuda", dtype=torch.int8)
    scale = torch.rand(n, generator=gen, device="cuda") + 0.5
    mask = torch.rand(n, generator=gen, device="cuda") > 0.1
    q = torch.randint(-127, 128, (b, d), generator=gen, device="cuda", dtype=torch.int8)
    for keep, (_, _, _, slots) in SHAPES.items():
        plain = (slot_scan.int8_scan_slots_resident2_reference if keep == 2
                 else slot_scan.int8_scan_slots_top1_reference)(q, codes, scale, mask, slots=slots)
        for name in fns:
            if name in INEXACT:
                continue
            got = _runner(fns[name], q, codes, scale, mask, slots, keep)()
            torch.cuda.synchronize()
            same = torch.equal(got[0].view(torch.int32), plain[0].view(torch.int32)) and torch.equal(got[1], plain[1])
            if not same:
                raise SystemExit(f"slot_scan_variants: {name} (keep={keep}) differs from the plain version")
    times: dict[tuple[str, int], list[float]] = {}
    for _ in range(2):
        for name, fn in fns.items():
            for keep, (_, _, _, slots) in SHAPES.items():
                times.setdefault((name, keep), []).append(_ms(_runner(fn, q, codes, scale, mask, slots, keep)))
    for (name, keep), ms in times.items():
        print(json.dumps({"variant": name, "keep": keep, "shape": SHAPES[keep], "ms": sum(ms) / len(ms),
                          "rounds": ms}), flush=True)
    for name in (n for n in libs if n.endswith("phases")):
        read = libs[name].read_phases
        read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
        buf = (ctypes.c_ulonglong * 10)()
        for keep, (_, _, _, slots) in SHAPES.items():
            run = _runner(fns[name], q, codes, scale, mask, slots, keep)
            torch.cuda.synchronize()
            if read(buf, 1):
                raise RuntimeError("read_phases failed")
            run()
            torch.cuda.synchronize()
            if read(buf, 1):
                raise RuntimeError("read_phases failed")
            for consumer in (0, 1):
                rows = buf[consumer * 5 + 4]
                clocks = {k: buf[consumer * 5 + i] / rows for i, k in enumerate(PHASE_NAMES)}
                print(json.dumps({"phases": name, "keep": keep, "consumer": consumer + 1,
                                  "clocks_per_slot_row": clocks, "slot_rows": rows}), flush=True)


if __name__ == "__main__":
    main()
