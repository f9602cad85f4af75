"""Measure Hopper's s8 ``wgmma.mma_async`` as the int8 slot scan issues it.

Three probes, one CTA per SM, operands in shared memory in the scan's
128-byte swizzle, only the products and their issue timed:

- rates: ``m64nNk32`` products for N in {64, 128, 256}, issued by one or
  two warpgroups of a CTA, each product reading distinct tiles as the
  scan's do (a warpgroup's 64 query rows of six 128-byte K-chunks, code
  tiles from a 64 KB ring) of random bytes, with a full drain
  (``wait_group 0``) after every 24 products as the scan has after each
  slot row; printed as a share of the dense int8 peak (1,979 TOP/s);
- contention: m64n64k32 products in one warpgroup while the other runs
  the scan's top-2 epilogue (convert, scale, bias, insert) on registers,
  or idles; printed as the first warpgroup's clocks per product (32 at
  the peak);
- hand-off: two warpgroups pass a turn back and forth with named barriers
  (``bar.arrive`` / ``bar.sync``, as the scan does) or with mbarriers (one
  arrival per warp, ``try_wait`` spin); printed as clocks per hand-off.

Run from the root of a checkout, on the card:

    python3 -m nucliadb_tpu_torch.tools.wgmma_rate

It prints the card's name and power limit, then one JSON line per case.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from ..utils import kernels

PEAK_OPS = 1979e12
CASES = [(n, wgs) for n in (64, 128, 256) for wgs in (1, 2)]  # (product width, warpgroups)
A_BYTES = 6 * 128 * 128  # six K-chunks of 128 query rows
B_BYTES = 64 * 1024
MACS_PER_SM = 64 * 64 * 32 * 4 * 80000  # the same work in every case
CONTEND_ITERS = 60000
HANDOFF_ITERS = 20000


def _wgmma(n: int) -> str:
    regs = n // 2
    outs = ", ".join(f"%{i}" for i in range(regs))
    binds = ", ".join(f'"+r"(d[{i}])' for i in range(regs))
    return f"""
__device__ __forceinline__ void wgmma_s8(int (&d)[{regs}], uint64_t a, uint64_t b) {{
  asm volatile("wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 {{{outs}}}, %{regs}, %{regs + 1}, 1;"
               : {binds} : "l"(a), "l"(b));
}}
"""


def source() -> str:
    body = "".join(_wgmma(n) for n in (64, 128, 256))  # overloads by accumulator count
    launches = "\n".join(f"  if (n == {n}) k = rate<{n}>;" for n in sorted({n for n, _ in CASES}))
    a_bytes, b_bytes = A_BYTES, B_BYTES
    return f"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {{
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}}
// the scan's descriptor: K-major 128-byte rows, 128-byte swizzle, 8-row atoms 1024 bytes apart
__device__ __forceinline__ uint64_t tile_desc(const void* tile) {{
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}}
{body}
// Random bytes in [A tiles | B ring], 1024-byte aligned.
__device__ unsigned char* fill_operands(unsigned char* raw) {{
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  for (int i = threadIdx.x; i < ({a_bytes} + {b_bytes}) / 4; i += blockDim.x) {{
    reinterpret_cast<uint32_t*>(smem)[i] = (i + 1) * 2654435761u;
  }}
  __syncthreads();
  return smem;
}}

// One 128-byte K-chunk (4 products) per iteration; a drain every 6 (24 products).
template <int N>
__device__ __forceinline__ void products(unsigned char* smem, int iters, int wg, int (&acc)[N / 2]) {{
  const int b_tiles = {b_bytes} / (N * 128);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  for (int i = 0; i < iters; ++i) {{
    const uint64_t da = tile_desc(smem + (i % 6) * 16384 + wg * 8192);
    const uint64_t db = tile_desc(smem + {a_bytes} + (i % b_tiles) * N * 128);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_s8(acc, da + 2 * kk, db + 2 * kk);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    if (i % 6 == 5) {{
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    }} else {{
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    }}
  }}
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}}

template <int N>
__global__ void __launch_bounds__(256, 1) rate(int iters, int wgs, int* sink) {{
  extern __shared__ unsigned char raw[];
  unsigned char* smem = fill_operands(raw);
  if (threadIdx.x / 128 >= wgs) return;
  int acc[N / 2];
#pragma unroll
  for (int v = 0; v < N / 2; ++v) acc[v] = 0;
  products<N>(smem, iters, threadIdx.x / 128, acc);
  int s = 0;
#pragma unroll
  for (int v = 0; v < N / 2; ++v) s ^= acc[v];
  if (s == 0x5eed) sink[threadIdx.x] = s;
}}

// Warpgroup 0: m64n64k32 products as above; warpgroup 1 (when alu != 0):
// the scan's top-2 epilogue on register data, for longer.
__global__ void __launch_bounds__(256, 1) contend(int iters, int alu, long long* clocks, float* sink) {{
  extern __shared__ unsigned char raw[];
  unsigned char* smem = fill_operands(raw);
  if (threadIdx.x < 128) {{
    int acc[32];
#pragma unroll
    for (int v = 0; v < 32; ++v) acc[v] = 0;
    const long long t0 = clock64();
    products<64>(smem, iters, 0, acc);
    const long long t1 = clock64();
    int s = 0;
#pragma unroll
    for (int v = 0; v < 32; ++v) s ^= acc[v];
    if (threadIdx.x == 0) clocks[blockIdx.x] = t1 - t0;
    if (s == 0x5eed) sink[threadIdx.x] = s;
  }} else if (alu) {{
    int acc[32];
    float s1[32], s2[32], sc[16], bias[16];
    uint32_t r1[32], r2[32];
#pragma unroll
    for (int v = 0; v < 32; ++v) {{
      acc[v] = threadIdx.x * 7919 + v * 104729;
      s1[v] = s2[v] = -3.0e38f;
      r1[v] = r2[v] = ~0u;
    }}
#pragma unroll
    for (int c = 0; c < 16; ++c) {{
      sc[c] = 1.0f / (c + threadIdx.x);
      bias[c] = (c & 3) ? 0.0f : -3.0e38f;
    }}
    for (uint32_t r = 0; r < 2u * iters; ++r) {{
#pragma unroll
      for (int v = 0; v < 32; ++v) {{
        acc[v] = acc[v] * 1664525 + 1013904223;  // stands for the next row's products
        const int c = 2 * (v >> 2) + (v & 1);
        const float x = __fadd_rn(__fmul_rn(__int2float_rn(acc[v]), sc[c]), bias[c]);
        const bool gt1 = x > s1[v], gt2 = x > s2[v];
        r2[v] = gt1 ? r1[v] : (gt2 ? r : r2[v]);
        s2[v] = gt1 ? s1[v] : (gt2 ? x : s2[v]);
        r1[v] = gt1 ? r : r1[v];
        s1[v] = gt1 ? x : s1[v];
      }}
    }}
    float s = 0.0f;
#pragma unroll
    for (int v = 0; v < 32; ++v) s += s1[v] + s2[v] + r1[v] + r2[v];
    sink[threadIdx.x] = s;
  }}
}}

__device__ __forceinline__ void mbar_wait_parity(uint64_t* bar, uint32_t parity) {{
  uint32_t done = 0;
  do {{
    asm volatile("{{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }}"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }} while (!done);
}}

// Two warpgroups pass a turn back and forth `iters` times.
__global__ void __launch_bounds__(256, 1) handoff(int iters, int use_mbar, long long* clocks) {{
  __shared__ uint64_t bars[2];
  if (threadIdx.x == 0) {{
    for (int i = 0; i < 2; ++i) asm volatile("mbarrier.init.shared::cta.b64 [%0], 4;" ::"r"(smem_u32(&bars[i])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }}
  __syncthreads();
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {{
    const uint32_t parity = i & 1;
    if (use_mbar) {{
      if (wg == 1) mbar_wait_parity(&bars[0], parity);
      if (lane == 0) asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(&bars[wg])) : "memory");
      if (wg == 0) mbar_wait_parity(&bars[1], parity);
    }} else if (wg == 0) {{
      asm volatile("bar.arrive 1, 256;" ::: "memory");
      asm volatile("bar.sync 2, 256;" ::: "memory");
    }} else {{
      asm volatile("bar.sync 1, 256;" ::: "memory");
      asm volatile("bar.arrive 2, 256;" ::: "memory");
    }}
  }}
  const long long t1 = clock64();
  if (threadIdx.x == 0) clocks[blockIdx.x] = t1 - t0;
}}

constexpr int SMEM = 1024 + {a_bytes} + {b_bytes};

extern "C" int run(int n, int iters, int wgs, int blocks, void* sink, void* stream) {{
  void (*k)(int, int, int*) = nullptr;
{launches}
  if (k == nullptr) return -1;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  k<<<blocks, 256, SMEM, static_cast<cudaStream_t>(stream)>>>(iters, wgs, static_cast<int*>(sink));
  return (int)cudaGetLastError();
}}

extern "C" int run_contend(int iters, int alu, int blocks, void* clocks, void* sink, void* stream) {{
  cudaFuncSetAttribute(contend, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  contend<<<blocks, 256, SMEM, static_cast<cudaStream_t>(stream)>>>(iters, alu, static_cast<long long*>(clocks),
                                                                    static_cast<float*>(sink));
  return (int)cudaGetLastError();
}}

extern "C" int run_handoff(int iters, int use_mbar, int blocks, void* clocks, void* stream) {{
  handoff<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(iters, use_mbar, static_cast<long long*>(clocks));
  return (int)cudaGetLastError();
}}
"""


def _build():
    out_dir = kernels.BUILD_DIR / "wgmma_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "wgmma_rate.cu"
    cu.write_text(source())
    lib = out_dir / "libwgmma_rate.so"
    proc = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    so = ctypes.CDLL(str(lib))
    so.run.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    so.run_contend.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    so.run_handoff.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    so.run.restype = so.run_contend.restype = so.run_handoff.restype = ctypes.c_int
    return so


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"wgmma_rate {what} launch failed: {err}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("wgmma_rate: needs an NVIDIA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    so = _build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.zeros(256, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for n, wgs in CASES:
        iters = MACS_PER_SM // (64 * n * 32 * 4 * wgs)
        _check(so.run(n, iters, wgs, sms, sink.data_ptr(), stream), "rate")  # warm-up
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            _check(so.run(n, iters, wgs, sms, sink.data_ptr(), stream), "rate")
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 3
        share = 2 * MACS_PER_SM * sms / (ms * 1e-3) / PEAK_OPS
        print(json.dumps({"n": n, "warpgroups": wgs, "ms": ms, "share_of_peak": share}), flush=True)
    clocks = torch.zeros(sms, dtype=torch.int64, device="cuda")
    fsink = torch.zeros(256, dtype=torch.float32, device="cuda")
    for alu in (0, 1, 0, 1):
        _check(so.run_contend(CONTEND_ITERS, alu, sms, clocks.data_ptr(), fsink.data_ptr(), stream), "contend")
        torch.cuda.synchronize()
        per = clocks.double().mean().item() / (4 * CONTEND_ITERS)
        print(json.dumps({"contend": True, "epilogue_warpgroup": bool(alu), "clocks_per_m64n64k32": per}), flush=True)
    for use_mbar in (0, 1, 0, 1):
        _check(so.run_handoff(HANDOFF_ITERS, use_mbar, sms, clocks.data_ptr(), stream), "handoff")
        torch.cuda.synchronize()
        per = clocks.double().mean().item() / (2 * HANDOFF_ITERS)
        print(json.dumps({"handoff": "mbarrier" if use_mbar else "named barrier", "clocks_per_handoff": per}),
              flush=True)


if __name__ == "__main__":
    main()
