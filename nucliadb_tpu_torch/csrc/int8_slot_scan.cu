// Top-2-per-slot int8 scan for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces the TPU kernel nucliadb_tpu/ops/pallas_scan.py:_resident2_kernel
// (wrapper int8_scan_slots_resident2). For B int8 queries against N int8 codes:
//   score[b, j] = (f32(i32 dot(q[b], codes[j])) * scale[j]) + bias[j],
//   bias[j] = mask[j] ? 0 : NEG_INF (two roundings, never an FMA),
// column j lands in slot j mod S, and every slot keeps its two best
// (score, id) under "score descending, then id ascending". Output: the top-1
// table [B, S] followed by the top-2 table [B, S] in each row of
// out_s / out_i ([B, 2S]).
//
// What bounds it on an H100: the int8 multiply-accumulates, B*N*D of them,
// 1.6e12 at B=2048, N=1M, D=768. The codes are 0.8 GB and are read from
// device memory about once (query tiles of one column range run side by side
// and share it through L2), so memory is not the limit. This first design does
// nothing about the MAC bound yet: it runs on __dp4a (4 MACs per instruction on
// the CUDA cores), not on the int8 tensor cores (wgmma / mma.sync), and it does
// not pipeline its loads with TMA. Those are later work.
//
// Design.
// - Grid (query tile of BT rows, column range). A column range is a whole
//   number of slot rows, so column j of the range has slot = threadIdx.x.
// - Block of S threads: thread t owns slot t for the tile's BT queries and keeps
//   their (s1, i1, s2, i2) in registers. It walks its columns in ascending
//   order and inserts with strict '>', which is the Pallas kernel's order.
// - The query tile [BT, D] stays in shared memory; the codes of the S columns
//   under way are staged DC bytes of D at a time, rows padded by 16 bytes so
//   the 16-byte loads of 8 neighbouring threads hit distinct banks.
// - Each range writes a partial table to scratch. slot_scan_merge folds the
//   partials of each (query, slot) with the lexicographic order above; top-2
//   of a union is top-2 of the parts' top-2s, so the table equals a single
//   pass over all columns bit for bit.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int BT = 16;        // queries per block
constexpr int DC = 64;        // bytes of D staged per step
constexpr int ROW = DC + 16;  // padded shared-memory stride of a code row
constexpr float NEG_INF = -FLT_MAX;  // Pallas' NEG_INF (f32 min)

__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

__global__ void __launch_bounds__(256, 2) slot_scan_partial(
    const int8_t* __restrict__ q, const int8_t* __restrict__ codes,
    const float* __restrict__ scale, const uint8_t* __restrict__ mask,
    float* __restrict__ part_s, int* __restrict__ part_i,
    int B, int N, int D, int S, int n_range) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* q_s = reinterpret_cast<int8_t*>(smem);           // [BT][D]
  int8_t* c_s = reinterpret_cast<int8_t*>(smem + BT * D);  // [S][ROW]

  const int t = threadIdx.x;
  const int b0 = blockIdx.x * BT;
  const int range = blockIdx.y;
  const int n0 = range * n_range;
  const int n1 = min(N, n0 + n_range);

  // query tile, zero rows past B (their results are never written)
  const int q_vecs = BT * D / 16;
  for (int v = t; v < q_vecs; v += S) {
    const int b = (v * 16) / D;
    const int off = (v * 16) % D;
    int4 val = make_int4(0, 0, 0, 0);
    if (b0 + b < B) {
      val = *reinterpret_cast<const int4*>(q + (size_t)(b0 + b) * D + off);
    }
    *reinterpret_cast<int4*>(q_s + b * D + off) = val;
  }

  float s1[BT], s2[BT];
  int i1[BT], i2[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    s1[b] = NEG_INF; s2[b] = NEG_INF; i1[b] = -1; i2[b] = -1;
  }

  constexpr int VEC_PER_ROW = DC / 16;
  for (int c0 = n0; c0 < n1; c0 += S) {
    int acc[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[b] = 0;

    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();  // previous chunk consumed (first pass: q_s written)
      for (int v = t; v < S * VEC_PER_ROW; v += S) {
        const int row = v / VEC_PER_ROW;
        const int part = v % VEC_PER_ROW;
        *reinterpret_cast<int4*>(c_s + row * ROW + part * 16) =
            *reinterpret_cast<const int4*>(codes + (size_t)(c0 + row) * D + d0 + part * 16);
      }
      __syncthreads();
#pragma unroll
      for (int w = 0; w < VEC_PER_ROW; ++w) {
        const int4 c = *reinterpret_cast<const int4*>(c_s + t * ROW + w * 16);
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          const int4 qq = *reinterpret_cast<const int4*>(q_s + b * D + d0 + w * 16);
          int a = acc[b];
          a = __dp4a(c.x, qq.x, a);
          a = __dp4a(c.y, qq.y, a);
          a = __dp4a(c.z, qq.z, a);
          a = __dp4a(c.w, qq.w, a);
          acc[b] = a;
        }
      }
    }

    const int j = c0 + t;
    const float sc = scale[j];
    const float bias = mask[j] ? 0.0f : NEG_INF;
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const float x = __fadd_rn(__fmul_rn(__int2float_rn(acc[b]), sc), bias);
      if (x > s1[b]) {
        s2[b] = s1[b]; i2[b] = i1[b]; s1[b] = x; i1[b] = j;
      } else if (x > s2[b]) {
        s2[b] = x; i2[b] = j;
      }
    }
  }

#pragma unroll
  for (int b = 0; b < BT; ++b) {
    if (b0 + b < B) {
      const size_t o = ((size_t)range * B + b0 + b) * 2 * S;
      part_s[o + t] = s1[b];
      part_i[o + t] = i1[b];
      part_s[o + S + t] = s2[b];
      part_i[o + S + t] = i2[b];
    }
  }
}

__global__ void slot_scan_merge(
    const float* __restrict__ part_s, const int* __restrict__ part_i,
    float* __restrict__ out_s, int* __restrict__ out_i,
    int B, int S, int n_ranges) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * S) return;
  const int b = idx / S;
  const int t = idx % S;
  float s1 = NEG_INF, s2 = NEG_INF;
  int i1 = -1, i2 = -1;
  for (int r = 0; r < n_ranges; ++r) {
    const size_t o = ((size_t)r * B + b) * 2 * S + t;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float x = part_s[o + k * S];
      const int j = part_i[o + k * S];
      if (better(x, j, s1, i1)) {
        s2 = s1; i2 = i1; s1 = x; i1 = j;
      } else if (better(x, j, s2, i2)) {
        s2 = x; i2 = j;
      }
    }
  }
  const size_t o = (size_t)b * 2 * S + t;
  out_s[o] = s1;
  out_i[o] = i1;
  out_s[o + S] = s2;
  out_i[o + S] = i2;
}

}  // namespace

// Launches both kernels on `stream` and returns cudaGetLastError() (0 = ok).
// The caller guarantees: contiguous, 16-byte aligned buffers; N % S == 0;
// D % 64 == 0; S a multiple of 32 in [32, 256]; n_range a multiple of S;
// part_* hold ceil(N / n_range) * B * 2S entries.
extern "C" int int8_slot_scan(
    const void* q, const void* codes, const void* scale, const void* mask,
    void* part_s, void* part_i, void* out_s, void* out_i,
    int B, int N, int D, int S, int n_range, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_ranges = (N + n_range - 1) / n_range;
  const size_t smem = (size_t)BT * D + (size_t)S * ROW;
  cudaError_t err = cudaFuncSetAttribute(
      slot_scan_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + BT - 1) / BT, n_ranges);
  slot_scan_partial<<<grid, S, smem, st>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(codes),
      static_cast<const float*>(scale), static_cast<const uint8_t*>(mask),
      static_cast<float*>(part_s), static_cast<int*>(part_i),
      B, N, D, S, n_range);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const int blocks = (B * S + threads - 1) / threads;
  slot_scan_merge<<<blocks, threads, 0, st>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), B, S, n_ranges);
  return (int)cudaGetLastError();
}
