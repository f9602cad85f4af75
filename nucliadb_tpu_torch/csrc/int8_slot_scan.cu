// Top-KEEP-per-slot int8 scan for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces three TPU kernels of nucliadb_tpu/ops/pallas_scan.py:
// - KEEP = 2: _resident2_kernel (wrapper int8_scan_slots_resident2);
// - KEEP = 1: _scan_kernel (int8_scan_slots) and _resident_kernel
//   (int8_scan_slots_resident), which compute the same top-1 table.
// For B int8 queries against N int8 codes:
//   score[b, j] = (f32(i32 dot(q[b], codes[j])) * scale[j]) + bias[j],
//   bias[j] = mask[j] ? 0 : NEG_INF (two roundings, never an FMA),
// column j lands in slot j mod S, and every slot keeps its KEEP best
// (score, id) under "score descending, then id ascending". Output: the top-1
// table [B, S] (followed by the top-2 table [B, S] when KEEP = 2) in each row
// of out_s / out_i ([B, KEEP*S]). _scan_kernel masks with a select instead of
// the bias; both give NEG_INF for a masked column (|raw * scale| is far below
// the last place of FLT_MAX), and NEG_INF never enters a table that starts at
// (NEG_INF, -1) under strict '>', so one kernel serves both.
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
// - Grid (query tile of BT rows, column range, slot group). A column range is
//   a whole number of slot rows. A block has T = min(S, 256) threads; slot
//   group g covers slots [g*T, (g+1)*T), so thread t owns slot g*T + t and
//   column j of the range has that slot when j mod S = g*T + t.
// - Thread t keeps the tile's BT (s1, i1[, s2, i2]) of its slot in registers.
//   It walks its columns in ascending order and inserts with strict '>',
//   which is the Pallas kernels' order.
// - The query tile [BT, D] stays in shared memory; the codes of the T columns
//   under way are staged DC bytes of D at a time, rows padded by 16 bytes so
//   the 16-byte loads of 8 neighbouring threads hit distinct banks.
// - Each (range, slot group) writes its part of a partial table to scratch;
//   slot_table_merge (slot_table.cuh) folds the partials.

#include <stdint.h>

#include "slot_table.cuh"

namespace {

using slot_table::NEG_INF;

constexpr int BT = 16;        // queries per block
constexpr int DC = 64;        // bytes of D staged per step
constexpr int ROW = DC + 16;  // padded shared-memory stride of a code row

template <int KEEP>
__global__ void __launch_bounds__(slot_table::MAX_THREADS, 2) slot_scan_partial(
    const int8_t* __restrict__ q, const int8_t* __restrict__ codes,
    const float* __restrict__ scale, const uint8_t* __restrict__ mask,
    float* __restrict__ part_s, int* __restrict__ part_i,
    int B, int N, int D, int S, int n_range) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* q_s = reinterpret_cast<int8_t*>(smem);           // [BT][D]
  int8_t* c_s = reinterpret_cast<int8_t*>(smem + BT * D);  // [T][ROW]

  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int slot = blockIdx.z * T + t;
  const int b0 = blockIdx.x * BT;
  const int range = blockIdx.y;
  const int n0 = range * n_range;
  const int n1 = min(N, n0 + n_range);

  // query tile, zero rows past B (their results are never written)
  const int q_vecs = BT * D / 16;
  for (int v = t; v < q_vecs; v += T) {
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
    s1[b] = NEG_INF; i1[b] = -1;
    if (KEEP == 2) { s2[b] = NEG_INF; i2[b] = -1; }
  }

  constexpr int VEC_PER_ROW = DC / 16;
  for (int c0 = n0; c0 < n1; c0 += S) {
    const int g0 = c0 + blockIdx.z * T;  // first column of this slot group
    int acc[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[b] = 0;

    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();  // previous chunk consumed (first pass: q_s written)
      for (int v = t; v < T * VEC_PER_ROW; v += T) {
        const int row = v / VEC_PER_ROW;
        const int part = v % VEC_PER_ROW;
        *reinterpret_cast<int4*>(c_s + row * ROW + part * 16) =
            *reinterpret_cast<const int4*>(codes + (size_t)(g0 + row) * D + d0 + part * 16);
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

    const int j = g0 + t;
    const float sc = scale[j];
    const float bias = mask[j] ? 0.0f : NEG_INF;
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const float x = __fadd_rn(__fmul_rn(__int2float_rn(acc[b]), sc), bias);
      if (x > s1[b]) {
        if (KEEP == 2) { s2[b] = s1[b]; i2[b] = i1[b]; }
        s1[b] = x; i1[b] = j;
      } else if (KEEP == 2 && x > s2[b]) {
        s2[b] = x; i2[b] = j;
      }
    }
  }

#pragma unroll
  for (int b = 0; b < BT; ++b) {
    if (b0 + b < B) {
      const size_t o = ((size_t)range * B + b0 + b) * KEEP * S + slot;
      part_s[o] = s1[b];
      part_i[o] = i1[b];
      if (KEEP == 2) {
        part_s[o + S] = s2[b];
        part_i[o + S] = i2[b];
      }
    }
  }
}

template <int KEEP>
int launch(const void* q, const void* codes, const void* scale, const void* mask,
           void* part_s, void* part_i, void* out_s, void* out_i,
           int B, int N, int D, int S, int n_range, cudaStream_t st) {
  const int n_ranges = (N + n_range - 1) / n_range;
  const int threads = S < slot_table::MAX_THREADS ? S : slot_table::MAX_THREADS;
  const size_t smem = (size_t)BT * D + (size_t)threads * ROW;
  cudaError_t err = cudaFuncSetAttribute(
      slot_scan_partial<KEEP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + BT - 1) / BT, n_ranges, S / threads);
  slot_scan_partial<KEEP><<<grid, threads, smem, st>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(codes),
      static_cast<const float*>(scale), static_cast<const uint8_t*>(mask),
      static_cast<float*>(part_s), static_cast<int*>(part_i),
      B, N, D, S, n_range);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return slot_table::launch_merge<KEEP>(part_s, part_i, out_s, out_i, B, S, n_ranges, st);
}

}  // namespace

// Launches both kernels on `stream` and returns cudaGetLastError() (0 = ok),
// or -1 for a keep other than 1 or 2. The caller guarantees: contiguous,
// 16-byte aligned buffers; N % S == 0; D % 64 == 0; S a multiple of 32 in
// [32, 256], or a multiple of 256 up to 1024; n_range a multiple of S;
// part_* hold ceil(N / n_range) * B * keep*S entries, out_* B * keep*S.
extern "C" int int8_slot_scan(
    const void* q, const void* codes, const void* scale, const void* mask,
    void* part_s, void* part_i, void* out_s, void* out_i,
    int B, int N, int D, int S, int n_range, int keep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (keep == 1) {
    return launch<1>(q, codes, scale, mask, part_s, part_i, out_s, out_i, B, N, D, S, n_range, st);
  }
  if (keep == 2) {
    return launch<2>(q, codes, scale, mask, part_s, part_i, out_s, out_i, B, N, D, S, n_range, st);
  }
  return -1;
}
