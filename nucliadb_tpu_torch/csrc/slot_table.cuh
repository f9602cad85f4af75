// Slot tables shared by the slot-scan kernels (int8_slot_scan.cu,
// binary_slot_scan.cu).
//
// A slot table keeps, for every (query, slot), the KEEP best (score, id)
// under the total order "score descending, then id ascending", starting from
// the empty entry (NEG_INF, -1). A scan kernel writes one partial table per
// column range, laid out [range][query][k * S + slot] (k < KEEP: the top-1
// table, then the top-2 table). slot_table_merge folds the partials of each
// (query, slot) in that order; the top-KEEP of a union is the top-KEEP of the
// parts' top-KEEPs, so the result equals one sequential pass over all
// columns bit for bit, whatever the tiling.

#pragma once

#include <cuda_runtime.h>
#include <float.h>

namespace slot_table {

constexpr float NEG_INF = -FLT_MAX;  // Pallas' NEG_INF (f32 min)
constexpr int MAX_THREADS = 256;     // threads of a scan block; one slot each

__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

template <int KEEP>
__global__ void slot_table_merge(
    const float* __restrict__ part_s, const int* __restrict__ part_i,
    float* __restrict__ out_s, int* __restrict__ out_i,
    int B, int S, int n_ranges) {
  static_assert(KEEP == 1 || KEEP == 2, "KEEP is 1 or 2");
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * S) return;
  const int b = idx / S;
  const int t = idx % S;
  float s1 = NEG_INF, s2 = NEG_INF;
  int i1 = -1, i2 = -1;
  for (int r = 0; r < n_ranges; ++r) {
    const size_t o = ((size_t)r * B + b) * KEEP * S + t;
#pragma unroll
    for (int k = 0; k < KEEP; ++k) {
      const float x = part_s[o + k * S];
      const int j = part_i[o + k * S];
      if (better(x, j, s1, i1)) {
        s2 = s1; i2 = i1; s1 = x; i1 = j;
      } else if (KEEP == 2 && better(x, j, s2, i2)) {
        s2 = x; i2 = j;
      }
    }
  }
  const size_t o = (size_t)b * KEEP * S + t;
  out_s[o] = s1;
  out_i[o] = i1;
  if (KEEP == 2) {
    out_s[o + S] = s2;
    out_i[o + S] = i2;
  }
}

// Launches the merge of n_ranges partial tables on `st`; returns
// cudaGetLastError() (0 = ok).
template <int KEEP>
int launch_merge(const void* part_s, const void* part_i, void* out_s, void* out_i,
                 int B, int S, int n_ranges, cudaStream_t st) {
  const int threads = 256;
  const int blocks = (B * S + threads - 1) / threads;
  slot_table_merge<KEEP><<<blocks, threads, 0, st>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), B, S, n_ranges);
  return (int)cudaGetLastError();
}

}  // namespace slot_table
