// Top-1-per-slot binary (sign-code) scan for Hopper (sm_90a), CUDA C++ with a
// plain C entry.
//
// Replaces the TPU kernel nucliadb_tpu/ops/pallas_scan.py:_binary_scan_kernel
// (wrapper binary_scan_slots). For B queries, each as 4 bit-planes of W = D/32
// words and 4 scalars, against N sign codes stored transposed (codes_t [W, N]):
//   bd   = sum_p popc(code[:, j] & plane_p) << p
//   dot  = (qmin * popcnt[j]) + (qstep * f32(bd))
//   est  = scale[j] * ((2 * dot) - qsum)
//   opt  = est + 1.9 * sqrt(((resid[j] * qnorm)^2 * (1/D))
//                           + (((2 * scale[j])^2 * D) * qstep^2) * (1/12))
//   score = mask[j] ? opt : NEG_INF
// every operation rounded once with __fmul_rn / __fadd_rn / __fsub_rn /
// __fsqrt_rn (nvcc contracts nothing), in the order of the Pallas body and of
// the plain version (nucliadb_tpu_torch/ops/quant.py:binary_estimates), so the
// table equals the plain version's bit for bit. Column j lands in slot j mod S,
// which keeps its best (score, id) under "score descending, then id ascending".
//
// What bounds it on an H100: the popcounts, B*N*4*W of them (6.4e9 at B=64,
// N=1M, D=768), which run on the CUDA cores at 16 a clock per SM; the codes
// (N*W*4 bytes, 0.1 GB at N=1M, D=768) are read once per query tile of 16.
// This first design uses __popc on 32-bit words and nothing wider; there is
// no tensor-core form of the count in it.
//
// Design.
// - Grid (query tile of BQ rows, column range, slot group), as in
//   int8_slot_scan.cu: a range is a whole number of slot rows, a block has
//   T = min(S, 256) threads and thread t owns slot g*T + t of group g.
// - The tile's planes sit in shared memory as one uint4 per (query, word)
//   (the 4 planes of that word), with the query scalars beside them; all
//   threads of a warp read the same entry, a broadcast.
// - A thread walks its columns in ascending order: it reads the W words of
//   column j (neighbouring threads read neighbouring words of codes_t, so the
//   loads coalesce), accumulates the BQ bit dots in registers, and inserts
//   each query's score with strict '>', the Pallas kernel's order.
// - Each (range, slot group) writes its part of a partial table;
//   slot_table_merge (slot_table.cuh) folds the partials.

#include <stdint.h>

#include "slot_table.cuh"

namespace {

using slot_table::NEG_INF;

constexpr int BQ = 16;     // queries per block
constexpr int PLANES = 4;  // query bit-planes (QUERY_BITS)

__global__ void __launch_bounds__(slot_table::MAX_THREADS, 3) binary_scan_partial(
    const uint32_t* __restrict__ planes,  // [B, PLANES, W]
    const float* __restrict__ qmin, const float* __restrict__ qstep,
    const float* __restrict__ qsum, const float* __restrict__ qnorm,  // [B]
    const uint32_t* __restrict__ codes_t,  // [W, N]
    const float* __restrict__ scale, const float* __restrict__ popcnt,
    const float* __restrict__ resid, const uint8_t* __restrict__ mask,  // [N]
    float* __restrict__ part_s, int* __restrict__ part_i,
    int B, int N, int W, int S, int n_range,
    float dim, float inv_dim, float inv12, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* pl_s = reinterpret_cast<uint4*>(smem);                   // [BQ][W]
  float* qp_s = reinterpret_cast<float*>(smem + (size_t)BQ * W * 16);  // [5][BQ]

  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int slot = blockIdx.z * T + t;
  const int b0 = blockIdx.x * BQ;
  const int range = blockIdx.y;
  const int n0 = range * n_range;
  const int n1 = min(N, n0 + n_range);

  // the tile's planes and scalars; rows past B are zero (never written out)
  for (int v = t; v < BQ * W; v += T) {
    const int b = v / W;
    const int w = v % W;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (b0 + b < B) {
      const uint32_t* src = planes + (size_t)(b0 + b) * PLANES * W + w;
      val = make_uint4(src[0], src[W], src[2 * W], src[3 * W]);
    }
    pl_s[v] = val;
  }
  for (int b = t; b < BQ; b += T) {
    const bool in = b0 + b < B;
    const float st = in ? qstep[b0 + b] : 0.0f;
    qp_s[b] = in ? qmin[b0 + b] : 0.0f;
    qp_s[BQ + b] = st;
    qp_s[2 * BQ + b] = in ? qsum[b0 + b] : 0.0f;
    qp_s[3 * BQ + b] = in ? qnorm[b0 + b] : 0.0f;
    qp_s[4 * BQ + b] = __fmul_rn(st, st);
  }
  __syncthreads();

  float s1[BQ];
  int i1[BQ];
#pragma unroll
  for (int b = 0; b < BQ; ++b) {
    s1[b] = NEG_INF;
    i1[b] = -1;
  }

  for (int c0 = n0; c0 < n1; c0 += S) {
    const int j = c0 + slot;
    int acc[BQ];
#pragma unroll
    for (int b = 0; b < BQ; ++b) acc[b] = 0;

    const uint32_t* col = codes_t + j;
#pragma unroll 4
    for (int w = 0; w < W; ++w) {
      const uint32_t c = __ldg(col + (size_t)w * N);
#pragma unroll
      for (int b = 0; b < BQ; ++b) {
        const uint4 p = pl_s[b * W + w];
        acc[b] += __popc(c & p.x) + (__popc(c & p.y) << 1) +
                  (__popc(c & p.z) << 2) + (__popc(c & p.w) << 3);
      }
    }

    const float pc = popcnt[j];
    const float sc = scale[j];
    const float rs = resid[j];
    const bool eligible = mask[j] != 0;
    const float s2 = __fmul_rn(2.0f, sc);
    const float quant_col = __fmul_rn(__fmul_rn(s2, s2), dim);
#pragma unroll
    for (int b = 0; b < BQ; ++b) {
      const float dot = __fadd_rn(__fmul_rn(qp_s[b], pc),
                                  __fmul_rn(qp_s[BQ + b], __int2float_rn(acc[b])));
      const float est = __fmul_rn(sc, __fsub_rn(__fmul_rn(2.0f, dot), qp_s[2 * BQ + b]));
      const float r = __fmul_rn(rs, qp_s[3 * BQ + b]);
      const float var_resid = __fmul_rn(__fmul_rn(r, r), inv_dim);
      const float var_quant = __fmul_rn(__fmul_rn(quant_col, qp_s[4 * BQ + b]), inv12);
      const float bound = __fmul_rn(eps, __fsqrt_rn(__fadd_rn(var_resid, var_quant)));
      const float x = eligible ? __fadd_rn(est, bound) : NEG_INF;
      if (x > s1[b]) {
        s1[b] = x;
        i1[b] = j;
      }
    }
  }

#pragma unroll
  for (int b = 0; b < BQ; ++b) {
    if (b0 + b < B) {
      const size_t o = ((size_t)range * B + b0 + b) * S + slot;
      part_s[o] = s1[b];
      part_i[o] = i1[b];
    }
  }
}

}  // namespace

// Launches the scan and the merge on `stream` and returns cudaGetLastError()
// (0 = ok). The caller guarantees: contiguous buffers; N % S == 0; W in
// [1, 256]; S a multiple of 32 in [32, 256], or a multiple of 256 up to 1024;
// n_range a multiple of S; part_* hold ceil(N / n_range) * B * S entries.
extern "C" int binary_slot_scan(
    const void* planes, const void* qmin, const void* qstep, const void* qsum,
    const void* qnorm, const void* codes_t, const void* scale, const void* popcnt,
    const void* resid, const void* mask, void* part_s, void* part_i,
    void* out_s, void* out_i,
    int B, int N, int W, int S, int n_range,
    float dim, float inv_dim, float inv12, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_ranges = (N + n_range - 1) / n_range;
  const int threads = S < slot_table::MAX_THREADS ? S : slot_table::MAX_THREADS;
  const size_t smem = (size_t)BQ * W * 16 + 5 * BQ * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      binary_scan_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + BQ - 1) / BQ, n_ranges, S / threads);
  binary_scan_partial<<<grid, threads, smem, st>>>(
      static_cast<const uint32_t*>(planes), static_cast<const float*>(qmin),
      static_cast<const float*>(qstep), static_cast<const float*>(qsum),
      static_cast<const float*>(qnorm), static_cast<const uint32_t*>(codes_t),
      static_cast<const float*>(scale), static_cast<const float*>(popcnt),
      static_cast<const float*>(resid), static_cast<const uint8_t*>(mask),
      static_cast<float*>(part_s), static_cast<int*>(part_i),
      B, N, W, S, n_range, dim, inv_dim, inv12, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return slot_table::launch_merge<1>(part_s, part_i, out_s, out_i, B, S, n_ranges, st);
}
