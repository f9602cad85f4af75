// Top-KEEP-per-slot int8 scan for Hopper (sm_90a) on the int8 tensor cores,
// CUDA C++ with a plain C entry.
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
// What bounds it on an H100: the int8 multiply-accumulates, B*N*D of them.
// At B=2048, N=1,048,576, D=768 that is 1.649e12 MACs = 3.30e12 operations,
// 1.667 ms at the dense int8 peak of 1,979 TOP/s; its bytes (0.82 GB of
// codes, read once) take 0.245 ms at 3.35 TB/s. So the product runs on the
// tensor cores: wgmma.mma_async m64nWk32 s8 x s8 -> s32, which is exact, so
// the tables are bit-identical to the plain version's.
//
// Design.
// - Both operands are K-major as they lie in memory (queries [B, D], codes
//   [N, D], D contiguous), which is what wgmma requires of 8-bit types. TMA
//   loads 128-byte-deep tiles of them with the 128-byte swizzle that the
//   wgmma descriptors name; out-of-range query rows and the tail of a D
//   that is not a multiple of 128 arrive as zeros, which add nothing.
// - A CTA has three warpgroups: one producer, whose one thread keeps a ring
//   of stages in flight under full/empty mbarriers, and two consumers, each
//   owning 64 query rows of the CTA's 128. One CTA per SM (setmaxnreg: 40
//   registers for the producer, 232 for the consumers).
// - The query tile stays in shared memory when D <= 1024 (128 x D bytes,
//   loaded once); above that its K-chunks are streamed beside the codes'.
// - Barrier rounds, not ring depth, are what the ring costs: with the query
//   tile resident a stage holds as many code chunks as keep two slot rows
//   in the ring (stage_chunks), a whole row at D = 768, so one full/empty
//   round covers 24 products. One chunk per stage took 1.4 ms longer for
//   the top-2 mode at the timed shape (PERF.md).
// - The slot table lives beside the accumulator. A CTA owns one slot group
//   [g*W, (g+1)*W) (W = 64, or 32 when S is not a multiple of 64) and walks
//   the slot rows of its column range in ascending order, one m64nWk32
//   product chain per row. Each accumulator register then maps to the same
//   (query, slot) on every row, and the top-KEEP insert is a compare in the
//   same thread's registers, in ascending id order with strict '>': no
//   shuffles, no shared memory, no atomics. Ids are kept as slot rows
//   relative to the range, so a thread holds W/2 accumulators and 4 * W/2
//   (KEEP = 2) or 2 * W/2 (KEEP = 1) table registers; that budget is what
//   keeps W at 64.
// - The insert is what the products wait for: beside it they take about
//   half as long again (66 against 42 clocks an m64n64k32, PERF.md). So it
//   is written with selects (a branch per score diverges within the warp),
//   and the two rows of a top-2 entry take a register each, three fewer
//   instructions a score than two 16-bit halves of one register.
// - Code-tile reuse: every tile in shared memory feeds 128 query rows, and
//   the grid puts the query tiles of one (range, slot group) on blockIdx.x,
//   so the CTAs that stream the same codes run side by side and share them
//   through L2; HBM reads the codes about once. Measured, the code fetch is
//   off the critical path: without its code loads the kernel takes the
//   same time, with or without the insert, and a multicasting cluster
//   more (PERF.md), so the CTAs do not multicast.
// - Epilogue: with the query tile resident, the consumers issue whole slot
//   rows of products in turns (named barriers 1 and 2) and run the insert
//   after passing the turn, so one's insert runs under the other's products
//   and the tensor cores stay busy. Passing the turn earlier or later, or
//   not at all, was slower (PERF.md).
// - Each (range, slot group) writes its part of a partial table to scratch;
//   slot_table_merge (slot_table.cuh) folds the partials.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "slot_table.cuh"

namespace {

using slot_table::NEG_INF;

constexpr int TILE_B = 128;             // query rows per CTA: two consumers of 64
constexpr int BK = 128;                 // bytes of D per chunk: one swizzle row
constexpr int MAX_STAGES = 16;          // ring depth at most
constexpr int SMEM_BUDGET = 200 * 1024; // query tile + ring (the card allows 227 KB)
constexpr int Q_CHUNK = TILE_B * BK;    // 16 KB: one K-chunk of the query tile
constexpr int MAX_RESIDENT_CHUNKS = 8;  // D <= 1024 keeps the query tile resident
// a consumer's turn holds a whole slot row of code chunks in the ring
static_assert((SMEM_BUDGET - MAX_RESIDENT_CHUNKS * Q_CHUNK) / (64 * BK) > MAX_RESIDENT_CHUNKS,
              "a resident slot row must fit the ring");
constexpr int THREADS = 384;            // producer warpgroup + two consumers
constexpr uint32_t NO_ROW = 0xFFFFFFFFu; // "no entry" in a table's row

struct Barriers {
  uint64_t full[MAX_STAGES];
  uint64_t empty[MAX_STAGES];
  uint64_t q_full;
};
// The most dynamic shared memory a launch of any instance takes: the
// alignment slack, the query tile and ring (at most SMEM_BUDGET) and the
// barriers. Every instance's limit is set to it.
constexpr size_t MAX_SMEM = 1024 + SMEM_BUDGET + sizeof(Barriers);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at (c0 = byte of D, c1 = row) of `map` into `dst`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows in the 128-byte
// swizzle (8-row atoms 1024 bytes apart); +2 per 32 bytes of K.
__device__ __forceinline__ uint64_t tile_desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Named barriers 1 and 2 pass the turn to issue products between the two
// consumers (bar.arrive by one warpgroup, bar.sync by the other: 256 threads).
template <int ID>
__device__ __forceinline__ void turn_wait() { asm volatile("bar.sync %0, 256;" ::"n"(ID) : "memory"); }
template <int ID>
__device__ __forceinline__ void turn_pass() { asm volatile("bar.arrive %0, 256;" ::"n"(ID) : "memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
template <int NACC>
__device__ __forceinline__ void fence_acc(int (&d)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A[64 x 32] . B[W x 32]^T, s8 x s8 -> s32; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_k32(int (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_k32(int (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Bytes of one stage of the ring: `cps` code tiles (the query tile
// resident), or one (query chunk, code tile) pair.
template <bool RESIDENT, int W>
int stage_bytes(int cps) {
  return RESIDENT ? cps * W * BK : Q_CHUNK + W * BK;
}

// The ring's depth: as many stages as SMEM_BUDGET holds, up to MAX_STAGES.
template <bool RESIDENT, int W>
int ring_stages(int kc, int cps) {
  const int free = RESIDENT ? SMEM_BUDGET - kc * Q_CHUNK : SMEM_BUDGET;
  const int n = free / stage_bytes<RESIDENT, W>(cps);
  return n < MAX_STAGES ? n : MAX_STAGES;
}

// Code chunks per stage of the resident ring: the most (a divisor of kc)
// that still keep two slot rows in the ring, so a full/empty barrier round
// covers up to a whole row; 1 for the streamed ring.
template <bool RESIDENT, int W>
int stage_chunks(int kc) {
  if (RESIDENT) {
    for (int cps = kc; cps > 1; --cps) {
      if (kc % cps == 0 && ring_stages<true, W>(kc, cps) >= 2 * (kc / cps)) return cps;
    }
  }
  return 1;
}

// Grid (query tile of TILE_B rows, column range, slot group of W slots).
// A range is rows_per_range slot rows of S columns.
template <int KEEP, int W, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1) slot_scan_wgmma(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap c_map,
    const float* __restrict__ scale, const uint8_t* __restrict__ mask,
    float* __restrict__ part_s, int* __restrict__ part_i,
    int B, int N, int D, int S, int rows_per_range, int nstage, int cps) {
  constexpr int C_TILE = W * BK;
  constexpr int NACC = W / 2;  // accumulators per thread of an m64nW product
  constexpr int NCOL = W / 4;  // distinct columns per thread
  const int stage_stride = RESIDENT ? cps * C_TILE : Q_CHUNK + C_TILE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int kc = (D + BK - 1) / BK;
  // resident: [kc query chunks][nstage x cps code tiles]; streamed: nstage x
  // [query chunk, code tile]. Stage s holds its code tiles from c_s + s *
  // stage_stride and, streamed, its query chunk at q_s + s * stage_stride;
  // every tile is 1024-byte aligned.
  unsigned char* q_s = smem;
  unsigned char* c_s = RESIDENT ? smem + kc * Q_CHUNK : smem + Q_CHUNK;
  Barriers* bars = reinterpret_cast<Barriers*>(
      smem + (RESIDENT ? kc * Q_CHUNK : 0) + nstage * stage_stride);

  const int b0 = blockIdx.x * TILE_B;
  const int range = blockIdx.y;
  const int group = blockIdx.z;
  const int row0 = range * rows_per_range;
  const int row1 = min(N / S, row0 + rows_per_range);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < nstage; ++s) {
      mbar_init(&bars->full[s], 1);
      mbar_init(&bars->empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_init(&bars->q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      if (RESIDENT) {
        mbar_expect_tx(&bars->q_full, kc * Q_CHUNK);
        for (int k = 0; k < kc; ++k) tma_load(q_s + k * Q_CHUNK, &q_map, &bars->q_full, k * BK, b0);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int r = row0; r < row1; ++r) {
        for (int k = 0; k < kc; k += cps) {
          mbar_wait(&bars->empty[stage], phase ^ 1);
          if (RESIDENT) {
            mbar_expect_tx(&bars->full[stage], cps * C_TILE);
          } else {
            mbar_expect_tx(&bars->full[stage], Q_CHUNK + C_TILE);
            tma_load(q_s + stage * stage_stride, &q_map, &bars->full[stage], k * BK, b0);
          }
          for (int j = 0; j < cps; ++j) {
            tma_load(c_s + stage * stage_stride + j * C_TILE, &c_map, &bars->full[stage], (k + j) * BK,
                     r * S + group * W);
          }
          if (++stage == nstage) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // consumers: 64 query rows each, products then the slot-table insert
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int t = threadIdx.x - 128 * wg;
    const int warp = t / 32, lane = t % 32;
    const int a_off = (wg - 1) * 64 * BK;  // this consumer's rows within a query chunk
    const int qrow = b0 + (wg - 1) * 64 + warp * 16 + lane / 4;  // and qrow + 8
    const int col0 = group * W + 2 * (lane % 4);                  // + 8 i + e

    // accumulator v: row qrow + 8 * ((v >> 1) & 1), slot col0 + 8 * (v >> 2) + (v & 1)
    int acc[NACC];
    float s1[NACC], s2[KEEP == 2 ? NACC : 1];
    uint32_t r1[NACC], r2[KEEP == 2 ? NACC : 1];  // rows of the best and the second entry
#pragma unroll
    for (int v = 0; v < NACC; ++v) {
      acc[v] = 0;
      s1[v] = NEG_INF;
      r1[v] = NO_ROW;
      if (KEEP == 2) {
        s2[v] = NEG_INF;
        r2[v] = NO_ROW;
      }
    }
    if (RESIDENT) mbar_wait(&bars->q_full, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (int r = row0; r < row1; ++r) {
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

      if (RESIDENT) {
        // The consumers issue whole slot rows in turns, the first one first,
        // and wait for their products only after passing the turn: one's
        // epilogue runs under the other's products. A row's kc / cps stages
        // lie in the ring at once (stage_chunks keeps two rows).
        if (r > row0 || wg == 2) {
          if (wg == 1) turn_wait<1>(); else turn_wait<2>();
        }
        const int first = stage;
        wgmma_fence();
        fence_acc(acc);
        for (int k = 0; k < kc; k += cps) {
          mbar_wait(&bars->full[stage], phase);
          for (int j = 0; j < cps; ++j) {
            const uint64_t da = tile_desc(q_s + (k + j) * Q_CHUNK + a_off);
            const uint64_t db = tile_desc(c_s + stage * stage_stride + j * C_TILE);
#pragma unroll
            for (int kk = 0; kk < BK / 32; ++kk) wgmma_k32(acc, da + 2 * kk, db + 2 * kk, ((k + j) | kk) != 0);
          }
          wgmma_commit();
          if (++stage == nstage) { stage = 0; phase ^= 1; }
        }
        if (wg == 1) {
          turn_pass<2>();
        } else if (r + 1 < row1) {
          turn_pass<1>();
        }
        wgmma_wait<0>();
        fence_acc(acc);
        if (lane == 0) {
          for (int k = 0, s = first; k < kc; k += cps, s = s + 1 == nstage ? 0 : s + 1) mbar_arrive(&bars->empty[s]);
        }
      } else {
        // Streamed: kc may exceed the ring, so the consumers take the
        // chunks side by side, releasing each once its products are done.
        int prev = -1;
        for (int k = 0; k < kc; ++k) {
          mbar_wait(&bars->full[stage], phase);
          const uint64_t da = tile_desc(q_s + stage * stage_stride + a_off);
          const uint64_t db = tile_desc(c_s + stage * stage_stride);
          wgmma_fence();
          fence_acc(acc);
#pragma unroll
          for (int kk = 0; kk < BK / 32; ++kk) wgmma_k32(acc, da + 2 * kk, db + 2 * kk, (k | kk) != 0);
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's products are done: release it
          if (prev >= 0 && lane == 0) mbar_arrive(&bars->empty[prev]);
          prev = stage;
          if (++stage == nstage) { stage = 0; phase ^= 1; }
        }
        wgmma_wait<0>();
        fence_acc(acc);
        if (lane == 0) mbar_arrive(&bars->empty[prev]);
      }

      const uint32_t rel = r - row0;
#pragma unroll
      for (int v = 0; v < NACC; ++v) {
        const int c = 2 * (v >> 2) + (v & 1);
        const float x = __fadd_rn(__fmul_rn(__int2float_rn(acc[v]), sc[c]), bias[c]);
        // selects, not branches: a branch per score diverges within the warp
        const bool gt1 = x > s1[v];
        if (KEEP == 2) {
          const bool gt2 = x > s2[v];
          r2[v] = gt1 ? r1[v] : (gt2 ? rel : r2[v]);  // a new best demotes the old one
          s2[v] = gt1 ? s1[v] : (gt2 ? x : s2[v]);
        }
        r1[v] = gt1 ? rel : r1[v];
        s1[v] = gt1 ? x : s1[v];
      }
    }

#pragma unroll
    for (int v = 0; v < NACC; ++v) {
      const int b = qrow + 8 * ((v >> 1) & 1);
      if (b < B) {
        const int slot = col0 + 8 * (v >> 2) + (v & 1);
        const size_t o = (static_cast<size_t>(range) * B + b) * KEEP * S + slot;
        part_s[o] = s1[v];
        part_i[o] = r1[v] == NO_ROW ? -1 : (row0 + (int)r1[v]) * S + slot;
        if (KEEP == 2) {
          part_s[o + S] = s2[v];
          part_i[o + S] = r2[v] == NO_ROW ? -1 : (row0 + (int)r2[v]) * S + slot;
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded (no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A [rows, cols] int8 row-major tensor, boxes of [box_rows, BK], 128-byte swizzle.
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int ERR_NO_ENCODER = -2;  // the driver's tensor-map encoder is missing or refused

template <int KEEP, int W, bool RESIDENT>
int launch_scan(const void* q, const void* codes, const void* scale, const void* mask, void* part_s,
                void* part_i, int B, int N, int D, int S, int n_range, int n_ranges, cudaStream_t st) {
  CUtensorMap q_map, c_map;
  if (!make_map(&q_map, q, B, D, TILE_B) || !make_map(&c_map, codes, N, D, W)) return ERR_NO_ENCODER;
  const int kc = (D + BK - 1) / BK;
  const int cps = stage_chunks<RESIDENT, W>(kc);
  const int nstage = ring_stages<RESIDENT, W>(kc, cps);
  const size_t smem = 1024 + (RESIDENT ? kc * Q_CHUNK : 0) + nstage * stage_bytes<RESIDENT, W>(cps) + sizeof(Barriers);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = slot_scan_wgmma<KEEP, W, RESIDENT>;
  // one value per instance, whatever this launch's D needs: threads scanning
  // arenas of other widths at once never lower it under another's launch
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + TILE_B - 1) / TILE_B, n_ranges, S / W);
  kernel<<<grid, THREADS, smem, st>>>(q_map, c_map, static_cast<const float*>(scale),
                                      static_cast<const uint8_t*>(mask), static_cast<float*>(part_s),
                                      static_cast<int*>(part_i), B, N, D, S, n_range / S, nstage, cps);
  return (int)cudaGetLastError();
}

template <int KEEP>
int launch(const void* q, const void* codes, const void* scale, const void* mask, void* part_s, void* part_i,
           void* out_s, void* out_i, int B, int N, int D, int S, int n_range, cudaStream_t st) {
  const int n_ranges = (N + n_range - 1) / n_range;
  const bool resident = (D + BK - 1) / BK <= MAX_RESIDENT_CHUNKS;
  int err;
  if (S % 64 == 0) {
    err = resident ? launch_scan<KEEP, 64, true>(q, codes, scale, mask, part_s, part_i, B, N, D, S, n_range, n_ranges, st)
                   : launch_scan<KEEP, 64, false>(q, codes, scale, mask, part_s, part_i, B, N, D, S, n_range, n_ranges, st);
  } else {
    err = resident ? launch_scan<KEEP, 32, true>(q, codes, scale, mask, part_s, part_i, B, N, D, S, n_range, n_ranges, st)
                   : launch_scan<KEEP, 32, false>(q, codes, scale, mask, part_s, part_i, B, N, D, S, n_range, n_ranges, st);
  }
  if (err != 0) return err;
  return slot_table::launch_merge<KEEP>(part_s, part_i, out_s, out_i, B, S, n_ranges, st);
}

}  // namespace

// Launches both kernels on `stream` and returns cudaGetLastError() (0 = ok),
// -1 for a keep other than 1 or 2, or -2 when the driver's tensor-map
// encoder is missing or refuses a map. The caller guarantees: contiguous,
// 16-byte aligned buffers; N % S == 0; D % 64 == 0 and D <= 8192; S a
// multiple of 32 (up to 256 for keep 2, 1024 for keep 1); n_range a multiple
// of S; part_* hold ceil(N / n_range) * B * keep*S entries, out_* B *
// keep*S.
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
