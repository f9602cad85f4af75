// The BM25 program of the keyword leg for Hopper (sm_90a), CUDA C++ with a
// plain C entry.
//
// Replaces the XLA programs of nucliadb_tpu/index/text_engine/engine.py:
// _bm25_groups_core (wrappers _bm25_groups, _bm25_groups_batch) and
// _bm25_search (_bm25_search_batch), the top-k cut's selection included.
// They are jitted XLA code, not Pallas kernels; the port ran them as ~200
// eager torch launches a request (ops/bm25.py's plain version). One launch
// of bm25_program_kernel computes, for Q queries of S slot columns each:
//
// 1. postings: for every posting tier's slots, in the reference's
//    concatenation order (group, tier, slot), the [W] row of docs (i32), tfs
//    and dls (f32) is weighed
//        w = idf * ((tf * (K1 + 1)) / (tf + K1 * ((1 - B) + (B * dl) / avgdl)))
//    and added into the query's score row at doc + offset (one hit into the
//    count row); padding lanes (doc < 0) and empty slots (row < 0) add
//    nothing;
// 2. dense blocks, in table order, over each block's window [start, start +
//    width): kind 1 (a group's dense slots, and the overlay's) sums its slots
//    from 0.0 and adds that sum to the score once; kind 2 (the single arena's
//    base block) adds slot by slot into the score;
// 3. epilogue: matched = (with counts ? count >= max(required, 1) : score > 0)
//    & mask; final = matched & score >= min_score ? score : NEG_INF (the
//    floor that masked_topk would apply, folded in); the matched bitmap, or
//    only its count;
// 4. the cut (when 1 <= k <= KMAX): the k best entries of the block's
//    columns of final, by score descending then column ascending
//    (lax.top_k's order), with each entry's count, padded with (NEG_INF, -1,
//    the count at column 0). bm25_merge_kernel (a second launch) merges a
//    row's tiles' cuts and sums the tiles' match counts.
// Every operation of 1-3 is rounded once with __fmul_rn / __fadd_rn /
// __fdiv_rn (nvcc contracts nothing) in torch's op order, with the f32
// constants torch uses (2.2f, 0.25f, 1.2f, 0.75f), so every output equals the
// plain version's bit for bit on the card.
//
// What bounds it on an H100: the function reads each scheduled lane's doc id
// (and tf and dl where it hits), each dense slot's window and the mask, and
// writes the cuts and the bitmap or match counts: ~0.2 GB at a batch of 512
// OR queries over 1M columns (~0.9 GB for AND, its dense windows), 0.06 to
// 0.3 ms at the HBM rate. The kernel's own costs are latency (finding and
// loading a tile's lanes; three blocks of 256 threads an SM hide little of
// it), the dense windows' IEEE divisions (one a column and one a column
// and slot) and the epilogue's pass over every column of the tile.
//
// Design.
// - Grid (tile, query), tile fastest. A block owns the columns [tile * T,
//   tile * T + T) of one query's row and keeps their scores (f32) and, with
//   counts, their hit counts (u16: a count is at most the number of slots)
//   in shared memory; on the cut path no [Q, L] row goes to device memory.
//   The blocks of one query run together and share its rows, idfs and
//   narrow posting rows through L2.
// - The table (one record a posting tier or dense block, built once per
//   refresh by ops/bm25.py:Layout, its slot columns set a launch) is a
//   __grid_constant__ parameter, read where it lies (a broadcast), in one of
//   three sizes (the smallest that holds the launch's records).
// - Postings, a piece of PIECE slots at a time: a thread per slot finds its
//   record, its row and the row's candidate lanes for the tile: a tier with
//   a lane directory (Layout: the first lane of every DIR_COLS columns of
//   each ascending row) gives the tile's lanes, a narrow tier its whole row.
//   A block scan lays the candidates out flat; each thread then loads
//   UNROLL candidates at once (doc ids; tf and dl with them where the
//   directory already placed the lane in the tile, after the filter
//   elsewhere): one or two round trips a chunk of CHUNK candidates, not one
//   a slot. The adds follow slot order: a slot's lanes hold distinct docs,
//   so they never meet at an address, and __syncthreads() separates the
//   slots that hit the tile.
// - Dense blocks: four columns a thread (one 4-byte load a slot), the next
//   group's loads issued before this group's arithmetic.
// - The epilogue takes four columns a thread (16-byte score, 4-byte mask
//   loads and stores).
// - The cut, for k <= SELECT_K: during the epilogue each warp keeps the best
//   32 of its kept entries in registers, one a lane; an entry that beats the
//   32nd goes to a warp buffer (a ballot, no atomics), and once 32 are
//   buffered they are sorted 32 at a time by a bitonic network in registers
//   and merged in. A tree of bitonic merges then gives the tile's best 32.
//   For a larger k, a radix select over the tile's final scores: the k-th
//   best score (11-bit digits of an order-preserving key), then, where
//   several entries hold that score, the entry that ends the k (lower
//   columns first), a pass that collects the k entries and a rank sort of
//   them. bm25_merge_kernel does the same over a row's tiles' cuts (entry
//   order there is column order among equal scores).
// - Rows mode (k = 0): the tile writes final (and the counts as f32) in one
//   store; ops/topk.py cuts a k past KMAX from those rows.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PIECE = 2 * THREADS;  // posting slots a pass takes: two a thread
constexpr int UNROLL = 8;           // candidate lanes a thread loads at once
constexpr int CHUNK = UNROLL * THREADS;
constexpr float K1P1 = 2.2f;         // K1 + 1, as torch rounds the Python float
constexpr float ONE_MINUS_B = 0.25f;  // 1 - B
constexpr float K1 = 1.2f;
constexpr float BB = 0.75f;
constexpr float NEG_INF = -3.0e38f;  // ops/topk.py:NEG_INF
constexpr float HALF_NEG_INF = NEG_INF * 0.5f;  // masked_topk's test of a real entry
constexpr int KMAX = 1024;  // the largest k of a cut (ops/bm25.py:KMAX)
constexpr int MAX_RECS = 500;  // the largest table (ops/bm25.py:MAX_RECORDS), 32,000 bytes of the 32,764 a launch takes
constexpr int MAX_TILE = 16384;  // columns a block owns at most (ops/bm25.py:MAX_TILE_COLS)
constexpr int MAX_DENSE_SLOTS = 1024;  // slot columns of one dense record (ops/bm25.py:MAX_DENSE_SLOTS)
constexpr int MAX_SLOTS = 65535;  // slot columns of a launch: a count fits u16
constexpr int DIGIT_BITS = 11;
constexpr int BINS = 1 << DIGIT_BITS;
constexpr int SELECT_K = 32;  // a cut of k this small: a bitonic select of each warp's best 32
constexpr int WARP_BUF = 160;  // a warp's buffer: fewer than 32 entries, and the 128 of four columns
// The work area after the tile: the posting piece's arrays (phase B); then
// the dense slots' rows and idfs at 8 KB (phase C); then, for k <= SELECT_K,
// the warps' best 32 at 0 and their buffers at 2 KB (the epilogue, phase
// D), or for a larger k the select's histogram at 0 and the cut's
// candidates at 8 KB (phase D).
constexpr size_t WORK_BYTES = BINS * 4 + KMAX * 8;
static_assert(WARPS * 32 * 8 + WARPS * WARP_BUF * 8 <= WORK_BYTES, "the warps' buffers fit the work area");
constexpr size_t MAX_SMEM = (size_t)MAX_TILE * 6 + WORK_BYTES;  // scores, counts, work (MAX_TILE * 6 is a multiple of 16)

// Phase stamps (a build with -DBM25_STAMPS, tools/bm25_variants): the first
// thread of each of the first STAMP_BLOCKS blocks, in (query, tile) order,
// keeps clock64() at the phase boundaries 0-5 (set-up, postings, dense
// blocks, epilogue, cut, end) and %globaltimer at 0 and 5, read back by
// bm25_stamps(). Without the define a stamp is nothing.
#ifdef BM25_STAMPS
constexpr long long STAMP_BLOCKS = 65536;
__device__ unsigned long long g_stamps[STAMP_BLOCKS * 8];
#define STAMP(j)                                                            \
  if (threadIdx.x == 0) {                                                   \
    const long long sb_ = (long long)blockIdx.y * gridDim.x + blockIdx.x;   \
    if (sb_ < STAMP_BLOCKS) {                                               \
      unsigned long long t_;                                                \
      if ((j) == 0 || (j) == 5) {                                           \
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));              \
        g_stamps[sb_ * 8 + 6 + ((j) == 5)] = t_;                            \
      }                                                                     \
      g_stamps[sb_ * 8 + (j)] = clock64();                                  \
    }                                                                       \
  }
#else
#define STAMP(j) \
  do {           \
  } while (0)
#endif

// One record of the program table, 64 bytes (ops/bm25.py:REC_DTYPE).
struct Rec {
  const void* p0;   // posting: docs i32 [T, W]; dense: tfs u8 [R, width]
  const void* p1;   // posting: tfs f32 [T, W]; dense: dl f32 [width]
  const void* p2;   // posting: dls f32 [T, W]; dense: unused
  const void* dir;  // posting: the lane directory i32 [T, dir_n + 1], or null (read the whole row)
  int start;        // posting: the group's offset added to doc ids; dense: the window's first column
  int kind;         // 0: posting tier; 1: dense block summed, then added; 2: dense block added slot by slot
  int lo, hi;       // the record's slot columns [lo, hi) of rows/idfs
  int n_rows;       // T or R
  int width;        // W or the window's width
  int dir_t0;       // directory entry j counts a row's lanes at columns < (dir_t0 + j) * dir_cols
  int dir_n;        // the directory's last entry (the row's valid lanes)
};
static_assert(sizeof(Rec) == 64, "ops/bm25.py:REC_DTYPE");

// The launch's parameter: the smallest of three sizes that holds its records.
template <int NREC>
struct Table {
  Rec recs[NREC];
};

// Shared memory of a tile's scores (f32) and counts (u16), rounded up to 16
// bytes: the work area follows.
__host__ __device__ __forceinline__ size_t tile_bytes(int tile_cols, bool with_counts) {
  return ((size_t)tile_cols * (with_counts ? 6 : 4) + 15) & ~(size_t)15;
}

__device__ __forceinline__ float bm25_x(float dl, float avgdl) {
  // K1 * ((1 - B) + (B * dl) / avgdl): mul, div, add, mul
  return __fmul_rn(__fadd_rn(__fdiv_rn(__fmul_rn(dl, BB), avgdl), ONE_MINUS_B), K1);
}

__device__ __forceinline__ float bm25_w(float idf, float tf, float x) {
  // idf * ((tf * (K1 + 1)) / (tf + x))
  return __fmul_rn(idf, __fdiv_rn(__fmul_rn(tf, K1P1), __fadd_rn(tf, x)));
}

// A key whose unsigned order is the floats' order (-0.0 and 0.0 tie, as a
// float comparison has them).
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// hist[bin] += 1 for the calling lanes, one shared atomic for each distinct
// bin of a warp (equal scores are common: equal tf and length).
__device__ __forceinline__ void hist_add(unsigned* hist, unsigned bin) {
  const unsigned peers = __match_any_sync(__activemask(), bin);
  if ((threadIdx.x & 31) == (unsigned)(__ffs(peers) - 1)) atomicAdd(&hist[bin], (unsigned)__popc(peers));
}

// Sum over the block, returned to every thread.
__device__ long long block_sum(long long v, long long* s_red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  long long total = 0;
  for (int w = 0; w < WARPS; ++w) total += s_red[w];
  __syncthreads();
  return total;
}

// The exclusive prefix sum of v over the block's threads; *total gets the sum.
__device__ int block_excl_scan(int v, int* s_scan, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) s_scan[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
  for (int w = 0; w < WARPS; ++w) {
    const int t = s_scan[w];
    before += w < warp ? t : 0;
    sum += t;
  }
  __syncthreads();
  *total = sum;
  return before + incl - v;
}

struct CutShared {
  long long red[WARPS];
  unsigned scan[WARPS];
  int bin;
  unsigned before, n;
};

// The bin at which the running count of hist, from the top bin down (or
// from bin 0 up), reaches want (1 <= want <= the total); every thread gets
// it in sh->bin and the count of the bins before it in sh->before. Each
// thread sums PER contiguous bins (two 16-byte loads: no bank conflicts), a
// block scan finds the thread whose bins reach want, and it walks them.
__device__ void find_bin(const unsigned* hist, unsigned want, bool from_top, CutShared* sh) {
  constexpr int PER = BINS / THREADS;
  static_assert(PER == 8, "two uint4 loads a thread");
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int base = from_top ? BINS - PER * (t + 1) : PER * t;  // the lowest of the thread's bins
  const uint4 a = reinterpret_cast<const uint4*>(hist + base)[0];
  const uint4 b = reinterpret_cast<const uint4*>(hist + base)[1];
  const unsigned h[PER] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  unsigned sum = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) sum += h[j];
  unsigned incl = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) sh->scan[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) incl += sh->scan[w];
  unsigned cum = incl - sum;
  if (cum < want && want <= incl) {
#pragma unroll
    for (int jj = 0; jj < PER; ++jj) {
      const int j = from_top ? PER - 1 - jj : jj;  // the search order
      if (cum + h[j] >= want) {
        sh->bin = base + j;
        sh->before = cum;
        break;
      }
      cum += h[j];
    }
  }
  __syncthreads();
}

// The cut of entries [0, n): src.score(i) (an entry is real if above
// HALF_NEG_INF) and src.tie(i), distinct keys below 2^tie_bits whose order
// is the order of equal scores (the lower column first); written as
// out_s[rank], out_i[rank] = src.col(tie), out_c[rank] = src.count(tie),
// padded to k with (NEG_INF, -1, pad_count). kept is the number of real
// entries (every thread); hist (BINS), cand_s and cand_t (KMAX) are shared,
// hist clear on entry and on return.
template <class Src>
__device__ void block_cut(const Src& src, int n, int tie_bits, int k, long long kept, unsigned* hist,
                          float* cand_s, unsigned* cand_t, CutShared* sh, float* out_s, long long* out_i,
                          long long* out_c, long long pad_count) {
  const bool take_all = kept <= k;
  unsigned kth = 0;
  unsigned t_lim = 0xffffffffu;  // entries of key kth with a tie key at or below it are taken
  if (!take_all) {
    unsigned prefix = 0, pmask = 0, want = (unsigned)k;
    for (int hi_bit = 32; hi_bit > 0;) {
      const int shift = hi_bit > DIGIT_BITS ? hi_bit - DIGIT_BITS : 0;
      const unsigned dmask = (1u << (hi_bit - shift)) - 1u;
      for (int i = threadIdx.x; i < n; i += THREADS) {
        const float v = src.score(i);
        if (!(v > HALF_NEG_INF)) continue;
        const unsigned key = order_key(v);
        if ((key & pmask) == prefix) hist_add(hist, (key >> shift) & dmask);
      }
      __syncthreads();
      find_bin(hist, want, true, sh);
      want -= sh->before;
      prefix |= (unsigned)sh->bin << shift;
      pmask |= dmask << shift;
      hi_bit = shift;
      const unsigned n_eq = hist[sh->bin];
      __syncthreads();  // every thread has read the bin before the counts are cleared
      for (int i = threadIdx.x; i < BINS; i += THREADS) hist[i] = 0;
      __syncthreads();
      if (hi_bit == 0 && n_eq > want) {
        // more entries hold the k-th score than the cut keeps: the `want`
        // of them with the lowest tie keys, by a select of the want-th
        unsigned tprefix = 0, tmask = 0;
        for (int tb = tie_bits; tb > 0;) {
          const int ts = tb > DIGIT_BITS ? tb - DIGIT_BITS : 0;
          const unsigned td = (1u << (tb - ts)) - 1u;
          for (int i = threadIdx.x; i < n; i += THREADS) {
            const float v = src.score(i);
            if (!(v > HALF_NEG_INF) || order_key(v) != prefix) continue;
            const unsigned tie = src.tie(i);
            if ((tie & tmask) == tprefix) hist_add(hist, (tie >> ts) & td);
          }
          __syncthreads();
          find_bin(hist, want, false, sh);
          want -= sh->before;
          tprefix |= (unsigned)sh->bin << ts;
          tmask |= td << ts;
          tb = ts;
          for (int i = threadIdx.x; i < BINS; i += THREADS) hist[i] = 0;
          __syncthreads();
        }
        t_lim = tprefix;
      }
    }
    kth = prefix;
  }
  if (threadIdx.x == 0) sh->n = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const float v = src.score(i);
    if (!(v > HALF_NEG_INF)) continue;
    const unsigned key = order_key(v);
    const unsigned tie = src.tie(i);
    if (take_all || key > kth || (key == kth && tie <= t_lim)) {
      const unsigned pos = atomicAdd(&sh->n, 1u);
      cand_s[pos] = v;
      cand_t[pos] = tie;
    }
  }
  __syncthreads();
  const int n_cand = (int)sh->n;
  for (int i = threadIdx.x; i < n_cand; i += THREADS) {
    const float v = cand_s[i];
    const unsigned t = cand_t[i];
    int rank = 0;
    for (int j = 0; j < n_cand; ++j) {
      const float u = cand_s[j];
      rank += (u > v || (u == v && cand_t[j] < t)) ? 1 : 0;
    }
    out_s[rank] = v;
    out_i[rank] = src.col(t);
    out_c[rank] = src.count(t);
  }
  for (int i = n_cand + threadIdx.x; i < k; i += THREADS) {
    out_s[i] = NEG_INF;
    out_i[i] = -1;
    out_c[i] = pad_count;
  }
  __syncthreads();  // the candidates are read before the caller reuses them
}

__device__ __forceinline__ bool beats(float a, unsigned at, float b, unsigned bt) {
  return a > b || (a == b && at < bt);
}

// The lanes' (score, tie) entries compared with the partner lane at
// distance j: keep the better of the two, or the worse.
__device__ __forceinline__ void exchange(float& s, unsigned& t, int j, bool keep_better) {
  const float os = __shfl_xor_sync(0xffffffffu, s, j);
  const unsigned ot = __shfl_xor_sync(0xffffffffu, t, j);
  if (beats(os, ot, s, t) == keep_better) {
    s = os;
    t = ot;
  }
}

// The warp's 32 entries sorted best first (lane 0) by a bitonic network.
__device__ __forceinline__ void warp_sort32(float& s, unsigned& t) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      exchange(s, t, j, ((lane & k) == 0) == ((lane & j) == 0));
    }
  }
}

// The best 32 of two lists sorted best first, (s, t) and (bs, bt), sorted
// best first into (s, t): the elementwise better of the first and the second
// reversed is a bitonic sequence, which half-cleaners sort.
__device__ __forceinline__ void warp_merge32(float& s, unsigned& t, float bs, unsigned bt) {
  const int lane = threadIdx.x & 31;
  const float rs = __shfl_sync(0xffffffffu, bs, 31 - lane);
  const unsigned rt = __shfl_sync(0xffffffffu, bt, 31 - lane);
  if (beats(rs, rt, s, t)) {
    s = rs;
    t = rt;
  }
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) exchange(s, t, j, (lane & j) == 0);
}

// A lane's entry of the warp's best 32 (lane r holds the r-th).
struct Top32 {
  float s;
  unsigned t;
};

// The warp's best 32 with n buffered entries (any order) merged in, 32 at a
// time (out of line: the epilogue calls it from three places).
__device__ __noinline__ Top32 warp_absorb(Top32 cur, const float* buf_s, const unsigned* buf_t, int n) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the lanes' buffered entries are visible
  for (int c0 = 0; c0 < n; c0 += 32) {
    float bs = c0 + lane < n ? buf_s[c0 + lane] : NEG_INF;
    unsigned bt = c0 + lane < n ? buf_t[c0 + lane] : 0xffffffffu;
    warp_sort32(bs, bt);
    warp_merge32(cur.s, cur.t, bs, bt);
  }
  __syncwarp();  // read before the buffer is written again
  return cur;
}

// The best 32 of entries [lo, hi) of src (an entry not real, or past hi,
// is (NEG_INF, 0xffffffff): worse than any real one), sorted best first
// across the calling warp, from chunks of 32 taken every `stride` chunks.
template <class Src>
__device__ __forceinline__ void warp_top32(const Src& src, int lo, int hi, int stride, float& s, unsigned& t) {
  const int lane = threadIdx.x & 31;
  s = NEG_INF;
  t = 0xffffffffu;
  for (int c0 = lo; c0 < hi; c0 += 32 * stride) {
    const int e = c0 + lane;
    float cs = NEG_INF;
    unsigned ct = 0xffffffffu;
    if (e < hi) {
      const float v = src.score(e);
      if (v > HALF_NEG_INF) {
        cs = v;
        ct = src.tie(e);
      }
    }
    warp_sort32(cs, ct);
    if (c0 == lo) {
      s = cs;
      t = ct;
    } else {
      warp_merge32(s, t, cs, ct);
    }
  }
}

// The block's best 32 from each warp's best 32 (s, t), merged in a tree
// through top_s/top_t (WARPS x 32 shared entries); warp 0 ends with them.
__device__ __forceinline__ void block_top32(float& s, unsigned& t, float* top_s, unsigned* top_t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  top_s[warp * 32 + lane] = s;
  top_t[warp * 32 + lane] = t;
  __syncthreads();
  for (int step = 1; step < WARPS; step <<= 1) {
    if (warp % (2 * step) == 0) {
      warp_merge32(s, t, top_s[(warp + step) * 32 + lane], top_t[(warp + step) * 32 + lane]);
    }
    __syncthreads();
    if (warp % (2 * step) == 0) {
      top_s[warp * 32 + lane] = s;
      top_t[warp * 32 + lane] = t;
    }
    __syncthreads();
  }
}

// Warp 0's sorted best 32 (s, t) written as a cut of k <= 32, padded with
// (NEG_INF, -1, pad_count).
template <class Src>
__device__ __forceinline__ void write_top32(const Src& src, int k, float s, unsigned t, float* out_s,
                                            long long* out_i, long long* out_c, long long pad_count) {
  const int lane = threadIdx.x & 31;
  if (lane >= k) return;
  const bool real = s > HALF_NEG_INF;
  out_s[lane] = real ? s : NEG_INF;
  out_i[lane] = real ? src.col(t) : -1;
  out_c[lane] = real ? src.count(t) : pad_count;
}

// A tile's columns in shared memory as the cut's entries: entry i is local
// column i (its tie key).
struct TileSrc {
  const float* score_;
  const uint16_t* cnt_;  // null without counts
  long long c_lo;
  __device__ float score(int i) const { return score_[i]; }
  __device__ unsigned tie(int i) const { return (unsigned)i; }
  __device__ long long col(unsigned t) const { return c_lo + t; }
  __device__ long long count(unsigned t) const { return cnt_ ? (long long)cnt_[t] : -1ll; }
};

// A row's tiles' cuts in device memory as the merge's entries: entry e (its
// tie key: among equal scores, entry order is column order).
struct CutsSrc {
  const float* s;
  const long long* i_;
  const long long* c;
  __device__ float score(int e) const { return s[e]; }
  __device__ unsigned tie(int e) const { return (unsigned)e; }
  __device__ long long col(unsigned e) const { return i_[e]; }
  __device__ long long count(unsigned e) const { return c[e]; }
};

__device__ __forceinline__ int bits_for(long long n) {
  int bits = 1;
  while ((1ll << bits) < n) ++bits;
  return bits;
}

// The posting record holding slot column s (lo <= s < hi), or -1.
template <int NREC>
__device__ __forceinline__ int find_record(const Table<NREC>& tab, int n_post, int s) {
  int lo = 0, hi = n_post;  // the records' slot ranges ascend in table order
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tab.recs[mid].hi <= s) lo = mid + 1; else hi = mid;
  }
  return (lo < n_post && tab.recs[lo].lo <= s) ? lo : -1;
}

// One dense record's weights at one column (local window column `local`,
// tile column `li`): its doc length's x, the record's nv valid slots (rows
// and idfs in shared memory) in slot order; kind 1 sums the slots from 0.0,
// then adds the sum; kind 2 adds slot by slot.
__device__ __forceinline__ void dense_column(const Rec& rec, long long local, int li, float avgdl, int nv,
                                             const int* s_drow, const float* s_didf, float* s_score,
                                             uint16_t* s_cnt) {
  const uint8_t* block = reinterpret_cast<const uint8_t*>(rec.p0);
  const float x = bm25_x(reinterpret_cast<const float*>(rec.p1)[local], avgdl);
  float s = s_score[li], acc = 0.0f;
  int n = s_cnt ? s_cnt[li] : 0, acc_n = 0;
  for (int j = 0; j < nv; ++j) {
    const float tf = (float)block[(long long)s_drow[j] * rec.width + local];
    if (!(tf > 0.0f)) continue;
    const float w = bm25_w(s_didf[j], tf, x);
    if (rec.kind == 2) {
      s = __fadd_rn(s, w);
      ++n;
    } else {
      acc = __fadd_rn(acc, w);
      ++acc_n;
    }
  }
  if (rec.kind != 2) {
    s = __fadd_rn(s, acc);
    n += acc_n;
  }
  s_score[li] = s;
  if (s_cnt) s_cnt[li] = (uint16_t)n;
}

// One slot batch of a group of four columns: the doc lengths (16 bytes)
// and up to four slots' tfs (4 bytes each).
struct DenseLoads {
  float4 dl;
  uchar4 tf[4];
};

__device__ __forceinline__ DenseLoads dense_loads(const Rec& rec, long long local, int nv, const int* s_drow) {
  DenseLoads out;
  out.dl = *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(rec.p1) + local);
  const uint8_t* block = reinterpret_cast<const uint8_t*>(rec.p0);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out.tf[j] = j < nv ? *reinterpret_cast<const uchar4*>(block + (long long)s_drow[j] * rec.width + local)
                       : make_uchar4(0, 0, 0, 0);
  }
  return out;
}

// One group of four columns (window column `local`, tile column li) from
// its loads: kind 1 sums the slots from 0.0, then adds the sum; kind 2 adds
// slot by slot (slots past the fourth are loaded here).
__device__ __forceinline__ void dense_group(const Rec& rec, const DenseLoads& ld, long long local, int li, float avgdl,
                                            int nv, const int* s_drow, const float* s_didf, float* s_score,
                                            uint16_t* s_cnt) {
  const bool direct = rec.kind == 2;
  const float dls[4] = {ld.dl.x, ld.dl.y, ld.dl.z, ld.dl.w};
  float x[4], s[4], acc[4];
  int n[4], acc_n[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    x[c] = bm25_x(dls[c], avgdl);
    s[c] = s_score[li + c];
    n[c] = s_cnt ? s_cnt[li + c] : 0;
    acc[c] = 0.0f;
    acc_n[c] = 0;
  }
  for (int j = 0; j < nv; ++j) {
    uchar4 t4;
    if (j < 4) {
      t4 = j == 0 ? ld.tf[0] : (j == 1 ? ld.tf[1] : (j == 2 ? ld.tf[2] : ld.tf[3]));
    } else {
      t4 = *reinterpret_cast<const uchar4*>(reinterpret_cast<const uint8_t*>(rec.p0)
                                            + (long long)s_drow[j] * rec.width + local);
    }
    const uint8_t tf8[4] = {t4.x, t4.y, t4.z, t4.w};
    const float idf = s_didf[j];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float tf = (float)tf8[c];
      if (!(tf > 0.0f)) continue;
      const float w = bm25_w(idf, tf, x[c]);
      if (direct) {
        s[c] = __fadd_rn(s[c], w);
        ++n[c];
      } else {
        acc[c] = __fadd_rn(acc[c], w);
        ++acc_n[c];
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (!direct) {
      s[c] = __fadd_rn(s[c], acc[c]);
      n[c] += acc_n[c];
    }
    s_score[li + c] = s[c];
    if (s_cnt) s_cnt[li + c] = (uint16_t)n[c];
  }
}

// The same at the aligned groups of four columns g = g0, g0 + THREADS, ...
// below g_end (tile columns 4 * g): each group's doc lengths in one 16-byte
// load and each slot's tfs in one 4-byte load, the next group's loads
// issued before this group's arithmetic.
__device__ __forceinline__ void dense_groups(const Rec& rec, long long c_lo, int g0, int g_end, float avgdl,
                                             int nv, const int* s_drow, const float* s_didf, float* s_score,
                                             uint16_t* s_cnt) {
  const long long base = c_lo - rec.start;
  DenseLoads cur = dense_loads(rec, base + 4ll * g0, nv, s_drow);
  for (int g = g0; g < g_end; g += THREADS) {
    DenseLoads next;
    if (g + THREADS < g_end) next = dense_loads(rec, base + 4ll * (g + THREADS), nv, s_drow);
    dense_group(rec, cur, base + 4ll * g, 4 * g, avgdl, nv, s_drow, s_didf, s_score, s_cnt);
    cur = next;
  }
}

template <int NREC>
__global__ void __launch_bounds__(THREADS, 3) bm25_program_kernel(
    const __grid_constant__ Table<NREC> tab, int n_post, int n_dense,
    const int* __restrict__ rows, const float* __restrict__ idfs, int S,
    const float* __restrict__ params,  // [Q, 3]: avgdl, required, min_score
    const uint8_t* __restrict__ mask, long long mask_stride,  // [L] (stride 0) or [Q, L]
    float* __restrict__ final_, float* __restrict__ counts,  // rows mode: [Q, L], counts null without counts
    bool with_counts,
    uint8_t* __restrict__ matched,  // [Q, L] or null
    long long* __restrict__ match_part,  // [Q, n_tiles] or null
    float* __restrict__ cut_s, long long* __restrict__ cut_i, long long* __restrict__ cut_c,
    long long ic_stride, int k,  // entry (q, tile) at cut_s + (q * n_tiles + tile) * k, cut_i/c + ... * ic_stride
    long long L, int tile_cols, int dir_cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ CutShared sh;
  __shared__ int s_scan[WARPS];
  __shared__ int s_first, s_last, s_nv;

  const int q = blockIdx.y;
  const int tile = blockIdx.x;
  const long long c_lo = (long long)tile * tile_cols;
  const long long c_hi = c_lo + tile_cols < L ? c_lo + tile_cols : L;
  const int n_cols = (int)(c_hi - c_lo);
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  float* s_score = reinterpret_cast<float*>(smem);
  uint16_t* s_cnt = with_counts ? reinterpret_cast<uint16_t*>(smem + (size_t)tile_cols * 4) : nullptr;
  unsigned char* work = smem + tile_bytes(tile_cols, with_counts);
  // phase B: the posting piece
  int* p_base = reinterpret_cast<int*>(work);  // [PIECE] the first candidate's flat lane (a tier holds < 2^31)
  int* p_off = p_base + PIECE;                 // [PIECE + 1] the candidates before each slot
  int* p_rec = p_off + PIECE + 1;                          // [PIECE]
  float* p_idf = reinterpret_cast<float*>(p_rec + PIECE);  // [PIECE]
  int* p_hit = reinterpret_cast<int*>(p_idf + PIECE);      // [PIECE] a lane of the slot lands in the tile
  // phase C: a dense record's valid slots
  int* s_drow = reinterpret_cast<int*>(work + BINS * 4);             // [MAX_DENSE_SLOTS]
  float* s_didf = reinterpret_cast<float*>(s_drow + MAX_DENSE_SLOTS);  // [MAX_DENSE_SLOTS]
  // the epilogue (k <= SELECT_K): the warps' buffers, after the warps' best 32 of phase D
  float* s_wbuf_s = reinterpret_cast<float*>(work + WARPS * 32 * 8);  // [WARPS * WARP_BUF]
  unsigned* s_wbuf_t = reinterpret_cast<unsigned*>(s_wbuf_s + WARPS * WARP_BUF);
  // phase D
  unsigned* s_hist = reinterpret_cast<unsigned*>(work);              // [BINS]
  float* s_cand_s = reinterpret_cast<float*>(work + BINS * 4);       // [KMAX]
  unsigned* s_cand_t = reinterpret_cast<unsigned*>(s_cand_s + KMAX);  // [KMAX]

  STAMP(0);
  for (int i = tid; i < tile_cols; i += THREADS) s_score[i] = 0.0f;
  if (s_cnt) {
    for (int i = tid; i < tile_cols; i += THREADS) s_cnt[i] = 0;
  }

  const float avgdl = params[q * 3 + 0];
  const int* qrows = rows + (long long)q * S;
  const float* qidfs = idfs + (long long)q * S;

  STAMP(1);
  // ---- phase B: the posting lanes in the tile, slot order ----------------
  const int post_end = n_post > 0 ? tab.recs[n_post - 1].hi : 0;
  const long long g_lo = c_lo / dir_cols;                    // the tile's first directory boundary
  const long long g_hi = (c_hi + dir_cols - 1) / dir_cols;   // and its last
  for (int pb = 0; pb < post_end; pb += PIECE) {
    int len[2];
    int base[2];
    int rec_of[2];
    float idf_of[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int s = pb + 2 * tid + j;
      len[j] = 0;
      base[j] = 0;
      rec_of[j] = 0;
      idf_of[j] = 0.0f;
      if (s >= post_end) continue;
      const int r = find_record(tab, n_post, s);
      if (r < 0) continue;
      const Rec& rec = tab.recs[r];
      const int row = qrows[s];
      if (row < 0 || row >= rec.n_rows) continue;
      long long a = 0, b = rec.width;
      if (rec.dir != nullptr) {
        const int* d = reinterpret_cast<const int*>(rec.dir) + (long long)row * (rec.dir_n + 1);
        long long ja = g_lo - rec.dir_t0, jb = g_hi - rec.dir_t0;
        ja = ja < 0 ? 0 : (ja > rec.dir_n ? rec.dir_n : ja);
        jb = jb < 0 ? 0 : (jb > rec.dir_n ? rec.dir_n : jb);
        a = d[ja];
        b = d[jb];
      }
      len[j] = (int)(b - a);
      base[j] = row * rec.width + (int)a;
      rec_of[j] = r;
      idf_of[j] = qidfs[s];
    }
    int total;
    const int before = block_excl_scan(len[0] + len[1], s_scan, &total);
    __syncthreads();  // the previous piece's arrays are read by every thread
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = 2 * tid + j;
      p_off[i] = before + (j ? len[0] : 0);
      p_base[i] = base[j];
      p_rec[i] = rec_of[j];
      p_idf[i] = idf_of[j];
      p_hit[i] = 0;
    }
    if (tid == 0) p_off[PIECE] = total;
    __syncthreads();

    for (int cb = 0; cb < total; cb += CHUNK) {
      const int e_last = (cb + CHUNK < total ? cb + CHUNK : total) - 1;
      int slot[UNROLL], col[UNROLL];
      float w[UNROLL];
      // round 1: the candidates' doc ids (and tf, dl where a directory placed
      // the lane in the tile)
      int doc[UNROLL];
      float tf[UNROLL], dl[UNROLL];
      int lane_of[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = cb + u * THREADS + tid;
        slot[u] = -1;
        doc[u] = -1;
        tf[u] = 0.0f;
        dl[u] = 1.0f;
        lane_of[u] = 0;
        if (e >= total) continue;
        int lo = 0, hi = PIECE - 1;  // the last slot whose candidates start at or before e
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (p_off[mid] <= e) lo = mid; else hi = mid - 1;
        }
        slot[u] = lo;
        if (e == cb) s_first = lo;
        if (e == e_last) s_last = lo;
        lane_of[u] = p_base[lo] + (e - p_off[lo]);
        const Rec& rec = tab.recs[p_rec[lo]];
        doc[u] = reinterpret_cast<const int*>(rec.p0)[lane_of[u]];
        if (rec.dir != nullptr) {
          tf[u] = reinterpret_cast<const float*>(rec.p1)[lane_of[u]];
          dl[u] = reinterpret_cast<const float*>(rec.p2)[lane_of[u]];
        }
      }
      // round 2: tf and dl of the whole-row candidates in the tile
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        col[u] = -1;
        if (slot[u] < 0) continue;
        const Rec& rec = tab.recs[p_rec[slot[u]]];
        const long long g = (long long)doc[u] + rec.start;
        if (doc[u] < 0 || g < c_lo || g >= c_hi) {
          slot[u] = -1;
          continue;
        }
        col[u] = (int)(g - c_lo);
        if (rec.dir == nullptr) {
          tf[u] = reinterpret_cast<const float*>(rec.p1)[lane_of[u]];
          dl[u] = reinterpret_cast<const float*>(rec.p2)[lane_of[u]];
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        w[u] = 0.0f;
        if (slot[u] < 0) continue;
        w[u] = bm25_w(p_idf[slot[u]], tf[u], bm25_x(dl[u], avgdl));
        p_hit[slot[u]] = 1;
      }
      __syncthreads();
      // the adds, slot by slot among the chunk's slots that hit the tile
      const int first = s_first, last = s_last;
      for (int b0 = first; b0 <= last; b0 += 32) {
        const int i = b0 + lane;
        unsigned bits = __ballot_sync(0xffffffffu, i <= last && p_hit[i] != 0);  // the same in every warp
        while (bits) {
          const int hit = b0 + __ffs(bits) - 1;
          bits &= bits - 1;
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            if (slot[u] == hit) {
              s_score[col[u]] = __fadd_rn(s_score[col[u]], w[u]);
              if (s_cnt) s_cnt[col[u]] += 1;
            }
          }
          __syncthreads();  // the next slot's adds come after this one's
        }
      }
      for (int i = first + tid; i <= last; i += THREADS) p_hit[i] = 0;
      __syncthreads();
    }
  }
  __syncthreads();

  STAMP(2);
  // ---- phase C: the dense blocks ------------------------------------------
  const bool vec_tile = (tile_cols & 3) == 0;
  for (int r = n_post; r < n_post + n_dense; ++r) {
    const Rec& rec = tab.recs[r];
    const long long w_lo = c_lo > rec.start ? c_lo : (long long)rec.start;
    const long long w_end = (long long)rec.start + rec.width;
    const long long w_hi = c_hi < w_end ? c_hi : w_end;
    if (w_lo >= w_hi) continue;  // the same for every thread
    // the record's valid slots, in slot order (warp 0)
    if (tid < 32) {
      int nv = 0;
      for (int j0 = rec.lo; j0 < rec.hi; j0 += 32) {
        const int j = j0 + lane;
        const int row = j < rec.hi ? qrows[j] : -1;
        const bool ok = row >= 0 && row < rec.n_rows;
        const unsigned bits = __ballot_sync(0xffffffffu, ok);
        if (ok) {
          const int at = nv + __popc(bits & ((1u << lane) - 1u));
          s_drow[at] = row;
          s_didf[at] = qidfs[j];
        }
        nv += __popc(bits);
      }
      if (tid == 0) s_nv = nv;
    }
    __syncthreads();
    const int nv = s_nv;
    // no slot scheduled: the plain version adds 0.0 to every column, which
    // leaves a score (never -0.0) and a count as they are
    if (nv > 0) {
      // tile columns [wa, wb); the groups of four [4 g_first, 4 g_end) in it
      // take the 4-byte loads where the window allows them
      const int wa = (int)(w_lo - c_lo), wb = (int)(w_hi - c_lo);
      const bool vec = vec_tile && (rec.start & 3) == 0 && (rec.width & 3) == 0
                       && (reinterpret_cast<uintptr_t>(rec.p0) & 3) == 0
                       && (reinterpret_cast<uintptr_t>(rec.p1) & 15) == 0;
      int g_first = (wa + 3) / 4, g_end = wb / 4;
      if (!vec || g_first >= g_end) g_first = g_end = wb;  // every column alone
      for (int li = wa + tid; li < wb; li += THREADS) {
        if (li >= 4 * g_first && li < 4 * g_end) continue;
        dense_column(rec, c_lo + li - rec.start, li, avgdl, nv, s_drow, s_didf, s_score, s_cnt);
      }
      if (g_first + tid < g_end) dense_groups(rec, c_lo, g_first + tid, g_end, avgdl, nv, s_drow, s_didf, s_score, s_cnt);
    }
    __syncthreads();  // the next record's slots overwrite these; the epilogue reads the scores
  }
  STAMP(3);
  // ---- the epilogue: final, the bitmap or match count, the warps' best ----
  const float required = params[q * 3 + 1];
  const float req1 = required < 1.0f ? 1.0f : required;  // clamp_min(1.0), NaN kept
  const float min_score = params[q * 3 + 2];
  const uint8_t* qmask = mask + (long long)q * mask_stride + c_lo;
  uint8_t* qmatched = matched ? matched + (long long)q * L + c_lo : nullptr;
  float* qfinal = final_ ? final_ + (long long)q * L + c_lo : nullptr;
  float* qcounts = counts ? counts + (long long)q * L + c_lo : nullptr;
  long long n_matched = 0, n_kept = 0;
  // k <= SELECT_K: each warp keeps the best 32 of its kept entries (lane r
  // the r-th, in registers) and buffers in shared memory the entries that
  // beat the 32nd; 32 buffered are sorted and merged in. Past SELECT_K the
  // tile's final scores stay in s_score for the radix select.
  const bool select32 = cut_s != nullptr && k <= SELECT_K;
  Top32 top{NEG_INF, 0xffffffffu};
  float thr_s = NEG_INF;  // the 32nd best so far
  unsigned thr_t = 0xffffffffu;
  int nb = 0;  // entries buffered (the same in every lane)
  float* wbuf_s = s_wbuf_s + (tid >> 5) * WARP_BUF;
  unsigned* wbuf_t = s_wbuf_t + (tid >> 5) * WARP_BUF;
  auto offer = [&](float fin, int li) {
    const bool cand = fin > HALF_NEG_INF && beats(fin, (unsigned)li, thr_s, thr_t);
    const unsigned bits = __ballot_sync(0xffffffffu, cand);
    if (bits == 0) return;
    const int at = nb + __popc(bits & ((1u << lane) - 1u));
    if (cand) {
      wbuf_s[at] = fin;
      wbuf_t[at] = (unsigned)li;
    }
    nb += __popc(bits);
  };
  auto absorb = [&]() {  // the buffered entries merged into the best 32
    top = warp_absorb(top, wbuf_s, wbuf_t, nb);
    nb = 0;
    thr_s = __shfl_sync(0xffffffffu, top.s, 31);
    thr_t = __shfl_sync(0xffffffffu, top.t, 31);
  };
  const bool quads = (tile_cols & 3) == 0 && (L & 3) == 0 && (mask_stride & 3) == 0
                     && (reinterpret_cast<uintptr_t>(mask) & 3) == 0 && (reinterpret_cast<uintptr_t>(matched) & 3) == 0
                     && (reinterpret_cast<uintptr_t>(final_) & 15) == 0 && (reinterpret_cast<uintptr_t>(counts) & 15) == 0;
  if (quads) {
    // four columns a thread: one 16-byte score load, one 4-byte mask load
    for (int b0 = 0; b0 < n_cols; b0 += 4 * THREADS) {  // the same bound in every thread: warp ballots below
      const int li = b0 + 4 * tid;
      float fv[4] = {NEG_INF, NEG_INF, NEG_INF, NEG_INF};
      if (li < n_cols) {
        const float4 s4 = *reinterpret_cast<const float4*>(s_score + li);
        const uchar4 m4 = *reinterpret_cast<const uchar4*>(qmask + li);
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
        const uint8_t mv[4] = {m4.x, m4.y, m4.z, m4.w};
        float nv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (s_cnt) {
          const ushort4 n4 = *reinterpret_cast<const ushort4*>(s_cnt + li);
          nv[0] = (float)n4.x;
          nv[1] = (float)n4.y;
          nv[2] = (float)n4.z;
          nv[3] = (float)n4.w;
        }
        uint8_t mo[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool m = (s_cnt ? nv[u] >= req1 : sv[u] > 0.0f) && mv[u] != 0;
          fv[u] = (m && sv[u] >= min_score) ? sv[u] : NEG_INF;
          mo[u] = m ? 1 : 0;
          n_matched += m ? 1 : 0;
        }
        if (qfinal) *reinterpret_cast<float4*>(qfinal + li) = make_float4(fv[0], fv[1], fv[2], fv[3]);
        if (qcounts) *reinterpret_cast<float4*>(qcounts + li) = make_float4(nv[0], nv[1], nv[2], nv[3]);
        if (qmatched) *reinterpret_cast<uchar4*>(qmatched + li) = make_uchar4(mo[0], mo[1], mo[2], mo[3]);
        if (cut_s) *reinterpret_cast<float4*>(s_score + li) = make_float4(fv[0], fv[1], fv[2], fv[3]);
      }
      if (select32) {
#pragma unroll
        for (int u = 0; u < 4; ++u) offer(fv[u], li + u);
        if (nb >= 32) absorb();
      } else if (cut_s) {
#pragma unroll
        for (int u = 0; u < 4; ++u) n_kept += fv[u] > HALF_NEG_INF ? 1 : 0;
      }
    }
  } else {
    for (int b0 = 0; b0 < n_cols; b0 += THREADS) {  // the same bound in every thread: warp ballots below
      const int li = b0 + tid;
      float fin = NEG_INF;
      if (li < n_cols) {
        const float s = s_score[li];
        const float n = s_cnt ? (float)s_cnt[li] : 0.0f;
        const bool m = (s_cnt ? n >= req1 : s > 0.0f) && qmask[li] != 0;
        fin = (m && s >= min_score) ? s : NEG_INF;
        if (qfinal) qfinal[li] = fin;
        if (qcounts) qcounts[li] = n;
        if (qmatched) qmatched[li] = m ? 1 : 0;
        n_matched += m ? 1 : 0;
        if (cut_s) s_score[li] = fin;
      }
      if (select32) {
        offer(fin, li);
        if (nb >= 32) absorb();
      } else if (cut_s) {
        n_kept += fin > HALF_NEG_INF ? 1 : 0;
      }
    }
  }
  if (select32 && nb > 0) absorb();
  if (match_part) {
    const long long total = block_sum(n_matched, sh.red);
    if (tid == 0) match_part[(long long)q * gridDim.x + tile] = total;
  }
  STAMP(4);
  if (!cut_s) {
    STAMP(5);
    return;
  }

  // ---- phase D: the tile's cut ------------------------------------------
  const long long b = (long long)q * gridDim.x + tile;
  const long long pad = s_cnt ? (long long)s_cnt[0] : -1ll;
  float* out_s = cut_s + b * k;
  long long* out_i = cut_i + b * ic_stride;
  long long* out_c = cut_c + b * ic_stride;
  const TileSrc src{s_score, s_cnt, c_lo};
  if (select32) {
    // the warps' best 32 merged in a tree: warp 0 holds the tile's
    block_top32(top.s, top.t, reinterpret_cast<float*>(s_hist), s_hist + WARPS * 32);
    if (tid < 32) write_top32(src, k, top.s, top.t, out_s, out_i, out_c, pad);
    STAMP(5);
    return;
  }
  const long long kept = block_sum(n_kept, sh.red);  // also orders the epilogue's writes before the select
  for (int i = tid; i < BINS; i += THREADS) s_hist[i] = 0;
  __syncthreads();
  block_cut(src, n_cols, bits_for(tile_cols), k, kept, s_hist, s_cand_s, s_cand_t, &sh, out_s, out_i, out_c, pad);
  STAMP(5);
}

// One block a row: the row's cut from its n_tiles tiles' cuts (each in
// lax.top_k's order, the tiles in column order), written as top_s [Q, k]
// and top_ic [Q, 2k] (k ids, then k counts; padding takes tile 0's padding
// count, the count at column 0); and the row's match count from its tiles'.
__global__ void __launch_bounds__(THREADS) bm25_merge_kernel(
    const float* __restrict__ cut_s, const long long* __restrict__ cut_i, const long long* __restrict__ cut_c,
    int n_tiles, int k, const long long* __restrict__ part, float* __restrict__ top_s,
    long long* __restrict__ top_ic, long long* __restrict__ match_count) {
  __shared__ __align__(16) unsigned s_hist[BINS];
  __shared__ float s_cand_s[KMAX];
  __shared__ unsigned s_cand_t[KMAX];
  __shared__ CutShared sh;
  const int q = blockIdx.x;
  if (part) {
    long long v = 0;
    for (int t = threadIdx.x; t < n_tiles; t += THREADS) v += part[(long long)q * n_tiles + t];
    const long long total = block_sum(v, sh.red);
    if (threadIdx.x == 0) match_count[q] = total;
  }
  const int n = n_tiles * k;
  const long long base = (long long)q * n;
  const CutsSrc src{cut_s + base, cut_i + base, cut_c + base};
  if (k <= SELECT_K) {
    // each warp's best 32 of chunks warp, warp + WARPS, ..., then the block's
    float bs;
    unsigned bt;
    warp_top32(src, 32 * (threadIdx.x >> 5), n, WARPS, bs, bt);
    block_top32(bs, bt, reinterpret_cast<float*>(s_hist), s_hist + WARPS * 32);
    if (threadIdx.x < 32) {
      write_top32(src, k, bs, bt, top_s + (long long)q * k, top_ic + (long long)q * 2 * k,
                  top_ic + (long long)q * 2 * k + k, src.count(k - 1));
    }
    return;
  }
  for (int i = threadIdx.x; i < BINS; i += THREADS) s_hist[i] = 0;
  long long n_kept = 0;
  for (int e = threadIdx.x; e < n; e += THREADS) n_kept += src.score(e) > HALF_NEG_INF ? 1 : 0;
  const long long kept = block_sum(n_kept, sh.red);  // also orders the clear before the select
  block_cut(src, n, bits_for(n), k, kept, s_hist, s_cand_s, s_cand_t, &sh, top_s + (long long)q * k,
            top_ic + (long long)q * 2 * k, top_ic + (long long)q * 2 * k + k, src.count(k - 1));
}

template <int NREC>
struct Launch {
  // the kernel's shared-memory limit: one value for the process (MAX_SMEM),
  // set once a device, so threads launching at once with other tiles never
  // find it lowered under their launch
  static cudaError_t smem_limit() {
    static std::atomic<unsigned long long> done{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (bit != 0 && (done.load() & bit) != 0) return cudaSuccess;
    err = cudaFuncSetAttribute(bm25_program_kernel<NREC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
    if (err == cudaSuccess) done.fetch_or(bit);
    return err;
  }

  static int run(const void* recs, int n_recs, int n_post, const void* rows, const void* idfs, int S,
                 const void* params, const void* mask, long long mask_stride, void* final_, void* counts,
                 bool with_counts, void* matched, void* match_part, void* cut_s, void* cut_i, void* cut_c,
                 long long ic_stride, int k, long long L, int tile_cols, int dir_cols, int Q, cudaStream_t st) {
    Table<NREC> tab;
    memset(&tab, 0, sizeof(tab));
    memcpy(tab.recs, recs, (size_t)n_recs * sizeof(Rec));
    const size_t smem = tile_bytes(tile_cols, with_counts) + WORK_BYTES;
    cudaError_t err = smem_limit();
    if (err != cudaSuccess) return (int)err;
    const unsigned n_tiles = (unsigned)((L + tile_cols - 1) / tile_cols);
    dim3 grid(n_tiles, (unsigned)Q);
    bm25_program_kernel<NREC><<<grid, THREADS, smem, st>>>(
        tab, n_post, n_recs - n_post,
        static_cast<const int*>(rows), static_cast<const float*>(idfs), S,
        static_cast<const float*>(params),
        static_cast<const uint8_t*>(mask), mask_stride,
        static_cast<float*>(final_), static_cast<float*>(counts), with_counts,
        static_cast<uint8_t*>(matched), static_cast<long long*>(match_part),
        static_cast<float*>(cut_s), static_cast<long long*>(cut_i), static_cast<long long*>(cut_c),
        ic_stride, k, L, tile_cols, dir_cols);
    return (int)cudaGetLastError();
  }
};

}  // namespace

#ifdef BM25_STAMPS
// The phase stamps of the last launch: STAMP_BLOCKS * 8 u64 into host ``out``.
extern "C" int bm25_stamps(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
#endif

// Returns 0, or the CUDA error of the launch. ``recs`` is a host array of
// n_recs records, the n_post posting records first, copied into the launch's
// parameter. The grid is ceil(L / tile_cols) x Q; tile_cols is a multiple of
// dir_cols, at most MAX_TILE. Rows mode (k = 0, cut_* null): final_ [Q, L]
// and, with counts, counts [Q, L]. Cut mode (1 <= k <= KMAX, final_ and
// counts null): each (query, tile) writes k entries at cut_s + (q * n_tiles
// + tile) * k and cut_i / cut_c + (q * n_tiles + tile) * ic_stride.
// matched [Q, L] (u8) or match_part [Q, n_tiles], whichever is given.
extern "C" int bm25_program(
    const void* recs, int n_recs, int n_post,
    const void* rows, const void* idfs, int S, const void* params,
    const void* mask, long long mask_stride,
    void* final_, void* counts, int with_counts, void* matched, void* match_part,
    void* cut_s, void* cut_i, void* cut_c, long long ic_stride, int k,
    long long L, int tile_cols, int dir_cols, int Q, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cut = cut_s != nullptr;
  if (n_recs > MAX_RECS || n_post > n_recs || S > MAX_SLOTS || k < 0 || k > KMAX || cut != (k > 0)
      || (cut && (cut_i == nullptr || cut_c == nullptr)) || (cut && final_ != nullptr)
      || (counts != nullptr && !with_counts) || tile_cols <= 0 || tile_cols > MAX_TILE || dir_cols <= 0
      || tile_cols % dir_cols != 0 || L <= 0 || Q <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Rec* rs = static_cast<const Rec*>(recs);
  for (int r = n_post; r < n_recs; ++r) {
    if (rs[r].hi - rs[r].lo > MAX_DENSE_SLOTS) return (int)cudaErrorInvalidValue;
  }
  if (n_recs <= 32) {
    return Launch<32>::run(recs, n_recs, n_post, rows, idfs, S, params, mask, mask_stride, final_, counts,
                           with_counts != 0, matched, match_part, cut_s, cut_i, cut_c, ic_stride, k, L, tile_cols,
                           dir_cols, Q, st);
  }
  if (n_recs <= 128) {
    return Launch<128>::run(recs, n_recs, n_post, rows, idfs, S, params, mask, mask_stride, final_, counts,
                            with_counts != 0, matched, match_part, cut_s, cut_i, cut_c, ic_stride, k, L, tile_cols,
                            dir_cols, Q, st);
  }
  return Launch<MAX_RECS>::run(recs, n_recs, n_post, rows, idfs, S, params, mask, mask_stride, final_, counts,
                               with_counts != 0, matched, match_part, cut_s, cut_i, cut_c, ic_stride, k, L,
                               tile_cols, dir_cols, Q, st);
}

// Returns 0, or the CUDA error of the launch: the merge of [Q, n_tiles, k]
// tile cuts (scores f32, columns and counts i64) into top_s [Q, k] and
// top_ic [Q, 2k]; with part [Q, n_tiles] also match_count [Q].
extern "C" int bm25_merge(
    const void* cut_s, const void* cut_i, const void* cut_c, int n_tiles, int k,
    const void* part, void* top_s, void* top_ic, void* match_count, int Q, void* stream) {
  if (k < 1 || k > KMAX || n_tiles < 1 || Q <= 0 || (part != nullptr) != (match_count != nullptr)
      || (long long)n_tiles * k > 0x7fffffffll) {
    return (int)cudaErrorInvalidValue;
  }
  bm25_merge_kernel<<<Q, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cut_s), static_cast<const long long*>(cut_i),
      static_cast<const long long*>(cut_c), n_tiles, k, static_cast<const long long*>(part),
      static_cast<float*>(top_s), static_cast<long long*>(top_ic), static_cast<long long*>(match_count));
  return (int)cudaGetLastError();
}
