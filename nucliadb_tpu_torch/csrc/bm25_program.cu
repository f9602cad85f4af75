// The BM25 program of the keyword leg for Hopper (sm_90a), CUDA C++ with a
// plain C entry.
//
// Replaces the XLA programs of nucliadb_tpu/index/text_engine/engine.py:
// _bm25_groups_core (wrappers _bm25_groups, _bm25_groups_batch) and
// _bm25_search (_bm25_search_batch), the top-k cut's selection included.
// They are jitted XLA code, not Pallas kernels; the port ran them as ~200
// eager torch launches a request (ops/bm25.py's plain version). One launch
// here computes, for Q queries of S slot columns each:
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
// 4. the block's cut (when 1 <= k <= KMAX): the k best entries of the
//    block's columns of final, by score descending then column ascending
//    (lax.top_k's order), as [k] scores and columns, padded with (NEG_INF,
//    -1). ops/bm25.py merges the blocks' lists of a row with one stable sort;
//    a row in one block needs no merge.
// Every operation of 1-3 is rounded once with __fmul_rn / __fadd_rn /
// __fdiv_rn (nvcc contracts nothing) in torch's op order, with the f32
// constants torch uses (2.2f, 0.25f, 1.2f, 0.75f), so every output equals the
// plain version's bit for bit on the card.
//
// Determinism without atomics on the rows: one block owns a query's score
// row (or a range of it). Within one slot the doc ids are distinct (a slot
// is one posting row), so its lanes never meet at an address;
// __syncthreads() between slots orders the adds at each address in slot
// order, which is the order of the plain version's one index_add_ per slot.
// The cut's shared-memory atomics only count and collect; the k entries it
// keeps and their order follow from the scores and columns alone.
//
// What bounds it on an H100: bytes. Each posting lane reads 12 bytes and
// updates a random score (and count) word, a 32-byte sector each; each dense
// slot reads a window of u8 tfs; the [Q, L] rows are written zero, read back
// and written final, then read again by the cut's passes. The zero pass, the
// epilogue and the cut stream the rows with coalesced 4-byte accesses; the
// posting phase is bound by the latency of one dependent round trip a slot.
//
// Design.
// - Grid (chunk, query). A block of THREADS threads owns the columns
//   [chunk * width, (chunk + 1) * width) of one query's row; with few queries
//   a row is cut into chunks so that the card is full, and each chunk's block
//   walks every slot and keeps only the lanes in its columns.
// - The table (one record a posting tier or dense block, built once per
//   refresh by ops/bm25.py:Layout, its slot columns set a launch) is a kernel
//   parameter; each block copies it, and the query's rows and idfs, to
//   shared memory, where every thread reads the same entry, a broadcast.
// - Phase A zeroes the block's columns of the score (and count) row; phase B
//   adds the posting lanes, a slot at a time; phase C walks the columns once,
//   adding the dense blocks that cover each column in table order, then
//   writes final, the count row, and the matched bitmap or the block's
//   matched count, and counts the first digit of each kept score; phase D
//   is a radix select of the k-th best score (11-bit digits of an
//   order-preserving key), then, where several columns hold that score, of
//   the column that ends the k (the lower columns first), then one pass that
//   collects the k entries and a rank sort of them in shared memory.

#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr float K1P1 = 2.2f;         // K1 + 1, as torch rounds the Python float
constexpr float ONE_MINUS_B = 0.25f;  // 1 - B
constexpr float K1 = 1.2f;
constexpr float BB = 0.75f;
constexpr float NEG_INF = -3.0e38f;  // ops/topk.py:NEG_INF
constexpr float HALF_NEG_INF = NEG_INF * 0.5f;  // masked_topk's test of a real entry
constexpr size_t MAX_SMEM = 160 * 1024;  // the table and a query's rows and idfs (ops/bm25.py:MAX_SMEM_BYTES)
constexpr int KMAX = 1024;  // the largest k of the block's cut (ops/bm25.py:KMAX)
constexpr int MAX_RECS = 600;  // the table parameter (ops/bm25.py:MAX_RECORDS), 28,800 bytes of the 32,764 a launch takes
constexpr int DIGIT_BITS = 11;
constexpr int BINS = 1 << DIGIT_BITS;

// One record of the program table, 48 bytes (ops/bm25.py:REC_DTYPE).
struct Rec {
  const void* p0;  // posting: docs i32 [T, W]; dense: tfs u8 [R, width]
  const void* p1;  // posting: tfs f32 [T, W]; dense: dl f32 [width]
  const void* p2;  // posting: dls f32 [T, W]; dense: unused
  int start;       // posting: the group's offset added to doc ids; dense: the window's first column
  int kind;        // 0: posting tier; 1: dense block summed, then added; 2: dense block added slot by slot
  int lo, hi;      // the record's slot columns [lo, hi) of rows/idfs
  int n_rows;      // T or R
  int width;       // W or the window's width
};
static_assert(sizeof(Rec) == 48, "ops/bm25.py:REC_DTYPE");

struct Table {
  Rec recs[MAX_RECS];
};

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

// Warp 0: the bin at which the running count of hist, from the top bin down
// (or from bin 0 up), reaches want (1 <= want <= the total); writes it and
// the count of the bins before it.
__device__ void find_bin(const unsigned* hist, unsigned want, bool from_top, int* s_bin, unsigned* s_before) {
  if (threadIdx.x >= 32) return;
  constexpr int PER = BINS / 32;
  const int lane = threadIdx.x;
  unsigned sum = 0;
  for (int j = 0; j < PER; ++j) {
    const int p = lane * PER + j;
    sum += hist[from_top ? BINS - 1 - p : p];
  }
  unsigned incl = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  unsigned cum = incl - sum;
  if (cum < want && want <= incl) {
    for (int j = 0; j < PER; ++j) {
      const int p = lane * PER + j;
      const int bin = from_top ? BINS - 1 - p : p;
      const unsigned h = hist[bin];
      if (cum + h >= want) {
        *s_bin = bin;
        *s_before = cum;
        break;
      }
      cum += h;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2) bm25_program_kernel(
    const __grid_constant__ Table tab, int n_post, int n_dense,
    const int* __restrict__ rows, const float* __restrict__ idfs, int S,
    const float* __restrict__ params,  // [Q, 3]: avgdl, required, min_score
    const uint8_t* __restrict__ mask, long long mask_stride,  // [L] (stride 0) or [Q, L]
    float* final_, float* counts,  // [Q, L]; counts null without the count row
    uint8_t* __restrict__ matched,  // [Q, L] or null
    long long* __restrict__ match_part,  // [Q, n_chunks] or null
    float* __restrict__ cut_s, long long* __restrict__ cut_i, int k,  // [Q, n_chunks, k], or null (k = 0)
    long long L, long long chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_recs = n_post + n_dense;
  Rec* s_recs = reinterpret_cast<Rec*>(smem);
  int* s_rows = reinterpret_cast<int*>(smem + (size_t)n_recs * sizeof(Rec));
  float* s_idfs = reinterpret_cast<float*>(s_rows + S);
  __shared__ long long s_red[WARPS];
  __shared__ unsigned s_hist[BINS];
  __shared__ float s_cand_s[KMAX];
  __shared__ int s_cand_c[KMAX];
  __shared__ int s_bin;
  __shared__ unsigned s_before, s_n;

  const int q = blockIdx.y;
  const long long c_lo = (long long)blockIdx.x * chunk;
  const long long c_hi = c_lo + chunk < L ? c_lo + chunk : L;
  float* score = final_ + (long long)q * L;
  float* cnt = counts ? counts + (long long)q * L : nullptr;

  for (int i = threadIdx.x; i < S; i += THREADS) {
    s_rows[i] = rows[(long long)q * S + i];
    s_idfs[i] = idfs[(long long)q * S + i];
  }
  for (int i = threadIdx.x; i < n_recs * (int)(sizeof(Rec) / 8); i += THREADS) {
    reinterpret_cast<long long*>(s_recs)[i] = reinterpret_cast<const long long*>(tab.recs)[i];
  }
  for (int i = threadIdx.x; i < BINS; i += THREADS) s_hist[i] = 0;
  // phase A: zero this block's columns
  for (long long c = c_lo + threadIdx.x; c < c_hi; c += THREADS) {
    score[c] = 0.0f;
    if (cnt) cnt[c] = 0.0f;
  }
  __syncthreads();

  const float avgdl = params[q * 3 + 0];
  // phase B: the posting lanes, one slot at a time in table order
  for (int r = 0; r < n_post; ++r) {
    const Rec& rec = s_recs[r];
    const int* docs = reinterpret_cast<const int*>(rec.p0);
    const float* tfs = reinterpret_cast<const float*>(rec.p1);
    const float* dls = reinterpret_cast<const float*>(rec.p2);
    const long long W = rec.width;
    for (int s = rec.lo; s < rec.hi; ++s) {
      const int row = s_rows[s];
      if (row < 0 || row >= rec.n_rows) continue;  // the same for every thread
      const float idf = s_idfs[s];
      const long long base = (long long)row * W;
      for (long long i = threadIdx.x; i < W; i += THREADS) {
        const int d = docs[base + i];
        if (d < 0) continue;
        const long long g = (long long)d + rec.start;
        if (g < c_lo || g >= c_hi) continue;
        const float w = bm25_w(idf, tfs[base + i], bm25_x(dls[base + i], avgdl));
        score[g] = __fadd_rn(score[g], w);
        if (cnt) cnt[g] = __fadd_rn(cnt[g], 1.0f);
      }
      __syncthreads();  // the next slot's adds come after this one's
    }
  }
  __syncthreads();

  // phase C: the dense blocks and the epilogue, a column at a time
  const float required = params[q * 3 + 1];
  const float req1 = required < 1.0f ? 1.0f : required;  // clamp_min(1.0), NaN kept
  const float min_score = params[q * 3 + 2];
  const uint8_t* qmask = mask + (long long)q * mask_stride;
  uint8_t* qmatched = matched ? matched + (long long)q * L : nullptr;
  long long n_matched = 0, n_kept = 0;
  for (long long c = c_lo + threadIdx.x; c < c_hi; c += THREADS) {
    float s = score[c];
    float n = cnt ? cnt[c] : 0.0f;
    for (int r = 0; r < n_dense; ++r) {
      const Rec& rec = s_recs[n_post + r];
      const long long local = c - rec.start;
      if (local < 0 || local >= rec.width) continue;
      const uint8_t* block = reinterpret_cast<const uint8_t*>(rec.p0);
      const float x = bm25_x(reinterpret_cast<const float*>(rec.p1)[local], avgdl);
      float acc = 0.0f, acc_n = 0.0f;
      for (int j = rec.lo; j < rec.hi; ++j) {
        const int row = s_rows[j];
        if (row < 0 || row >= rec.n_rows) continue;
        const float tf = (float)block[(long long)row * rec.width + local];
        if (!(tf > 0.0f)) continue;
        const float w = bm25_w(s_idfs[j], tf, x);
        if (rec.kind == 2) {
          s = __fadd_rn(s, w);
          n = __fadd_rn(n, 1.0f);
        } else {
          acc = __fadd_rn(acc, w);
          acc_n = __fadd_rn(acc_n, 1.0f);
        }
      }
      if (rec.kind != 2) {
        s = __fadd_rn(s, acc);
        n = __fadd_rn(n, acc_n);
      }
    }
    const bool m = (cnt ? n >= req1 : s > 0.0f) && qmask[c] != 0;
    const float fin = (m && s >= min_score) ? s : NEG_INF;
    score[c] = fin;
    if (cnt) cnt[c] = n;
    if (qmatched) qmatched[c] = m ? 1 : 0;
    n_matched += m ? 1 : 0;
    if (cut_s && fin > HALF_NEG_INF) {
      ++n_kept;
      hist_add(s_hist, order_key(fin) >> (32 - DIGIT_BITS));
    }
  }

  if (match_part) {
    const long long total = block_sum(n_matched, s_red);
    if (threadIdx.x == 0) match_part[(long long)q * gridDim.x + blockIdx.x] = total;
  }
  if (!cut_s) return;

  // phase D: the block's cut. The k best kept entries are those whose key
  // beats kth, and the `want` lowest columns among those whose key is kth.
  const long long kept = block_sum(n_kept, s_red);  // also orders phase C's hist and rows before phase D
  const bool take_all = kept <= k;
  unsigned kth = 0;
  long long col_lim = c_hi;  // local columns below it (<=) of key kth are taken
  if (!take_all) {
    unsigned prefix = 0, pmask = 0, want = (unsigned)k;
    for (int hi_bit = 32; hi_bit > 0;) {
      const int shift = hi_bit > DIGIT_BITS ? hi_bit - DIGIT_BITS : 0;
      const unsigned dmask = (1u << (hi_bit - shift)) - 1u;
      if (hi_bit < 32) {  // the first digit was counted in phase C
        for (long long c = c_lo + threadIdx.x; c < c_hi; c += THREADS) {
          const float v = score[c];
          if (!(v > HALF_NEG_INF)) continue;
          const unsigned key = order_key(v);
          if ((key & pmask) == prefix) hist_add(s_hist, (key >> shift) & dmask);
        }
        __syncthreads();
      }
      find_bin(s_hist, want, true, &s_bin, &s_before);
      __syncthreads();
      want -= s_before;
      prefix |= (unsigned)s_bin << shift;
      pmask |= dmask << shift;
      hi_bit = shift;
      const unsigned n_eq = s_hist[s_bin];
      __syncthreads();  // every thread has read the bin before the counts are cleared
      for (int i = threadIdx.x; i < BINS; i += THREADS) s_hist[i] = 0;
      __syncthreads();
      if (hi_bit == 0 && n_eq > want) {
        // more columns hold the k-th score than the cut keeps: the lowest
        // `want` of them, by a select of the want-th smallest local column
        const long long span = c_hi - c_lo;
        int bits = 1;
        while ((1ll << bits) < span) ++bits;
        unsigned cprefix = 0, cmask = 0;
        for (int cb = bits; cb > 0;) {
          const int cs = cb > DIGIT_BITS ? cb - DIGIT_BITS : 0;
          const unsigned cd = (1u << (cb - cs)) - 1u;
          for (long long c = c_lo + threadIdx.x; c < c_hi; c += THREADS) {
            const float v = score[c];
            if (!(v > HALF_NEG_INF) || order_key(v) != prefix) continue;
            const unsigned local = (unsigned)(c - c_lo);
            if ((local & cmask) == cprefix) hist_add(s_hist, (local >> cs) & cd);
          }
          __syncthreads();
          find_bin(s_hist, want, false, &s_bin, &s_before);
          __syncthreads();
          want -= s_before;
          cprefix |= (unsigned)s_bin << cs;
          cmask |= cd << cs;
          cb = cs;
          __syncthreads();
          for (int i = threadIdx.x; i < BINS; i += THREADS) s_hist[i] = 0;
          __syncthreads();
        }
        col_lim = c_lo + cprefix;
      }
    }
    kth = prefix;
  }
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  for (long long c = c_lo + threadIdx.x; c < c_hi; c += THREADS) {
    const float v = score[c];
    if (!(v > HALF_NEG_INF)) continue;
    const unsigned key = order_key(v);
    if (take_all || key > kth || (key == kth && c <= col_lim)) {
      const unsigned pos = atomicAdd(&s_n, 1u);
      s_cand_s[pos] = v;
      s_cand_c[pos] = (int)(c - c_lo);
    }
  }
  __syncthreads();
  const int n_cand = (int)s_n;
  float* out_s = cut_s + ((long long)q * gridDim.x + blockIdx.x) * k;
  long long* out_i = cut_i + ((long long)q * gridDim.x + blockIdx.x) * k;
  for (int i = threadIdx.x; i < n_cand; i += THREADS) {
    const float v = s_cand_s[i];
    const int c = s_cand_c[i];
    int rank = 0;
    for (int j = 0; j < n_cand; ++j) {
      const float u = s_cand_s[j];
      rank += (u > v || (u == v && s_cand_c[j] < c)) ? 1 : 0;
    }
    out_s[rank] = v;
    out_i[rank] = c_lo + c;
  }
  for (int i = n_cand + threadIdx.x; i < k; i += THREADS) {
    out_s[i] = NEG_INF;
    out_i[i] = -1;
  }
}

}  // namespace

// Returns 0, or the CUDA error of the launch. ``recs`` is a host array of
// n_recs records, the n_post posting records first, copied into the launch's
// parameter; ``chunk`` is the columns a block owns (the grid is ceil(L /
// chunk) x Q); ``cut_s``/``cut_i`` (with 1 <= k <= KMAX) or null (k = 0).
extern "C" int bm25_program(
    const void* recs, int n_recs, int n_post,
    const void* rows, const void* idfs, int S, const void* params,
    const void* mask, long long mask_stride,
    void* final_, void* counts, void* matched, void* match_part,
    void* cut_s, void* cut_i, int k,
    long long L, long long chunk, int Q, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)n_recs * sizeof(Rec) + (size_t)S * (sizeof(int) + sizeof(float));
  if (n_recs > MAX_RECS || smem > MAX_SMEM || k < 0 || k > KMAX || (k > 0) != (cut_s != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Table tab;
  memset(&tab, 0, sizeof(tab));
  memcpy(tab.recs, recs, (size_t)n_recs * sizeof(Rec));
  if (smem > 48 * 1024) {
    // always the same value: threads launching at once with other table
    // sizes never lower the limit under another's launch
    cudaError_t err = cudaFuncSetAttribute(
        bm25_program_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned n_chunks = (unsigned)((L + chunk - 1) / chunk);
  dim3 grid(n_chunks, (unsigned)Q);
  bm25_program_kernel<<<grid, THREADS, smem, st>>>(
      tab, n_post, n_recs - n_post,
      static_cast<const int*>(rows), static_cast<const float*>(idfs), S,
      static_cast<const float*>(params),
      static_cast<const uint8_t*>(mask), mask_stride,
      static_cast<float*>(final_), static_cast<float*>(counts),
      static_cast<uint8_t*>(matched), static_cast<long long*>(match_part),
      static_cast<float*>(cut_s), static_cast<long long*>(cut_i), k,
      L, chunk);
  return (int)cudaGetLastError();
}
