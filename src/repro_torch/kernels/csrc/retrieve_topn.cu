// The routing path's retrieve stage for Hopper (sm_90a): the top-n DB rows
// of each query by cosine similarity among the live rows, in two kernels,
// the TPU kernel's own shape:
//   kernel 1 (`panel_gemm_kernel`, `panel_gemv_kernel`) writes the masked
//   (Q, C) score panel, rows at or past the live-row count at -inf;
//   kernel 2 (`topn_select_kernel`) selects each row's top-k exactly, and
//   also merges the shards' candidates (a pool of explicit rows) on the
//   capacity-sharded route.
// Kernel 2 also writes the winners' records, in the replay's layout. With
// no live-row count, kernel 1 is the plain similarity panel
// (`similarity_topk.similarity_cuda`, the legacy `VectorDB.query`).
//
// Replaces, with the replay kernel (elo_scan.cu), the TPU kernel
// `similarity_pallas` (src/repro/kernels/similarity_topk.py:42) on the
// routing path together with the `lax.top_k` that follows it in
// `retrieve_replay_pipeline` (src/repro/kernels/retrieve_replay.py:29,
// :50), and the per-shard reduce and cross-shard merge of
// `sharded_retrieve_replay_select_pallas` (retrieve_replay.py:75, through
// similarity_topk.py:shard_local_topk / shard_merge_topk).
//
// The order. Every candidate carries its global DB row, and candidates are
// ranked by (score descending, global row ascending), scores compared as
// floats (so -0.0 == 0.0). That is a strict total order, so the top-n of a
// union is the top-n of the parts' top-n: merging the shards' top-n gives
// what one stable sort of the whole panel gives, dead -inf rows (global
// row >= *size) in ascending row order included.
//
// Kernel 1 scores each pair with the main loops and the epilogue
// arithmetic of similarity_tile.cuh at the tile `retrieve_topn.tile_for`
// picks by the bucket (the streaming kernel at Q <= 8, else the GEMM of 32,
// 64 or 128 query rows), so a score depends on the tile and on nothing of
// n. The GEMM takes a BM x 128 tile a block; the streaming kernel runs one
// wave of resident blocks, each staging the queries once and walking a
// run of 32-row chunks. Bound: at Q = 1024, C = 32768, D = 1536 the
// product's 1.03e11 fp32 operations (1.54 ms at 67 TFLOP/s); at Q = 8
// reading the 201 MB DB (0.060 ms at 3.35 TB/s). Storing the panel (134 MB
// at bucket 1024) adds 0.04 ms of traffic to the 1.54.
//
// Why no top-n in kernel 1. An earlier design kept a running top-n per
// (query row, column split) in shared memory and merged the splits' lists
// by rounds of a block-wide arg-max. Past n = 128 the lists set the tile
// (a 32-row tile at n = 512), and at n = 20 the panel and the select were
// at or under the lists at every bucket, capacity and shard count timed
// (bucket 1024: 2.48 against 2.66 ms), bit-equal (PERF.md): kernel 1
// keeps nothing of n, at the cost of a panel in memory (134 MB at bucket
// 1024, C = 32768), freed once kernel 2 has read it.
//
// Kernel 2, `topn_select_kernel`: one block per query row.
// Each entry has a 96-bit key that orders like the ranking: the score's
// bits made order-preserving (-0.0 as 0.0 first), the row complemented
// (the lower row ranks first), the position complemented (equal (score,
// row) pairs, a pool's repeated empty slots, go in position order, as a
// stable sort puts them). A radix select over 11-bit digits, most
// significant first, finds the prefix of the k-th largest key: a pass
// counts the digit of the entries that match the digits fixed so far (a
// shared-memory histogram of 2,048 bins), and a block-wide suffix scan
// finds the bin that holds the k-th; the select ends once that bin holds
// exactly the entries still needed (random scores: after two passes;
// exact ties move on to the row's and then the position's digits). Then
// the entries at or above the prefix, exactly k, are gathered, sorted by
// a block-wide bitonic network in shared memory, and written in rank
// order. The row is staged in shared memory on the first pass where it
// fits (C = 32768: 128 KB of scores; rows are the column, `row0` +
// position, for the panel), eight loads a thread in flight (one at a time
// left the staging latency-bound: 0.25-0.28 ms at bucket 1024, k =
// 129-512, against 0.18-0.21), else each pass reads it from L2. Bound:
// reading the input once (bucket 1024: the 134 MB panel, 0.040 ms at 3.35
// TB/s).
#include <math.h>

#include "similarity_tile.cuh"

using namespace simtile;

namespace {

constexpr int EMPTY_ROW = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_N = 512;           // the replay kernel's bound
constexpr int CHUNK = (THREADS / 32) * R;   // DB rows a streaming step

// ---------------------------------------------------------------------------
// kernel 1: the similarity panel (similarity_tile.cuh's main loops) with
// the live-row mask in the epilogue
// ---------------------------------------------------------------------------

// the score of global row g: -inf at or past the live-row count
__device__ __forceinline__ float live(float s, int g, int live_end) {
  return g < live_end ? s : -INFINITY;
}

template <int BM, int BK, bool VEC, bool VEC_OUT>
__global__ void __launch_bounds__(THREADS, 2)
panel_gemm_kernel(const float* __restrict__ q, const float* __restrict__ db,
                  int nq, int c, int d, int offset,
                  const int* __restrict__ size, float* __restrict__ out) {
  using G = Gemm<BM, BK>;
  constexpr int TM = G::TM, TN = 8;
  __shared__ __align__(16) GemmSmem<BM, BK> sm;
  __shared__ float inv_a[BM];
  __shared__ float inv_b[BN];

  const int ty = gemm_ty(threadIdx.x);
  const int tx = gemm_tx(threadIdx.x);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int live_end = size ? *size : EMPTY_ROW;
  float acc[TM][TN];
  gemm_tile<BM, BK, VEC>(q, db, nq, c, d, row0, col0, sm, inv_a, inv_b, acc);

  float ib[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) ib[j] = inv_b[G::col(tx, j)];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = G::row(ty, i);
    const int gr = row0 + r;
    if (gr >= nq) continue;
    const float ia = inv_a[r];
    float* o = out + (size_t)gr * c + col0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cc = G::col(tx, 4 * h);
      const int g = offset + col0 + cc;
      const float4 v = make_float4(
          live(cosine(acc[i][4 * h], ia, ib[4 * h]), g, live_end),
          live(cosine(acc[i][4 * h + 1], ia, ib[4 * h + 1]), g + 1, live_end),
          live(cosine(acc[i][4 * h + 2], ia, ib[4 * h + 2]), g + 2, live_end),
          live(cosine(acc[i][4 * h + 3], ia, ib[4 * h + 3]), g + 3,
               live_end));
      if constexpr (VEC_OUT) {
        if (col0 + cc < c) *reinterpret_cast<float4*>(o + cc) = v;
      } else {
        if (col0 + cc < c) o[cc] = v.x;
        if (col0 + cc + 1 < c) o[cc + 1] = v.y;
        if (col0 + cc + 2 < c) o[cc + 2] = v.z;
        if (col0 + cc + 3 < c) o[cc + 3] = v.w;
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
panel_gemv_kernel(const float* __restrict__ q, const float* __restrict__ db,
                  int nq, int c, int d, int offset,
                  const int* __restrict__ size, int chunks,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) float qs[];   // QT x d, then QT norms
  float* inv_q = qs + QT * d;
  gemv_queries(q, nq, d, qs, inv_q);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int live_end = size ? *size : EMPTY_ROW;
  // lane i * R + r writes (query i, row r) of each of the block's chunks
  const int i = lane / R, r = lane % R;
  const int k1 = min((c + CHUNK - 1) / CHUNK, (blockIdx.x + 1) * chunks);
  for (int k = blockIdx.x * chunks; k < k1; ++k) {
    const int n0 = k * CHUNK + warp * R;
    float dot, inv_row;
    gemv_rows<VEC>(qs, db, c, d, n0, dot, inv_row);
    if (i < nq && n0 + r < c)
      out[(size_t)i * c + n0 + r] =
          live(cosine(dot, inv_q[i], inv_row), offset + n0 + r, live_end);
  }
}

template <int BM>
int launch_panel_gemm(const float* q, const float* db, int nq, int c, int d,
                      int offset, const int* size, float* out, bool vec,
                      bool vec_out, cudaStream_t stream) {
  // the short tile reads 32 columns a chunk, to keep more of the DB in
  // flight; the others 16, within 48 KB of static shared memory
  constexpr int BK = BM == 32 ? 32 : 16;
  const dim3 grid((c + BN - 1) / BN, (nq + BM - 1) / BM);
  auto kernel = vec ? (vec_out ? panel_gemm_kernel<BM, BK, true, true>
                               : panel_gemm_kernel<BM, BK, true, false>)
                    : panel_gemm_kernel<BM, BK, false, false>;
  kernel<<<grid, THREADS, 0, stream>>>(q, db, nq, c, d, offset, size, out);
  return (int)cudaGetLastError();
}

// One wave of resident blocks, each staging the queries once and walking
// an equal run of consecutive chunks (a block a chunk staged the queries
// C / 32 times: 0.198 against 0.160 ms at Q = 8, C = 65536).
int launch_panel_gemv(const float* q, const float* db, int nq, int c, int d,
                      int offset, const int* size, float* out, bool vec,
                      cudaStream_t stream) {
  const size_t bytes = gemv_smem(d);
  auto kernel = vec ? panel_gemv_kernel<true> : panel_gemv_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int dev, sms, per_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, bytes)) != cudaSuccess)
    return (int)err;
  const int units = (c + CHUNK - 1) / CHUNK;
  const int chunks = (units + sms * per_sm - 1) / (sms * per_sm);
  kernel<<<(units + chunks - 1) / chunks, THREADS, bytes, stream>>>(
      q, db, nq, c, d, offset, size, chunks, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// kernel 2
// ---------------------------------------------------------------------------

struct Payload {
  // source: (C_l, R) panels read at row - offset (by_row), or (Q, P, R)
  // records carried by pool position, a query's at ld_src apart
  const int* a;
  const int* b;
  const float* s;
  const unsigned char* v;
  int r, by_row, offset, ld_src;
  // destination: rank order (Q, k, R), or the replay's layout (Q, k R),
  // farthest first, valid &= hit; a query's at ld_dst apart
  int* oa;
  int* ob;
  float* os;
  unsigned char* ov;
  int farthest, ld_dst;
};

// ---------------------------------------------------------------------------
// kernel 2 by selection
// ---------------------------------------------------------------------------

// Winner j of query qr (pool position x, global row `row`, score s), by
// one thread: its score, row and hit, and its records.
__device__ __forceinline__ void write_winner(int qr, int j, int k, int x,
                                             float s, int row, float* top_s,
                                             void* top_i, int idx64,
                                             int ld_out, unsigned char* hit,
                                             const Payload& pay) {
  const bool finite = fabsf(s) < INFINITY;   // false for NaN
  top_s[(size_t)qr * ld_out + j] = s;
  if (idx64)
    reinterpret_cast<long long*>(top_i)[(size_t)qr * ld_out + j] = row;
  else
    reinterpret_cast<int*>(top_i)[(size_t)qr * ld_out + j] = row;
  if (hit) hit[(size_t)qr * k + j] = finite;
  if (!pay.a) return;
  const size_t src = pay.by_row ? (size_t)(row - pay.offset) * pay.r
                                : (size_t)qr * pay.ld_src + (size_t)x * pay.r;
  const size_t dst = (size_t)qr * pay.ld_dst +
                     (size_t)(pay.farthest ? k - 1 - j : j) * pay.r;
  for (int y = 0; y < pay.r; ++y) {
    pay.oa[dst + y] = pay.a[src + y];
    pay.ob[dst + y] = pay.b[src + y];
    pay.os[dst + y] = pay.s[src + y];
    pay.ov[dst + y] = pay.v[src + y] && (!pay.farthest || finite);
  }
}

constexpr int SEL_BINS = 2048;            // an 11-bit digit
constexpr int SEL_THREADS = 1024;         // the most a block takes
constexpr int SEL_BATCH = 8;              // loads a thread issues at once

// a score's order-preserving bits: -0.0 taken as 0.0, then the negative
// floats reversed, so that the unsigned order is the float order
__device__ __forceinline__ unsigned score_word(float s) {
  unsigned b = __float_as_uint(s);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// a row's word: the lower row ranks first (with TOPN_CONTROL_TIE_HIGH, a
// control built only by the checks, the higher)
__device__ __forceinline__ unsigned row_word(int row) {
#ifdef TOPN_CONTROL_TIE_HIGH
  return (unsigned)row;
#else
  return ~(unsigned)row;
#endif
}

// digit d of a word, most significant first: bits 21-31, 10-20, 0-9
__device__ __forceinline__ int digit_shift(int d) {
  return d == 0 ? 21 : d == 1 ? 10 : 0;
}
__device__ __forceinline__ unsigned digit_mask(int d) {
  return d == 2 ? 0x3ffu : 0x7ffu;
}

// A query's row of entries: scores (staged or in place) and global rows
// (the same, or NULL: row0 + position, the panel's columns). An entry's
// key is three words: score_word, row_word, then ~position.
struct Entries {
  const float* s;
  const int* i;
  int row0;
  __device__ __forceinline__ int row(int x) const {
    return i ? i[x] : row0 + x;
  }
};

// the select's state: the digits fixed so far (prefix under mask, a word
// each), the entries still needed at that prefix, a pass's decision
struct Select {
  unsigned prefix[3], mask[3];
  int need, digit, above, bucket, done, count;
  int warp_sum[SEL_THREADS / 32];
};

// After a pass's histogram of digit d of word w: the bin that holds the
// need-th largest entry (a suffix scan of the bins, each thread taking
// SEL_BINS / blockDim.x of them from the top), fixed in the prefix; done
// once that bin holds exactly the entries still needed. Ends with a
// barrier.
__device__ void fix_digit(const int* hist, Select& st, int w, int d) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int per = SEL_BINS / blockDim.x;
  const int top = SEL_BINS - 1 - tid * per;
  int local = 0;
  for (int j = 0; j < per; ++j) local += hist[top - j];
  int incl = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) st.warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < (int)blockDim.x / 32 ? st.warp_sum[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(FULL, v, off);
      if (lane >= off) v += u;
    }
    if (lane < (int)blockDim.x / 32) st.warp_sum[lane] = v;
  }
  __syncthreads();
  const int need = st.need;
  int acc = (warp ? st.warp_sum[warp - 1] : 0) + incl - local;
  if (acc < need && acc + local >= need) {
    for (int j = 0; j < per; ++j) {
      const int c = hist[top - j];
      if (acc + c >= need) {
        st.digit = top - j;
        st.above = acc;
        st.bucket = c;
        break;
      }
      acc += c;
    }
  }
  __syncthreads();
  if (tid == 0) {
    st.prefix[w] |= (unsigned)st.digit << digit_shift(d);
    st.mask[w] |= digit_mask(d) << digit_shift(d);
    st.need -= st.above;
    st.done = st.bucket == st.need;
  }
  __syncthreads();
}

// Shared memory: the survivors' keys and positions (kpad each, kpad a
// power of two >= k), the histogram, then the staged scores and rows.
__global__ void __launch_bounds__(SEL_THREADS)
topn_select_kernel(const float* __restrict__ pool_s,
                   const int* __restrict__ pool_i, int p, int ld_in,
                   int row0, int staged, int k, int kpad, float* top_s,
                   void* top_i, int idx64, int ld_out, unsigned char* hit,
                   Payload pay) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Select st;
  auto* sk = reinterpret_cast<unsigned long long*>(smem);
  int* sx = reinterpret_cast<int*>(sk + kpad);
  int* hist = sx + kpad;
  float* ss = reinterpret_cast<float*>(hist + SEL_BINS);
  int* si = reinterpret_cast<int*>(ss + p);
  const int qr = blockIdx.x, tid = threadIdx.x, threads = blockDim.x;

  Entries e{pool_s + (size_t)qr * ld_in,
            pool_i ? pool_i + (size_t)qr * ld_in : nullptr, row0};
  for (int b = tid; b < SEL_BINS; b += threads) hist[b] = 0;
  if (tid == 0) {
    for (int w = 0; w < 3; ++w) st.prefix[w] = st.mask[w] = 0u;
    st.need = k;
    st.count = 0;
  }
  __syncthreads();
  // the first pass (the score's top digit) stages the row on its way, a
  // batch of SEL_BATCH loads a thread in flight before their atomics
  for (int x0 = tid; x0 < p; x0 += SEL_BATCH * threads) {
    float s[SEL_BATCH];
#pragma unroll
    for (int u = 0; u < SEL_BATCH; ++u) {
      const int x = x0 + u * threads;
      s[u] = x < p ? e.s[x] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < SEL_BATCH; ++u) {
      const int x = x0 + u * threads;
      if (x >= p) break;
      if (staged) {
        ss[x] = s[u];
        if (e.i) si[x] = e.i[x];
      }
      atomicAdd(&hist[score_word(s[u]) >> 21], 1);
    }
  }
  if (staged) {
    e.s = ss;
    if (e.i) e.i = si;
  }
  __syncthreads();
  fix_digit(hist, st, 0, 0);
  for (int pass = 1; pass < 9 && !st.done; ++pass) {
    const int w = pass / 3, d = pass % 3;
    const unsigned p0 = st.prefix[0], p1 = st.prefix[1], p2 = st.prefix[2];
    const unsigned m0 = st.mask[0], m1 = st.mask[1], m2 = st.mask[2];
    const int shift = digit_shift(d);
    const unsigned dmask = digit_mask(d);
    for (int b = tid; b < SEL_BINS; b += threads) hist[b] = 0;
    __syncthreads();
    for (int x = tid; x < p; x += threads) {
      const unsigned w0 = score_word(e.s[x]);
      if ((w0 & m0) != p0) continue;
      unsigned word = w0;
      if (w >= 1) {
        word = row_word(e.row(x));
        if ((word & m1) != p1) continue;
        if (w == 2) {
          word = ~(unsigned)x;
          if ((word & m2) != p2) continue;
        }
      }
      atomicAdd(&hist[(word >> shift) & dmask], 1);
    }
    __syncthreads();
    fix_digit(hist, st, w, d);
  }

  // the k entries at or above the prefix, in any order, then the padding
  {
    const unsigned p0 = st.prefix[0], p1 = st.prefix[1], p2 = st.prefix[2];
    const unsigned m0 = st.mask[0], m1 = st.mask[1], m2 = st.mask[2];
    for (int x = tid; x < p; x += threads) {
      const unsigned w0 = score_word(e.s[x]);
      const unsigned a0 = w0 & m0;
      bool take = a0 > p0;
      if (!take && a0 == p0) {
        const unsigned a1 = row_word(e.row(x)) & m1;
        take = a1 > p1 || (a1 == p1 && (~(unsigned)x & m2) >= p2);
      }
      if (take) {
        const int slot = atomicAdd(&st.count, 1);
        if (slot < k) {
          sk[slot] = (unsigned long long)w0 << 32 | row_word(e.row(x));
          sx[slot] = x;
        }
      }
    }
    for (int j = k + tid; j < kpad; j += threads) {
      sk[j] = 0ull;
      sx[j] = EMPTY_ROW;
    }
  }
  // bitonic sort: key descending, then position ascending
  for (int size = 2; size <= kpad; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int i = tid; i < kpad / 2; i += threads) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const unsigned long long kl = sk[lo], kh = sk[hi];
        const int xl = sx[lo], xh = sx[hi];
        const bool hi_first = kh > kl || (kh == kl && xh < xl);
        if (((lo & size) == 0) == hi_first) {   // a best-first run
          sk[lo] = kh;
          sk[hi] = kl;
          sx[lo] = xh;
          sx[hi] = xl;
        }
      }
    }
  __syncthreads();
  for (int j = tid; j < k; j += threads) {
    const int x = sx[j];
    write_winner(qr, j, k, x, e.s[x], e.row(x), top_s, top_i, idx64, ld_out,
                 hit, pay);
  }
}

}  // namespace

// Kernel 1. q (nq, d), emb (c, d) fp32; its rows are global rows offset..;
// size: device pointer to the live-row count (global; NULL: every row
// live, the plain similarity panel). Writes the (nq, c) score panel `out`,
// rows past the live-row count at -inf, scored at `tile` (8 streaming,
// 32, 64, 128 GEMM).
extern "C" int retrieve_panel_launch(const float* q, const float* emb, int nq,
                                     int c, int d, int offset,
                                     const int* size, int tile, float* out,
                                     cudaStream_t stream) {
  const bool vec = d % 4 == 0 && aligned16(q) && aligned16(emb);
  const bool vec_out = c % 4 == 0 && aligned16(out);
  switch (tile) {
    case 8:
      if (nq > QT || gemv_smem(d) > MAX_SMEM)
        return (int)cudaErrorInvalidValue;
      return launch_panel_gemv(q, emb, nq, c, d, offset, size, out, vec,
                               stream);
    case 32:
      return launch_panel_gemm<32>(q, emb, nq, c, d, offset, size, out, vec,
                                   vec_out, stream);
    case 64:
      return launch_panel_gemm<64>(q, emb, nq, c, d, offset, size, out, vec,
                                   vec_out, stream);
    case 128:
      return launch_panel_gemm<128>(q, emb, nq, c, d, offset, size, out, vec,
                                    vec_out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Kernel 2. The top k of each row of the (nq, p) pool (rows ld_in apart)
// into top_s and top_i (int64 if idx64, else int32; rows ld_out apart)
// and, if hit is not NULL, hit (nq, k). pool_i NULL: the pool is a panel,
// entry x of global row row0 + x. Records: if ra is not NULL, each
// winner's r records of (ra, rb, rs, rv) -- by_row: the (C_l, r) panels at
// row - offset; else (nq, p, r) by pool position, rows ld_src apart --
// into (oa, ob, os, ov): rank order, or with `farthest` the replay's
// layout (farthest first, valid &= hit); rows ld_dst apart.
extern "C" int topn_merge_launch(
    const float* pool_s, const int* pool_i, int nq, int p, int ld_in,
    int row0, int k, float* top_s, void* top_i, int idx64, int ld_out,
    unsigned char* hit, const int* ra, const int* rb, const float* rs,
    const unsigned char* rv, int r, int by_row, int offset, int ld_src,
    int* oa, int* ob, float* os, unsigned char* ov, int farthest, int ld_dst,
    cudaStream_t stream) {
  if (k < 1 || k > p || k > MAX_N) return (int)cudaErrorInvalidValue;
  Payload pay{ra, rb, rs, rv, r, by_row, offset, ld_src,
              oa, ob, os, ov, farthest, ld_dst};
  int kpad = 32;
  while (kpad < k) kpad <<= 1;
  const size_t fixed = (size_t)kpad * (sizeof(long long) + sizeof(int)) +
                       SEL_BINS * sizeof(int);
  const size_t row = (size_t)p * (pool_i ? 2 : 1) * sizeof(float);
  const int staged = fixed + row + sizeof(Select) <= MAX_SMEM;
  const size_t bytes = fixed + (staged ? row : 0);
  cudaError_t err = cudaFuncSetAttribute(
      topn_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // 1,024 threads where the row is staged whole (one block an SM); 512
  // down to 2,048 entries (two blocks an SM: S = 4, n = 512 took 3.62 ms
  // against 3.79 with 1,024 at a shard's 8,192)
  const int threads = p >= 16384 ? 1024 : p >= 2048 ? 512 : 256;
  topn_select_kernel<<<nq, threads, bytes, stream>>>(
      pool_s, pool_i, p, ld_in, row0, staged, k, kpad, top_s, top_i, idx64,
      ld_out, hit, pay);
  return (int)cudaGetLastError();
}
