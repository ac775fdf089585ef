// The routing path's retrieve stage for Hopper (sm_90a): the top-n DB rows
// of each query by cosine similarity among the live rows. Two kernels a
// retrieve, on one of two routes that `retrieve_topn.py:plan` picks from
// the shape (Q, C, D, n) alone:
//
// the list route (n <= 128 where its grid fills the card):
//   `retrieve_topn` (kernel 1): similarity + live-row mask + a running
//   top-n per (query row, column split), written as a small candidate
//   pool, no (Q, C) panel;
//   `topn_merge` (kernel 2): the top-k of each query's pool by rounds.
// the panel route (n > 128, or a list grid smaller than the card):
//   kernel 1 writes the masked (Q, C) score panel;
//   kernel 2 selects each row's top-k exactly (`topn_select_kernel`), as
//   it does for a pool past k = 128 (the cross-shard merge at n > 128).
// Kernel 2 also writes the winners' records, in the replay's layout.
//
// Replaces, with the replay kernel (elo_scan.cu), the TPU kernel
// `similarity_pallas` (src/repro/kernels/similarity_topk.py:42) on the
// routing path together with the `lax.top_k` that follows it in
// `retrieve_replay_pipeline` (src/repro/kernels/retrieve_replay.py:29,
// :50), and the per-shard reduce and cross-shard merge of
// `sharded_retrieve_replay_select_pallas` (retrieve_replay.py:75, through
// similarity_topk.py:shard_local_topk / shard_merge_topk). The panel
// route is the TPU kernel's own shape: the panel, then `lax.top_k`.
//
// The order. Every candidate carries its global DB row, and candidates are
// ranked by (score descending, global row ascending), scores compared as
// floats (so -0.0 == 0.0). That is a strict total order, so the top-n of a
// union is the top-n of the parts' top-n: splitting the columns, then
// merging the splits' (or the shards') lists gives what one stable sort of
// the whole panel gives, dead -inf rows (global row >= *size) in
// ascending row order included. A pool slot no candidate filled holds
// (-inf, EMPTY_ROW), after every real candidate; a pool always holds at
// least min(n, C) real ones, so an empty slot is never taken.
//
// Kernel 1 scores each pair with the main loops and the epilogue
// arithmetic of similarity.cu (similarity_tile.cuh), tile for tile, so
// its scores are bit-equal to the panel's at the same tile. Bound: as
// similarity's: at Q = 1024, C = 32768, D = 1536 the product's 1.03e11
// fp32 operations (1.54 ms at 67 TFLOP/s); at Q = 8 reading the 201 MB
// DB (0.060 ms at 3.35 TB/s). The list route's pool is 0.3% of the
// panel; the panel route stores the panel (134 MB at bucket 1024, 0.04
// ms of the 1.54).
//
// The list route, Q > 8, `topn_gemm_kernel<BM>` (BM = 32, 64, 128 by the
// bucket, as similarity_launch_tile picks): a block owns BM query rows and
// one split of `tiles` consecutive 128-column tiles, walked in ascending
// order; the caller sizes the splits so that about two blocks an SM run
// (bucket 1024: 8 row blocks x 32 splits of 8 tiles). After each tile's
// main loop the BM x 128 scores go to shared memory over the freed
// staging buffers (64 KB at BM = 128); then each warp takes rows and
// offers their 128 scores to the row's list: one ballot against the
// list's n-th entry filters the whole batch, and each candidate that
// passes is inserted into the list held in the warp's registers (entry k
// in lane k % 32): its rank by a ballot, the shift by one shuffle. The
// lists (BM x n entries of 8 B) live in shared memory between tiles: 85
// KB a block at BM = 128, n = 20; two blocks an SM up to n ~ 45, one
// above. The merge is a call at BM = 128 and inlined below (see
// `merge`). Pool: splits x n candidates a query (640 at bucket 1024, n =
// 20).
//
// The list route, Q <= 8, `topn_gemv_kernel`: the streaming kernel, a
// block walking `chunks` consecutive 32-row chunks (8 warps x 4 rows);
// warp w keeps query w's list in its registers across the chunks and
// takes the chunk's 32 scores of its query at a barrier. Splits: about
// two blocks an SM (C = 32768: 256 splits of 4 chunks). Pool: splits x n
// a query (5,120 at n = 20).
//
// Why a second route. Past n = 128 the lists set the tile: BM x n x 8 B
// of lists forced a 32-row tile at n = 512 (the DB read once per 32
// query rows, one block an SM), splits of ~600 rows each keeping 512 of
// them (so nearly every score went through a list merge), and a merge of
// the pool's sorted runs by one warp (k dependent rounds): 11.0 ms for
// the pair at bucket 1024, n = 512, against 2.9 for normalize + matmul +
// torch.topk. And a grid smaller than the card (KNN's Q = 84, C = 1,470:
// 12 blocks) filled each list from empty, one insertion a score. The
// panel route keeps nothing of n in kernel 1 (`panel_gemm_kernel<BM>`,
// `panel_gemv_kernel`: similarity.cu's kernels with the live-row mask in
// the epilogue, at similarity's tile) and selects in kernel 2.
//
// Kernel 2 by rounds, `topn_merge_kernel`: one block per query, the pool
// row staged in shared memory (read in place where it does not fit), then
// k <= 128 rounds of a block-wide arg-max over the candidates after the
// last winner in the order. The rounds touch P / threads entries each and
// yield the winners already in rank order, which the payload write needs.
// Bound: reading the pool (bucket 1024: 5 MB, 1.6 us); a round costs one
// barrier.
//
// Kernel 2 by selection, `topn_select_kernel`: one block per query row.
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
// a block-wide bitonic network in shared memory, and written as the
// rounds kernel writes them. The row is staged in shared memory on the
// first pass where it fits (C = 32768: 128 KB of scores; rows are the
// column, `row0` + position, for the panel), eight loads a thread in
// flight (one at a time left the staging latency-bound: 0.25-0.28 ms at
// bucket 1024, k = 129-512, against 0.18-0.21), else each pass reads it
// from L2. Bound: reading the input once (bucket 1024: the 134 MB panel,
// 0.040 ms at 3.35 TB/s).
#include <math.h>

#include "similarity_tile.cuh"

using namespace simtile;

namespace {

constexpr int EMPTY_ROW = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_N = 512;           // the replay kernel's bound
constexpr int LIST_N = 128;          // four list entries a lane
constexpr int ROUNDS_K = 128;        // kernel 2 by rounds up to this k
constexpr int CHUNK = (THREADS / 32) * R;   // DB rows a streaming step

// (as, ai) ranks before (bs, bi): score descending, then row ascending
__device__ __forceinline__ bool before(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai < bi);
}

// kernel 1's order: the true one, or with TOPN_CONTROL_TIE_HIGH (a
// control built only by the tests) ties to the higher real row
__device__ __forceinline__ bool before_k1(float as, int ai, float bs,
                                          int bi) {
#ifdef TOPN_CONTROL_TIE_HIGH
  return as > bs || (as == bs && ai != EMPTY_ROW &&
                     (bi == EMPTY_ROW || ai > bi));
#else
  return before(as, ai, bs, bi);
#endif
}

// ---------------------------------------------------------------------------
// a warp's sorted list of n <= 128 NE entries (NE = 1, 2 or 4): entry k
// in lane k % 32, slot k / 32
// ---------------------------------------------------------------------------

template <int NE>
__device__ __forceinline__ void list_clear(float (&s)[NE], int (&ix)[NE]) {
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    s[e] = -INFINITY;
    ix[e] = EMPTY_ROW;
  }
}

// the list's n-th entry, in every lane
template <int NE>
__device__ __forceinline__ void list_last(const float (&s)[NE],
                                          const int (&ix)[NE], int n,
                                          float& ts, int& ti) {
  const int last = (n - 1) / 32;
  float v = s[0];
  int w = ix[0];
#pragma unroll
  for (int e = 1; e < NE; ++e)
    if (e == last) {
      v = s[e];
      w = ix[e];
    }
  ts = __shfl_sync(FULL, v, (n - 1) & 31);
  ti = __shfl_sync(FULL, w, (n - 1) & 31);
}

// insert (cs, cg), which ranks before the n-th entry
template <int NE>
__device__ __forceinline__ void list_insert(float (&s)[NE], int (&ix)[NE],
                                            float cs, int cg, int n,
                                            int lane) {
  int pos = 0;
#pragma unroll
  for (int e = 0; e < NE; ++e)
    pos += __popc(__ballot_sync(
        FULL, e * 32 + lane < n && before_k1(s[e], ix[e], cs, cg)));
  float us[NE];
  int ui[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    us[e] = __shfl_up_sync(FULL, s[e], 1);
    ui[e] = __shfl_up_sync(FULL, ix[e], 1);
  }
  // lane 0 of slot e takes lane 31 of slot e - 1
#pragma unroll
  for (int e = 1; e < NE; ++e) {
    const float ws = __shfl_sync(FULL, s[e - 1], 31);
    const int wi = __shfl_sync(FULL, ix[e - 1], 31);
    if (lane == 0) {
      us[e] = ws;
      ui[e] = wi;
    }
  }
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int k = e * 32 + lane;
    if (k > pos) {
      s[e] = us[e];
      ix[e] = ui[e];
    } else if (k == pos) {
      s[e] = cs;
      ix[e] = cg;
    }
  }
}

// Offer a batch of one candidate a lane (valid ones only), in lane order;
// (ts, ti) is the list's n-th entry before and after.
template <int NE>
__device__ __forceinline__ void list_offer(float (&s)[NE], int (&ix)[NE],
                                           float& ts, int& ti, float cs,
                                           int cg, bool valid, int n,
                                           int lane) {
  unsigned mask = __ballot_sync(FULL, valid && before_k1(cs, cg, ts, ti));
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const float bs = __shfl_sync(FULL, cs, src);
    const int bg = __shfl_sync(FULL, cg, src);
    if (!before_k1(bs, bg, ts, ti)) continue;   // the list moved past it
    list_insert<NE>(s, ix, bs, bg, n, lane);
    list_last<NE>(s, ix, n, ts, ti);
  }
}

// ---------------------------------------------------------------------------
// the list route's kernel 1, Q > 8
// ---------------------------------------------------------------------------

template <int BM, int BK>
struct TopnSmem {
  static constexpr size_t TILE = (size_t)BM * BN * sizeof(float);
  static constexpr size_t STAGE = sizeof(GemmSmem<BM, BK>);
  static constexpr size_t UNION = TILE > STAGE ? TILE : STAGE;
  static constexpr size_t bytes(int n) {
    return UNION + (BM + BN) * sizeof(float) +
           (size_t)BM * n * (sizeof(float) + sizeof(int));
  }
};

// One row's 128 tile scores (`cols` of them real columns, global rows
// from g0; rows from live_end are dead) offered to its list ls / li in
// shared memory. The warp loads the list into registers only if one
// score passes the n-th entry.
template <int NE>
__device__ __forceinline__ void merge_row(float* ls, int* li, int n,
                                          const float* trow, int cols,
                                          int g0, int live_end, int lane) {
  float ts = ls[n - 1];
  int ti = li[n - 1];
  float cs[BN / 32];
  int cg[BN / 32];
  bool any = false;
#pragma unroll
  for (int k = 0; k < BN / 32; ++k) {
    const int c = lane + 32 * k;
    cg[k] = g0 + c;
    cs[k] = cg[k] < live_end ? trow[c] : -INFINITY;
    any |= __any_sync(FULL, c < cols && before_k1(cs[k], cg[k], ts, ti));
  }
  if (!any) return;
  float s[NE];
  int ix[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int k = e * 32 + lane;
    s[e] = k < n ? ls[k] : -INFINITY;
    ix[e] = k < n ? li[k] : EMPTY_ROW;
  }
#pragma unroll
  for (int k = 0; k < BN / 32; ++k)
    list_offer<NE>(s, ix, ts, ti, cs[k], cg[k], lane + 32 * k < cols, n,
                   lane);
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int k = e * 32 + lane;
    if (k < n) {
      ls[k] = s[e];
      li[k] = ix[e];
    }
  }
}

// The tile's `rows` rows of scores (BN apart in `tile`) offered to their
// lists, a warp a row at a time.
template <int NE>
__device__ __forceinline__ void merge_tile(float* ls, int* li, int n,
                                           const float* tile, int rows,
                                           int cols, int g0, int live_end) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += THREADS / 32)
    merge_row<NE>(ls + r * n, li + r * n, n, tile + r * BN, cols, g0,
                  live_end, lane);
}

template <int NE>
__device__ __noinline__ void merge_tile_call(float* ls, int* li, int n,
                                             const float* tile, int rows,
                                             int cols, int g0,
                                             int live_end) {
  merge_tile<NE>(ls, li, n, tile, rows, cols, g0, live_end);
}

// The merge after a tile's main loop: a call at BM = 128 (8 tiles a block
// at bucket 1024; a call keeps the merge's code apart from the tile loop's,
// 2.60-2.62 ms against 2.66-2.68 inlined), inlined at BM = 32 and 64 (one
// tile a block; the call costs 7% there). scripts/retrieve_topn_variants.py
// times both.
template <int BM, int NE>
__device__ __forceinline__ void merge(float* ls, int* li, int n,
                                      const float* tile, int rows, int cols,
                                      int g0, int live_end) {
  if constexpr (BM == 128)
    merge_tile_call<NE>(ls, li, n, tile, rows, cols, g0, live_end);
  else
    merge_tile<NE>(ls, li, n, tile, rows, cols, g0, live_end);
}

template <int BM, int BK, int NE, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
topn_gemm_kernel(const float* __restrict__ q, const float* __restrict__ db,
                 int nq, int c, int d, int offset,
                 const int* __restrict__ size, int n, int tiles,
                 float* __restrict__ pool_s, int* __restrict__ pool_i) {
  using G = Gemm<BM, BK>;
  using S = TopnSmem<BM, BK>;
  extern __shared__ __align__(16) unsigned char smem[];
  auto& sm = *reinterpret_cast<GemmSmem<BM, BK>*>(smem);
  float* tile = reinterpret_cast<float*>(smem);   // BM x BN over `sm`
  float* inv_a = reinterpret_cast<float*>(smem + S::UNION);
  float* inv_b = inv_a + BM;
  float* ls = inv_b + BN;                         // BM x n
  int* li = reinterpret_cast<int*>(ls + BM * n);

  const int tid = threadIdx.x;
  const int ty = gemm_ty(tid), tx = gemm_tx(tid);
  const int row0 = blockIdx.y * BM;
  const int split = blockIdx.x;
  const int t0 = split * tiles;
  const int t1 = min((c + BN - 1) / BN, t0 + tiles);
  const int live_end = size ? *size : EMPTY_ROW;
  for (int k = tid; k < BM * n; k += THREADS) {
    ls[k] = -INFINITY;
    li[k] = EMPTY_ROW;
  }
  // (gemm_tile's barriers publish the cleared lists)

  for (int t = t0; t < t1; ++t) {
    const int col0 = t * BN;
    {
      float acc[G::TM][8];
      gemm_tile<BM, BK, VEC>(q, db, nq, c, d, row0, col0, sm, inv_a, inv_b,
                             acc);
      float ib[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) ib[j] = inv_b[G::col(tx, j)];
#pragma unroll
      for (int i = 0; i < G::TM; ++i) {
        const int r = G::row(ty, i);
        const float ia = inv_a[r];
        float* o = tile + r * BN;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int cc = G::col(tx, 4 * h);
          *reinterpret_cast<float4*>(o + cc) =
              make_float4(cosine(acc[i][4 * h], ia, ib[4 * h]),
                          cosine(acc[i][4 * h + 1], ia, ib[4 * h + 1]),
                          cosine(acc[i][4 * h + 2], ia, ib[4 * h + 2]),
                          cosine(acc[i][4 * h + 3], ia, ib[4 * h + 3]));
        }
      }
    }
    __syncthreads();
    merge<BM, NE>(ls, li, n, tile, min(BM, nq - row0), c - col0,
                  offset + col0, live_end);
    __syncthreads();   // the tile buffer is the next staging's
  }

  const int ld = gridDim.x * n;
  for (int k = tid; k < BM * n; k += THREADS) {
    const int r = k / n;
    if (row0 + r < nq) {
      const size_t o = (size_t)(row0 + r) * ld + split * n + (k - r * n);
      pool_s[o] = ls[k];
      pool_i[o] = li[k];
    }
  }
}

template <int BM, int NE>
int launch_topn_gemm(const float* q, const float* db, int nq, int c, int d,
                     int offset, const int* size, int n, int tiles,
                     int splits, float* pool_s, int* pool_i, bool vec,
                     cudaStream_t stream) {
  constexpr int BK = BM == 32 ? 32 : 16;   // as similarity.cu's tiles
  const size_t bytes = TopnSmem<BM, BK>::bytes(n);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = vec ? topn_gemm_kernel<BM, BK, NE, true>
                    : topn_gemm_kernel<BM, BK, NE, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(splits, (nq + BM - 1) / BM);
  kernel<<<grid, THREADS, bytes, stream>>>(q, db, nq, c, d, offset, size, n,
                                           tiles, pool_s, pool_i);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the list route's kernel 1, Q <= 8
// ---------------------------------------------------------------------------

// the queries, their norms and a step's scores
inline size_t topn_gemv_smem(int d) {
  return gemv_smem(d) + (size_t)QT * CHUNK * sizeof(float);
}

template <bool VEC, int NE>
__global__ void __launch_bounds__(THREADS)
topn_gemv_kernel(const float* __restrict__ q, const float* __restrict__ db,
                 int nq, int c, int d, int offset,
                 const int* __restrict__ size, int n, int chunks,
                 float* __restrict__ pool_s, int* __restrict__ pool_i) {
  static_assert(THREADS / 32 == QT, "a warp per query");
  extern __shared__ __align__(16) float qs[];   // QT x d, QT norms, scores
  float* inv_q = qs + QT * d;
  float* sc = inv_q + QT;                       // QT x CHUNK
  gemv_queries(q, nq, d, qs, inv_q);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int split = blockIdx.x;
  const int k0 = split * chunks;
  const int k1 = min((c + CHUNK - 1) / CHUNK, k0 + chunks);
  const int live_end = size ? *size : EMPTY_ROW;
  float s[NE];
  int ix[NE];
  list_clear<NE>(s, ix);
  float ts = -INFINITY;
  int ti = EMPTY_ROW;
  for (int k = k0; k < k1; ++k) {
    const int n0 = k * CHUNK + warp * R;
    float dot, inv_row;
    gemv_rows<VEC>(qs, db, c, d, n0, dot, inv_row);
    // lane i * R + r holds (query i, row n0 + r)
    const int i = lane / R, r = lane % R;
    sc[i * CHUNK + warp * R + r] = cosine(dot, inv_q[i], inv_row);
    __syncthreads();
    if (warp < nq) {                             // warp w: query w
      const int row = k * CHUNK + lane;
      const int g = offset + row;
      const float v = g < live_end ? sc[warp * CHUNK + lane] : -INFINITY;
      list_offer<NE>(s, ix, ts, ti, v, g, row < c, n, lane);
    }
    __syncthreads();
  }
  if (warp < nq) {
    const size_t o = (size_t)warp * gridDim.x * n + split * n;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int k = e * 32 + lane;
      if (k < n) {
        pool_s[o + k] = s[e];
        pool_i[o + k] = ix[e];
      }
    }
  }
}

template <int NE>
int launch_topn_gemv(const float* q, const float* db, int nq, int c, int d,
                     int offset, const int* size, int n, int chunks,
                     int splits, float* pool_s, int* pool_i, bool vec,
                     cudaStream_t stream) {
  const size_t bytes = topn_gemv_smem(d);
  auto kernel = vec ? topn_gemv_kernel<true, NE> : topn_gemv_kernel<false, NE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<splits, THREADS, bytes, stream>>>(q, db, nq, c, d, offset, size, n,
                                             chunks, pool_s, pool_i);
  return (int)cudaGetLastError();
}

// kernel 1 of the list route with NE list entries a lane, by the tile
template <int NE>
int launch_topn(const float* q, const float* emb, int nq, int c, int d,
                int offset, const int* size, int n, int tile, int split_rows,
                int splits, float* pool_s, int* pool_i, bool vec,
                cudaStream_t stream) {
  switch (tile) {
    case 8:
      if (nq > QT || topn_gemv_smem(d) > MAX_SMEM || split_rows % CHUNK)
        return (int)cudaErrorInvalidValue;
      return launch_topn_gemv<NE>(q, emb, nq, c, d, offset, size, n,
                                  split_rows / CHUNK, splits, pool_s, pool_i,
                                  vec, stream);
#define TOPN_GEMM(BM)                                                  \
  case BM:                                                             \
    if (split_rows % BN) return (int)cudaErrorInvalidValue;            \
    return launch_topn_gemm<BM, NE>(q, emb, nq, c, d, offset, size, n, \
                                    split_rows / BN, splits, pool_s,   \
                                    pool_i, vec, stream);
    TOPN_GEMM(32)
    TOPN_GEMM(64)
    TOPN_GEMM(128)
#undef TOPN_GEMM
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// the panel route's kernel 1: similarity.cu's kernels with the live-row
// mask in the epilogue
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
                  const int* __restrict__ size, float* __restrict__ out) {
  extern __shared__ __align__(16) float qs[];   // QT x d, then QT norms
  float* inv_q = qs + QT * d;
  gemv_queries(q, nq, d, qs, inv_q);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n0 = (blockIdx.x * (THREADS / 32) + warp) * R;
  const int live_end = size ? *size : EMPTY_ROW;
  float dot, inv_row;
  gemv_rows<VEC>(qs, db, c, d, n0, dot, inv_row);
  // lane i * R + r writes (query i, row r)
  const int i = lane / R, r = lane % R;
  if (i < nq && n0 + r < c)
    out[(size_t)i * c + n0 + r] =
        live(cosine(dot, inv_q[i], inv_row), offset + n0 + r, live_end);
}

template <int BM>
int launch_panel_gemm(const float* q, const float* db, int nq, int c, int d,
                      int offset, const int* size, float* out, bool vec,
                      bool vec_out, cudaStream_t stream) {
  constexpr int BK = BM == 32 ? 32 : 16;   // as similarity.cu's tiles
  const dim3 grid((c + BN - 1) / BN, (nq + BM - 1) / BM);
  auto kernel = vec ? (vec_out ? panel_gemm_kernel<BM, BK, true, true>
                               : panel_gemm_kernel<BM, BK, true, false>)
                    : panel_gemm_kernel<BM, BK, false, false>;
  kernel<<<grid, THREADS, 0, stream>>>(q, db, nq, c, d, offset, size, out);
  return (int)cudaGetLastError();
}

int launch_panel_gemv(const float* q, const float* db, int nq, int c, int d,
                      int offset, const int* size, float* out, bool vec,
                      cudaStream_t stream) {
  const size_t bytes = gemv_smem(d);
  auto kernel = vec ? panel_gemv_kernel<true> : panel_gemv_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(c + CHUNK - 1) / CHUNK, THREADS, bytes, stream>>>(
      q, db, nq, c, d, offset, size, out);
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

__global__ void topn_merge_kernel(const float* __restrict__ pool_s,
                                  const int* __restrict__ pool_i, int p,
                                  int ld_in, int staged, int k, float* top_s,
                                  void* top_i, int idx64, int ld_out,
                                  unsigned char* hit, Payload pay) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_s[2][32];
  __shared__ int red_i[2][32], red_p[2][32];

  const int qr = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int warps = blockDim.x / 32;
  // the pool row, staged in shared memory where it fits (else read in
  // place each round, from L1 / L2)
  const float* sp = pool_s + (size_t)qr * ld_in;
  const int* gp = pool_i + (size_t)qr * ld_in;
  if (staged) {
    float* ss = reinterpret_cast<float*>(smem);
    int* gs = reinterpret_cast<int*>(ss + p);
    for (int j = tid; j < p; j += blockDim.x) {
      ss[j] = sp[j];
      gs[j] = gp[j];
    }
    sp = ss;
    gp = gs;
  }
  __syncthreads();

  // the last winner: (+inf, -1) ranks before every candidate
  float ls = INFINITY;
  int li = -1;
  for (int j = 0; j < k; ++j) {
    float bs = -INFINITY;
    int bi = EMPTY_ROW, bp = -1;
    for (int x = tid; x < p; x += blockDim.x) {
      const float s = sp[x];
      const int g = gp[x];
      if (before(ls, li, s, g) && before(s, g, bs, bi)) {
        bs = s;
        bi = g;
        bp = x;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(FULL, bs, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      const int op = __shfl_xor_sync(FULL, bp, off);
      if (before(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
        bp = op;
      }
    }
    const int buf = j & 1;   // a round's slots are rewritten two rounds on
    if (lane == 0) {
      red_s[buf][warp] = bs;
      red_i[buf][warp] = bi;
      red_p[buf][warp] = bp;
    }
    __syncthreads();
    bs = red_s[buf][0];
    bi = red_i[buf][0];
    bp = red_p[buf][0];
    for (int w = 1; w < warps; ++w)
      if (before(red_s[buf][w], red_i[buf][w], bs, bi)) {
        bs = red_s[buf][w];
        bi = red_i[buf][w];
        bp = red_p[buf][w];
      }
    ls = bs;
    li = bi;
    const bool finite = fabsf(bs) < INFINITY;   // false for NaN
    if (tid == 0) {
      top_s[(size_t)qr * ld_out + j] = bs;
      if (idx64)
        reinterpret_cast<long long*>(top_i)[(size_t)qr * ld_out + j] = bi;
      else
        reinterpret_cast<int*>(top_i)[(size_t)qr * ld_out + j] = bi;
      if (hit) hit[(size_t)qr * k + j] = finite;
    }
    if (pay.a && bp >= 0) {
      const size_t src = pay.by_row
                             ? (size_t)(bi - pay.offset) * pay.r
                             : (size_t)qr * pay.ld_src + (size_t)bp * pay.r;
      const size_t dst = (size_t)qr * pay.ld_dst +
                         (size_t)(pay.farthest ? k - 1 - j : j) * pay.r;
      for (int x = tid; x < pay.r; x += blockDim.x) {
        pay.oa[dst + x] = pay.a[src + x];
        pay.ob[dst + x] = pay.b[src + x];
        pay.os[dst + x] = pay.s[src + x];
        pay.ov[dst + x] = pay.v[src + x] && (!pay.farthest || finite);
      }
    }
  }
}

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

// Kernel 1 of the list route. q (nq, d), emb (c, d) fp32; its rows are
// global rows offset..; size: device pointer to the live-row count
// (global; NULL: every row live). tile: 8 (streaming) or 32, 64, 128
// (GEMM); a split takes split_rows consecutive rows (a multiple of 32, or
// of 128 for the GEMM). Writes pool_s / pool_i (nq, splits n), n <= 128.
extern "C" int retrieve_topn_launch(const float* q, const float* emb, int nq,
                                    int c, int d, int offset, const int* size,
                                    int n, int tile, int split_rows,
                                    int splits, float* pool_s, int* pool_i,
                                    cudaStream_t stream) {
  if (n < 1 || n > LIST_N) return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && aligned16(q) && aligned16(emb);
  auto launch = n <= 32 ? launch_topn<1>
                : n <= 64 ? launch_topn<2>
                          : launch_topn<4>;
  return launch(q, emb, nq, c, d, offset, size, n, tile, split_rows, splits,
                pool_s, pool_i, vec, stream);
}

// Kernel 1 of the panel route: the (nq, c) score panel `out`, rows past
// the live-row count at -inf (arguments as above), scored at `tile` (8
// streaming, 32, 64, 128 GEMM), as similarity_launch_tile scores it.
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
// entry x of global row row0 + x. By rounds at k <= 128 over explicit
// rows, else by selection. Records: if ra is not NULL, each winner's r
// records of (ra, rb, rs, rv) -- by_row: the (C_l, r) panels at row -
// offset; else (nq, p, r) by pool position, rows ld_src apart -- into
// (oa, ob, os, ov): rank order, or with `farthest` the replay's layout
// (farthest first, valid &= hit); rows ld_dst apart.
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
  cudaError_t err;
  if (!pool_i || k > ROUNDS_K) {
    int kpad = 32;
    while (kpad < k) kpad <<= 1;
    const size_t fixed = (size_t)kpad * (sizeof(long long) + sizeof(int)) +
                         SEL_BINS * sizeof(int);
    const size_t row = (size_t)p * (pool_i ? 2 : 1) * sizeof(float);
    const int staged = fixed + row + sizeof(Select) <= MAX_SMEM;
    const size_t bytes = fixed + (staged ? row : 0);
    err = cudaFuncSetAttribute(topn_select_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    // 1,024 threads where the row is staged whole (one block an SM); 512
    // down to 2,048 entries (two blocks an SM: S = 4, n = 512 took 3.62
    // ms against 3.79 with 1,024 at a shard's 8,192)
    const int threads = p >= 16384 ? 1024 : p >= 2048 ? 512 : 256;
    topn_select_kernel<<<nq, threads, bytes, stream>>>(
        pool_s, pool_i, p, ld_in, row0, staged, k, kpad, top_s, top_i, idx64,
        ld_out, hit, pay);
    return (int)cudaGetLastError();
  }
  const size_t pool = (size_t)p * (sizeof(float) + sizeof(int));
  const int staged = pool <= MAX_SMEM;
  const size_t bytes = staged ? pool : 0;
  err = cudaFuncSetAttribute(topn_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int threads = p <= 1024 ? 128 : p <= 4096 ? 256 : 512;
  topn_merge_kernel<<<nq, threads, bytes, stream>>>(
      pool_s, pool_i, p, ld_in, staged, k, top_s, top_i, idx64, ld_out, hit,
      pay);
  return (int)cudaGetLastError();
}
