// The routing path's retrieve stage for Hopper (sm_90a): the top-n DB rows
// of each query by cosine similarity among the live rows, with no (Q, C)
// score panel and no sort. Two kernels:
//
// `retrieve_topn` (kernel 1): similarity + live-row mask + a running
// top-n per (query row, column split), written as a small candidate pool.
// `topn_merge` (kernel 2): the top-k of each query's pool, optionally with
// the winners' records, in the replay's layout.
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
// union is the top-n of the parts' top-n: splitting the columns, then
// merging the splits' (or the shards') lists gives what one stable sort of
// the whole panel gives, dead -inf rows (global row >= *size) in
// ascending row order included. A pool slot no candidate filled holds
// (-inf, EMPTY_ROW), after every real candidate; a pool always holds at
// least min(n, C) real ones, so an empty slot is never taken.
//
// Kernel 1 scores each pair with the main loops and the epilogue
// arithmetic of similarity.cu (similarity_tile.cuh), tile for tile, so
// its scores are bit-equal to the panel's. Bound: as similarity's, less
// the panel's store: at Q = 1024, C = 32768, D = 1536 the product's
// 1.03e11 fp32 operations (1.54 ms at 67 TFLOP/s); at Q = 8 reading the
// 201 MB DB (0.060 ms at 3.35 TB/s). Its pool is 0.3% of the panel.
//
// Q > 8, `topn_gemm_kernel<BM>` (BM = 32, 64, 128 by the bucket, as
// similarity_launch_tile picks): a block owns BM query rows and one split
// of `tiles` consecutive 128-column tiles, walked in ascending order; the
// caller sizes the splits so that about two blocks an SM run (bucket
// 1024: 8 row blocks x 32 splits of 8 tiles). After each tile's main loop
// the BM x 128 scores go to shared memory over the freed staging buffers
// (64 KB at BM = 128); then each warp takes rows and offers their 128
// scores to the row's list: one ballot against the list's n-th entry
// filters the whole batch, and each candidate that passes is inserted
// into the list held in the warp's registers (entry k in lane k % 32):
// its rank by a ballot, the shift by one shuffle. The lists (BM x n
// entries) live in shared memory between tiles: 85 KB a block at BM =
// 128, n = 20; two blocks an SM up to n ~ 45, one above. The merge is
// a call at BM = 128 and inlined below (see `merge`). Pool: splits x n
// candidates a query (640 at bucket 1024, n = 20).
//
// Q <= 8, `topn_gemv_kernel`: the streaming kernel, a block walking
// `chunks` consecutive 32-row chunks (8 warps x 4 rows); warp w keeps
// query w's list in its registers across the chunks and takes the
// chunk's 32 scores of its query at a barrier. Splits: about two blocks
// an SM (C = 32768: 256 splits of 4 chunks). Pool: splits x n a query
// (5,120 at n = 20).
//
// Kernel 2, `topn_merge_kernel`: one block per query, the pool row staged
// in shared memory (read in place where it does not fit: P > ~29,000,
// e.g. Q <= 8 at C = 32768 with n near 128), then k rounds of a
// block-wide arg-max over the candidates after the last winner in the
// order. Chosen over a bitonic sort: the rounds touch P / threads
// entries each and yield the winners already in rank order, which the
// payload write needs; k <= 128, and a sort would order all P entries
// (up to ~34,000) to keep k. Bound: reading
// the pool (bucket 1024: 5 MB, 1.6 us); a round costs one barrier. The
// payload (a candidate's R records of model_a, model_b, outcome, valid)
// is gathered by row from one shard's (C_l, R) panels or carried by pool
// position, and written in rank order or in the replay's pre-gathered
// layout (farthest first, valid &= the hit mask).
#include <math.h>

#include "similarity_tile.cuh"

using namespace simtile;

namespace {

constexpr int EMPTY_ROW = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_N = 128;           // four list entries a lane
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
// a warp's sorted list of n <= 32 NE entries (NE = 1, 2 or 4): entry k
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
// kernel 1, Q > 8
// ---------------------------------------------------------------------------

template <int BM, int BK>
struct TopnSmem {
  static constexpr size_t TILE = (size_t)BM * BN * sizeof(float);
  static constexpr size_t STAGE = sizeof(GemmSmem<BM, BK>);
  static constexpr size_t UNION = TILE > STAGE ? TILE : STAGE;
  static size_t bytes(int n) {
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
// kernel 1, Q <= 8
// ---------------------------------------------------------------------------

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

// kernel 1 with NE list entries a lane, by the tile
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
#define TOPN_GEMM(BM)                                                    \
  case BM:                                                               \
    if (split_rows % BN) return (int)cudaErrorInvalidValue;              \
    return launch_topn_gemm<BM, NE>(q, emb, nq, c, d, offset, size, n,   \
                                    split_rows / BN, splits, pool_s,     \
                                    pool_i, vec, stream);
    TOPN_GEMM(32)
    TOPN_GEMM(64)
    TOPN_GEMM(128)
#undef TOPN_GEMM
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Kernel 1. q (nq, d), emb (c, d) fp32; its rows are global rows offset..;
// size: device pointer to the live-row count (global; NULL: every row
// live). tile: 8 (streaming) or 32, 64, 128 (GEMM); a split takes
// split_rows consecutive rows (a multiple of 32, or of 128 for the GEMM).
// Writes pool_s / pool_i (nq, splits n).
extern "C" int retrieve_topn_launch(const float* q, const float* emb, int nq,
                                    int c, int d, int offset, const int* size,
                                    int n, int tile, int split_rows,
                                    int splits, float* pool_s, int* pool_i,
                                    cudaStream_t stream) {
  if (n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && aligned16(q) && aligned16(emb);
  auto launch = n <= 32 ? launch_topn<1> : n <= 64 ? launch_topn<2>
                                                   : launch_topn<4>;
  return launch(q, emb, nq, c, d, offset, size, n, tile, split_rows, splits,
                pool_s, pool_i, vec, stream);
}

// Kernel 2. The top k of each row of the (nq, p) pool (rows ld_in apart)
// into top_s and top_i (int64 if idx64, else int32; rows ld_out apart)
// and, if hit is not NULL, hit (nq, k). Records: if ra is not NULL, each
// winner's r records of (ra, rb, rs, rv) -- by_row: the (C_l, r) panels
// at row - offset; else (nq, p, r) by pool position, rows ld_src apart --
// into (oa, ob, os, ov): rank order, or with `farthest` the replay's
// layout (farthest first, valid &= hit); rows ld_dst apart.
extern "C" int topn_merge_launch(
    const float* pool_s, const int* pool_i, int nq, int p, int ld_in, int k,
    float* top_s, void* top_i, int idx64, int ld_out, unsigned char* hit,
    const int* ra, const int* rb, const float* rs, const unsigned char* rv,
    int r, int by_row, int offset, int ld_src, int* oa, int* ob, float* os,
    unsigned char* ov, int farthest, int ld_dst, cudaStream_t stream) {
  if (k < 1 || k > p) return (int)cudaErrorInvalidValue;
  const size_t pool = (size_t)p * (sizeof(float) + sizeof(int));
  const int staged = pool <= MAX_SMEM;
  const size_t bytes = staged ? pool : 0;
  cudaError_t err = cudaFuncSetAttribute(
      topn_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int threads = p <= 1024 ? 128 : p <= 4096 ? 256 : 512;
  Payload pay{ra, rb, rs, rv, r, by_row, offset, ld_src,
              oa, ob, os, ov, farthest, ld_dst};
  topn_merge_kernel<<<nq, threads, bytes, stream>>>(
      pool_s, pool_i, p, ld_in, staged, k, top_s, top_i, idx64, ld_out, hit,
      pay);
  return (int)cudaGetLastError();
}
