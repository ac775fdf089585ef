// Cosine-similarity score panel for Hopper (sm_90a).
//
// Replaces the TPU kernel `similarity_pallas` (body `_sim_kernel`) in
// src/repro/kernels/similarity_topk.py: out[i, j] = <q_i, d_j> *
// rsqrt(sum q_i^2 + 1e-18) * rsqrt(sum d_j^2 + 1e-18), fp32 throughout,
// on the CUDA cores. TF32 is ruled out: a top-k over tied and near-tied
// scores must agree with the fp32 reference within 1e-5.
//
// Bound: at the routing path's top bucket (Q = 1024 queries against a
// C = 32768 x 1536 DB) the product is 1.03e11 FLOP against 342 MB of
// traffic, bound by fp32 operations (1.54 ms at 67 TFLOP/s). At the
// smallest bucket (Q = 8) it is bound by reading the 201 MB DB (0.060 ms
// at 3.35 TB/s). Two designs, chosen by the bucket (the switch points come
// from timing every tile at every bucket in chip_smoke.py):
//
// Q > 8: a register-tiled SGEMM, `gemm_kernel<BM, BK>`. A block computes a
// BM x 128 tile (BM = 32, 64 or 128, the smallest that holds the bucket,
// so no bucket computes more than twice its rows) with 256 threads. D is
// walked in chunks of BK columns (32 at BM = 32, else 16). Each chunk is
// read from device memory with 16-byte loads into registers while the
// previous chunk computes out of shared memory (two shared buffers, one
// barrier a chunk), then stored transposed so that the inner loop reads
// rows of the chunk as float4: at BM = 128 a thread holds 8 x 8 sums and
// issues 4 shared loads for 64 FMAs. The warps form a 4 x 2 grid of 4 x 8
// threads, so each of those loads is one shared-memory wavefront (4
// distinct float4 of the query chunk, 8 of the DB chunk). A thread owns
// rows {ty * 4 + i, 64 + ty * 4 + i} and columns {tx * 4 + j, 64 + tx * 4
// + j}, so the output is written as float4 rows. The row norms are off
// the inner loop: each thread squares the elements it stages, once, when
// it stores them, a chunk's compute after the load (squared at the load,
// every chunk waited there for device memory), and the BK / 4
// neighbouring threads that stage a row reduce their partial sums with
// shuffles at the end.
//
// Q <= 8: a streaming kernel, `gemv_kernel`. The 8 query rows
// (zero-padded) stay in shared memory whole (48 KB at D = 1536); each
// warp streams 4 DB rows with coalesced 16-byte loads, two steps ahead,
// and accumulates 8 x 4 dot products and 4 squared norms per lane,
// reduced across the warp once at the end. The DB is read once.
//
// A D that is not a multiple of 4 (or an unaligned pointer) takes the
// same kernels with scalar loads; ragged Q and N are masked.
#include "similarity_tile.cuh"

using namespace simtile;

namespace {

// ---------------------------------------------------------------------------
// Q > 8: register-tiled SGEMM (main loop: similarity_tile.cuh:gemm_tile)
// ---------------------------------------------------------------------------

template <int BM, int BK, bool VEC, bool VEC_OUT>
__global__ void __launch_bounds__(THREADS, 2)
gemm_kernel(const float* __restrict__ q, const float* __restrict__ db,
            float* __restrict__ out, int nq, int n, int d) {
  using G = Gemm<BM, BK>;
  constexpr int TM = G::TM, TN = 8;
  __shared__ __align__(16) GemmSmem<BM, BK> sm;
  __shared__ float inv_a[BM];
  __shared__ float inv_b[BN];

  const int ty = gemm_ty(threadIdx.x);
  const int tx = gemm_tx(threadIdx.x);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  float acc[TM][TN];
  gemm_tile<BM, BK, VEC>(q, db, nq, n, d, row0, col0, sm, inv_a, inv_b, acc);

  float ib[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) ib[j] = inv_b[G::col(tx, j)];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = G::row(ty, i);
    const int gr = row0 + r;
    if (gr >= nq) continue;
    const float ia = inv_a[r];
    float* o = out + (size_t)gr * n + col0;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int c = G::col(tx, 4 * g);
      const float4 v = make_float4(cosine(acc[i][4 * g], ia, ib[4 * g]),
                                   cosine(acc[i][4 * g + 1], ia, ib[4 * g + 1]),
                                   cosine(acc[i][4 * g + 2], ia, ib[4 * g + 2]),
                                   cosine(acc[i][4 * g + 3], ia, ib[4 * g + 3]));
      if constexpr (VEC_OUT) {
        if (col0 + c < n) *reinterpret_cast<float4*>(o + c) = v;
      } else {
        if (col0 + c < n) o[c] = v.x;
        if (col0 + c + 1 < n) o[c + 1] = v.y;
        if (col0 + c + 2 < n) o[c + 2] = v.z;
        if (col0 + c + 3 < n) o[c + 3] = v.w;
      }
    }
  }
}

template <int BM>
int launch_gemm(const float* q, const float* db, float* out, int nq, int n,
                int d, bool vec, bool vec_out, cudaStream_t stream) {
  // the short tile reads 32 columns a chunk, to keep more of the DB in
  // flight; the others 16, within 48 KB of static shared memory
  constexpr int BK = BM == 32 ? 32 : 16;
  const dim3 grid((n + BN - 1) / BN, (nq + BM - 1) / BM);
  auto kernel = vec ? (vec_out ? gemm_kernel<BM, BK, true, true>
                               : gemm_kernel<BM, BK, true, false>)
                    : gemm_kernel<BM, BK, false, false>;
  kernel<<<grid, THREADS, 0, stream>>>(q, db, out, nq, n, d);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Q <= 8: the DB streamed once (similarity_tile.cuh:gemv_rows)
// ---------------------------------------------------------------------------

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
gemv_kernel(const float* __restrict__ q, const float* __restrict__ db,
            float* __restrict__ out, int nq, int n, int d) {
  extern __shared__ __align__(16) float qs[];   // QT x d, then QT norms
  float* inv_q = qs + QT * d;
  gemv_queries(q, nq, d, qs, inv_q);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n0 = (blockIdx.x * (THREADS / 32) + warp) * R;
  float dot, inv_row;
  gemv_rows<VEC>(qs, db, n, d, n0, dot, inv_row);
  // lane i * R + r writes (query i, row r)
  const int i = lane / R, r = lane % R;
  if (i < nq && n0 + r < n)
    out[(size_t)i * n + n0 + r] = cosine(dot, inv_q[i], inv_row);
}

int launch_gemv(const float* q, const float* db, float* out, int nq, int n,
                int d, bool vec, cudaStream_t stream) {
  const size_t bytes = gemv_smem(d);
  const int rows = (THREADS / 32) * R;
  const dim3 grid((n + rows - 1) / rows);
  cudaError_t err;
  if (vec) {
    err = cudaFuncSetAttribute(gemv_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    gemv_kernel<true><<<grid, THREADS, bytes, stream>>>(q, db, out, nq,
                                                            n, d);
  } else {
    err = cudaFuncSetAttribute(gemv_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    gemv_kernel<false><<<grid, THREADS, bytes, stream>>>(q, db, out, nq,
                                                             n, d);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// tile: 0 picks by the bucket (the path's choice); 8 or 16 forces the
// streaming kernel with that many query rows, 32, 64 or 128 the GEMM with
// that many (for timing the alternatives).
extern "C" int similarity_launch_tile(const float* q, const float* db,
                                      float* out, int nq, int n, int d,
                                      int tile, cudaStream_t stream) {
  const bool vec = d % 4 == 0 && aligned16(q) && aligned16(db);
  const bool vec_out = n % 4 == 0 && aligned16(out);
  if (tile == 0) {
    if (nq <= QT && gemv_smem(d) <= MAX_SMEM) tile = 8;
    else if (nq <= 32) tile = 32;
    else if (nq <= 64) tile = 64;
    else tile = 128;
  }
  switch (tile) {
    case 8:
      if (nq > QT || gemv_smem(d) > MAX_SMEM)
        return (int)cudaErrorInvalidValue;
      return launch_gemv(q, db, out, nq, n, d, vec, stream);
    case 32:
      return launch_gemm<32>(q, db, out, nq, n, d, vec, vec_out, stream);
    case 64:
      return launch_gemm<64>(q, db, out, nq, n, d, vec, vec_out, stream);
    case 128:
      return launch_gemm<128>(q, db, out, nq, n, d, vec, vec_out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int similarity_launch(const float* q, const float* db, float* out,
                                 int nq, int n, int d, cudaStream_t stream) {
  return similarity_launch_tile(q, db, out, nq, n, d, 0, stream);
}
