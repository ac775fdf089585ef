// Cosine-similarity score panel for Hopper (sm_90a).
//
// Replaces the TPU kernel `similarity_pallas` (body `_sim_kernel`) in
// src/repro/kernels/similarity_topk.py: out[i, j] = <q_i, d_j> *
// rsqrt(sum q_i^2 + 1e-18) * rsqrt(sum d_j^2 + 1e-18), fp32 throughout.
//
// Bound: at the routing path's top bucket (Q = 1024 queries against a
// C = 32768 x 1536 DB) the product is 1.03e11 FLOP against 342 MB of
// traffic, so it is bound by fp32 operations on the CUDA cores. TF32 is
// ruled out: a top-k over tied and near-tied scores must agree with the
// fp32 reference. At a small bucket (Q = 8) it is bound by reading the DB.
//
// Design: a classic register-tiled SGEMM. A block computes a 128 x 128
// output tile with 256 threads, each holding an 8 x 8 accumulator. D is
// not kept whole (a 128 x 1536 fp32 tile would be 786 KB, more than a
// block's 227 KB of shared memory): the block walks D in chunks of 16
// columns staged through shared memory, transposed so the inner loop
// reads rows of the chunk. The row norms are accumulated in the same
// loop from the fragments each thread already holds (16 extra FMAs per
// 64), so neither operand is normalised in a separate pass and the
// panel is written once. A thread owns rows ty + 16 i and columns
// tx + 16 j: shared-memory reads are then conflict-free and the output
// store is coalesced.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;       // query rows per block
constexpr int BN = 128;       // DB rows per block
constexpr int BK = 16;        // D columns per shared-memory chunk
constexpr int TM = 8;         // rows per thread
constexpr int TN = 8;         // columns per thread
constexpr int THREADS = 256;  // (BM / TM) * (BN / TN)

__global__ void __launch_bounds__(THREADS)
similarity_kernel(const float* __restrict__ q, const float* __restrict__ db,
                  float* __restrict__ out, int nq, int n, int d) {
  __shared__ float as[BK][BM + 4];
  __shared__ float bs[BK][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
  float sq_a[TM];
  float sq_b[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    sq_a[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) sq_b[j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    // stage a (BM x BK) chunk of q and a (BN x BK) chunk of db,
    // transposed, zero-filled past the ragged edges
#pragma unroll
    for (int l = tid; l < BM * BK; l += THREADS) {
      const int r = l / BK, c = l % BK;
      const int gr = row0 + r, gc = k0 + c;
      as[c][r] = (gr < nq && gc < d) ? q[(size_t)gr * d + gc] : 0.f;
    }
#pragma unroll
    for (int l = tid; l < BN * BK; l += THREADS) {
      const int r = l / BK, c = l % BK;
      const int gr = col0 + r, gc = k0 + c;
      bs[c][r] = (gr < n && gc < d) ? db[(size_t)gr * d + gc] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) sq_a[i] += a[i] * a[i];
#pragma unroll
      for (int j = 0; j < TN; ++j) sq_b[j] += b[j] * b[j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

  float inv_b[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) inv_b[j] = rsqrtf(sq_b[j] + 1e-18f);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= nq) continue;
    const float inv_a = rsqrtf(sq_a[i] + 1e-18f);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gc < n) out[(size_t)gr * n + gc] = acc[i][j] * inv_a * inv_b[j];
    }
  }
}

}  // namespace

extern "C" int similarity_launch(const float* q, const float* db, float* out,
                                 int nq, int n, int d, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (nq + BM - 1) / BM);
  similarity_kernel<<<grid, THREADS, 0, stream>>>(q, db, out, nq, n, d);
  return (int)cudaGetLastError();
}
