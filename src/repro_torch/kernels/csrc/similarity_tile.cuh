// The cosine-similarity main loops shared by `similarity.cu` (the score
// panel) and `retrieve_topn.cu` (the fused top-n, which writes no panel).
// Both score a (query, DB row) pair with these loops and `cosine`, so
// their scores are equal bit for bit; only what they do with a tile of
// scores differs. The design notes are in similarity.cu's header.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace simtile {

constexpr float EPS = 1e-18f;
constexpr int THREADS = 256;
constexpr int BN = 128;   // DB rows per GEMM tile
constexpr int PAD = 4;    // keeps rows of the staged chunk 16-byte aligned
constexpr int QT = 8;     // query rows of the streaming kernel
constexpr int R = 4;      // DB rows per warp of the streaming kernel
constexpr size_t MAX_SMEM = 227 * 1024;

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// The score of one pair from its dot product and the two inverse norms:
// the one place the epilogue's arithmetic is written.
__device__ __forceinline__ float cosine(float dot, float inv_q, float inv_d) {
  return dot * inv_q * inv_d;
}

// Four consecutive elements of row `r` from column `c` of a (rows, d)
// matrix; zero past the ragged edges.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ x, int rows,
                                        int d, int r, int c) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r >= rows) return v;
  const float* p = x + (size_t)r * d + c;
  if constexpr (VEC) {
    if (c < d) v = __ldg(reinterpret_cast<const float4*>(p));
  } else {
    if (c < d) v.x = __ldg(p);
    if (c + 1 < d) v.y = __ldg(p + 1);
    if (c + 2 < d) v.z = __ldg(p + 2);
    if (c + 3 < d) v.w = __ldg(p + 3);
  }
  return v;
}

// ---------------------------------------------------------------------------
// Q > 8: register-tiled SGEMM
// ---------------------------------------------------------------------------

template <int BM, int BK>
struct Gemm {
  static constexpr int TM = BM / 16;                 // rows per thread
  static constexpr int RW = TM < 4 ? TM : 4;         // rows per shared read
  static constexpr int RG = TM / RW;                 // row groups
  static constexpr int KQ = BK / 4;                  // float4s in a chunk row
  static constexpr int LA = (BM * KQ + THREADS - 1) / THREADS;
  static constexpr int LB = BN * KQ / THREADS;
  __device__ static int row(int ty, int i) {
    return (i / RW) * (BM / RG) + ty * RW + (i % RW);
  }
  __device__ static int col(int tx, int j) {
    return (j / 4) * (BN / 2) + tx * 4 + (j % 4);
  }
};

// the main loop's two shared staging buffers
template <int BM, int BK>
struct GemmSmem {
  float as[2][BK][BM + PAD];
  float bs[2][BK][BN + PAD];
};

// the thread's place in the 4 x 2 grid of 4 x 8-thread warps: per shared
// load a warp reads 4 distinct float4 of the query chunk and 8 of the DB
// chunk, one wavefront each
__device__ __forceinline__ int gemm_ty(int tid) {
  return (tid / 32 / 2) * 4 + (tid % 32) / 8;   // 0..15
}
__device__ __forceinline__ int gemm_tx(int tid) {
  return (tid / 32 % 2) * 8 + (tid % 32) % 8;   // 0..15
}

// One BM x BN tile at (row0, col0): the thread's sums acc[i][j] (row
// Gemm::row(ty, i), column Gemm::col(tx, j)) and the tile's inverse row
// norms inv_a (BM) and inv_b (BN) in shared memory. Ends with a barrier,
// after which the staging buffers `sm` are free for the caller.
template <int BM, int BK, bool VEC>
__device__ __forceinline__ void gemm_tile(
    const float* __restrict__ q, const float* __restrict__ db, int nq, int n,
    int d, int row0, int col0, GemmSmem<BM, BK>& sm, float* inv_a,
    float* inv_b, float (&acc)[BM / 16][8]) {
  using G = Gemm<BM, BK>;
  constexpr int TM = G::TM, TN = 8;
  constexpr int KQ = G::KQ;
  auto& as = sm.as;
  auto& bs = sm.bs;

  const int tid = threadIdx.x;
  const int ty = gemm_ty(tid);
  const int tx = gemm_tx(tid);
  // staging: slot s of this thread is row (tid + 256 s) / KQ, columns
  // 4 * (tid % KQ) .. + 3 of the chunk
  const int kq = tid % KQ;

  float4 ra[G::LA], rb[G::LB];
  float sq_a[G::LA], sq_b[G::LB];
#pragma unroll
  for (int s = 0; s < G::LA; ++s) sq_a[s] = 0.f;
#pragma unroll
  for (int s = 0; s < G::LB; ++s) sq_b[s] = 0.f;

  auto load = [&](int k0) {
#pragma unroll
    for (int s = 0; s < G::LA; ++s) {
      const int l = tid + THREADS * s;
      ra[s] = (l < BM * KQ)
                  ? load4<VEC>(q, nq, d, row0 + l / KQ, k0 + 4 * kq)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int s = 0; s < G::LB; ++s) {
      const int l = tid + THREADS * s;
      rb[s] = load4<VEC>(db, n, d, col0 + l / KQ, k0 + 4 * kq);
    }
  };
  // the squares are taken here, when the loads have had a chunk's compute
  // to arrive, so that nothing waits on them earlier
  auto store = [&](int buf) {
#pragma unroll
    for (int s = 0; s < G::LA; ++s) sq_a[s] += dot4(ra[s], ra[s]);
#pragma unroll
    for (int s = 0; s < G::LB; ++s) sq_b[s] += dot4(rb[s], rb[s]);
#pragma unroll
    for (int s = 0; s < G::LA; ++s) {
      const int l = tid + THREADS * s;
      if (l < BM * KQ) {
        const int r = l / KQ;
        as[buf][4 * kq + 0][r] = ra[s].x;
        as[buf][4 * kq + 1][r] = ra[s].y;
        as[buf][4 * kq + 2][r] = ra[s].z;
        as[buf][4 * kq + 3][r] = ra[s].w;
      }
    }
#pragma unroll
    for (int s = 0; s < G::LB; ++s) {
      const int r = (tid + THREADS * s) / KQ;
      bs[buf][4 * kq + 0][r] = rb[s].x;
      bs[buf][4 * kq + 1][r] = rb[s].y;
      bs[buf][4 * kq + 2][r] = rb[s].z;
      bs[buf][4 * kq + 3][r] = rb[s].w;
    }
  };

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int chunks = (d + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const int cur = c & 1;
    if (c + 1 < chunks) load((c + 1) * BK);   // in flight during compute
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < G::RG; ++g) {
        const float* pa = &as[cur][kk][G::row(ty, g * G::RW)];
        if constexpr (G::RW == 4) {
          const float4 v = *reinterpret_cast<const float4*>(pa);
          a[g * 4 + 0] = v.x;
          a[g * 4 + 1] = v.y;
          a[g * 4 + 2] = v.z;
          a[g * 4 + 3] = v.w;
        } else {
          const float2 v = *reinterpret_cast<const float2*>(pa);
          a[g * G::RW + 0] = v.x;
          a[g * G::RW + 1] = v.y;
        }
      }
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const float4 v =
            *reinterpret_cast<const float4*>(&bs[cur][kk][G::col(tx, 4 * g)]);
        b[g * 4 + 0] = v.x;
        b[g * 4 + 1] = v.y;
        b[g * 4 + 2] = v.z;
        b[g * 4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (c + 1 < chunks) store(cur ^ 1);
    __syncthreads();
  }

  // the KQ neighbouring threads that staged a row hold its partial sums
#pragma unroll
  for (int s = 0; s < G::LA; ++s) {
    float v = sq_a[s];
#pragma unroll
    for (int off = 1; off < KQ; off <<= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    const int l = tid + THREADS * s;
    if (kq == 0 && l < BM * KQ) inv_a[l / KQ] = rsqrtf(v + EPS);
  }
#pragma unroll
  for (int s = 0; s < G::LB; ++s) {
    float v = sq_b[s];
#pragma unroll
    for (int off = 1; off < KQ; off <<= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (kq == 0) inv_b[(tid + THREADS * s) / KQ] = rsqrtf(v + EPS);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Q <= 8: the DB streamed once, queries resident in shared memory
// ---------------------------------------------------------------------------

// the streaming kernel's shared memory: QT x d query rows, QT norms
inline size_t gemv_smem(int d) { return ((size_t)QT * d + QT) * sizeof(float); }

// Stage the (zero-padded) query rows in `qs` (QT x d) and their inverse
// norms in inv_q (QT). Ends with a barrier.
__device__ __forceinline__ void gemv_queries(const float* __restrict__ q,
                                             int nq, int d, float* qs,
                                             float* inv_q) {
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  for (int l = tid; l < QT * d; l += THREADS) {
    const int r = l / d;
    qs[l] = r < nq ? q[(size_t)r * d + (l - r * d)] : 0.f;
  }
  __syncthreads();
  for (int r = warp; r < QT; r += THREADS / 32) {
    float v = 0.f;
    for (int c = lane; c < d; c += 32) v += qs[r * d + c] * qs[r * d + c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) inv_q[r] = rsqrtf(v + EPS);
  }
  __syncthreads();
}

// The warp's R DB rows from n0 against the QT staged queries: lane
// i * R + r gets the dot product of (query i, row n0 + r) in `dot` and the
// row's inverse norm in `inv_row`. Each warp streams its rows with
// coalesced 16-byte loads, two steps ahead, and reduces its 8 x 4 sums
// and 4 squared norms across the warp once at the end.
template <bool VEC>
__device__ __forceinline__ void gemv_rows(const float* qs,
                                          const float* __restrict__ db, int n,
                                          int d, int n0, float& dot,
                                          float& inv_row) {
  constexpr int W = VEC ? 4 : 1;      // elements per lane per step
  constexpr int STEP = 32 * W;
  const int lane = threadIdx.x % 32;
  float acc[QT][R], sq[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    sq[r] = 0.f;
#pragma unroll
    for (int i = 0; i < QT; ++i) acc[i][r] = 0.f;
  }

  auto step = [&](const float4 (&x)[R], int c) {
#pragma unroll
    for (int r = 0; r < R; ++r) sq[r] += dot4(x[r], x[r]);
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      float4 qv;
      if constexpr (VEC) {
        qv = *reinterpret_cast<const float4*>(qs + i * d + c);
      } else {
        qv = make_float4(qs[i * d + c], 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) acc[i][r] += dot4(qv, x[r]);
    }
  };
  auto fetch = [&](float4 (&x)[R], int c) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (VEC) {
        x[r] = load4<true>(db, n, d, n0 + r, c);
      } else {
        x[r] = make_float4(
            (n0 + r < n && c < d) ? __ldg(db + (size_t)(n0 + r) * d + c) : 0.f,
            0.f, 0.f, 0.f);
      }
    }
  };

  // two steps in flight: x1 is fetched before x0 is consumed
  int c = lane * W;
  float4 x0[R], x1[R];
  fetch(x0, c);
  for (; c < d; c += 2 * STEP) {
    fetch(x1, c + STEP);
    step(x0, c < d ? c : 0);
    if (c + STEP < d) {
      fetch(x0, c + 2 * STEP);
      step(x1, c + STEP);
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sq[r] += __shfl_xor_sync(0xffffffffu, sq[r], off);
#pragma unroll
      for (int i = 0; i < QT; ++i)
        acc[i][r] += __shfl_xor_sync(0xffffffffu, acc[i][r], off);
    }
  }
  // every lane holds every sum; lane i * R + r takes (query i, row r)
  static_assert(QT * R == 32, "one pair a lane");
  dot = 0.f;
  inv_row = 0.f;
#pragma unroll
  for (int i = 0; i < QT; ++i)
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (lane == i * R + r) {
        dot = acc[i][r];
        inv_row = rsqrtf(sq[r] + EPS);
      }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace simtile
