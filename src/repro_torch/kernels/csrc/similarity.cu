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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float EPS = 1e-18f;
constexpr int THREADS = 256;
constexpr int BN = 128;   // DB rows per GEMM block
constexpr int PAD = 4;    // keeps rows of the staged chunk 16-byte aligned

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
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

template <int BM, int BK, bool VEC, bool VEC_OUT>
__global__ void __launch_bounds__(THREADS, 2)
gemm_kernel(const float* __restrict__ q, const float* __restrict__ db,
            float* __restrict__ out, int nq, int n, int d) {
  using G = Gemm<BM, BK>;
  constexpr int KQ = G::KQ;
  constexpr int TM = G::TM, TN = 8;
  __shared__ __align__(16) float as[2][BK][BM + PAD];
  __shared__ __align__(16) float bs[2][BK][BN + PAD];
  __shared__ float inv_a[BM];
  __shared__ float inv_b[BN];

  const int tid = threadIdx.x;
  // warps in a 4 x 2 grid of 4 x 8 threads: per shared load a warp reads
  // 4 distinct float4 of the query chunk and 8 of the DB chunk, one
  // wavefront each
  const int warp = tid / 32, lane = tid % 32;
  const int ty = (warp / 2) * 4 + lane / 8;   // 0..15
  const int tx = (warp % 2) * 8 + lane % 8;   // 0..15
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
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

  float acc[TM][TN];
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
      const float4 v = make_float4(acc[i][4 * g] * ia * ib[4 * g],
                                   acc[i][4 * g + 1] * ia * ib[4 * g + 1],
                                   acc[i][4 * g + 2] * ia * ib[4 * g + 2],
                                   acc[i][4 * g + 3] * ia * ib[4 * g + 3]);
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
// Q <= 8: the DB streamed once, queries resident in shared memory
// ---------------------------------------------------------------------------

constexpr int QT = 8;     // query rows of the streaming kernel
constexpr int R = 4;      // DB rows per warp

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
gemv_kernel(const float* __restrict__ q, const float* __restrict__ db,
            float* __restrict__ out, int nq, int n, int d) {
  constexpr int W = VEC ? 4 : 1;      // elements per lane per step
  constexpr int STEP = 32 * W;
  extern __shared__ __align__(16) float qs[];   // QT x d, then QT norms
  float* inv_q = qs + QT * d;

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

  const int n0 = (blockIdx.x * (THREADS / 32) + warp) * R;
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
  // every lane holds every sum; lane i * R + r writes (query i, row r)
  static_assert(QT * R == 32, "one output a lane");
  float mine = 0.f, inv_row = 0.f;
#pragma unroll
  for (int i = 0; i < QT; ++i)
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (lane == i * R + r) {
        mine = acc[i][r];
        inv_row = rsqrtf(sq[r] + EPS);
      }
  const int i = lane / R, r = lane % R;
  if (i < nq && n0 + r < n)
    out[(size_t)i * n + n0 + r] = mine * inv_q[i] * inv_row;
}

size_t gemv_smem(int d) { return ((size_t)QT * d + QT) * sizeof(float); }

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

constexpr size_t MAX_SMEM = 227 * 1024;

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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
