// Blocked causal prefill attention with an online softmax, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas` (body `_flash_kernel`)
// in src/repro/kernels/flash_attention.py: out = softmax(q k^T * scale,
// masked) v per (batch, head), GQA through kv head h / rep, optional
// sliding window (a key is kept where kpos <= qpos and kpos > qpos -
// window), fp32 running max, running sum and accumulator, q/k/v read as
// fp32 or bf16, the output written in the input type.
//
// Bound: at the serving shape (B = 8, S = 1024, H = 32, Hk = 8, dh = 128,
// causal) the two products are 6.9e10 FLOP over 67 MB of bf16 traffic, so
// the work is bound by operations: 0.07 ms at the 989 TFLOP/s bf16
// tensor-core peak. This first kernel runs its products as fp32 FMAs on
// the CUDA cores (67 TFLOP/s peak), which is simple and exact for both
// input types; the tensor cores (mma.sync / wgmma with TMA) are later
// work.
//
// Design: one block per (64-row query tile, head, batch) with 256 threads
// in a 16 x 16 grid. The TPU kernel's 128 x 128 tiles at dh = 128 in fp32
// are 64 KB each, too many of them for a block's 227 KB on Hopper: here Q,
// K and V tiles of 64 rows are staged in shared memory in their input type
// (bf16 halves them) and the 64 x 64 probability tile in fp32, 66 KB for
// bf16 and 115 KB for fp32 at dh = 128. A thread owns query rows ty + 16 i
// and keys tx + 16 j (4 x 4 scores) and output columns tx + 16 j (4 x
// dh / 16 accumulators), so shared reads are broadcast or conflict-free
// (rows are padded to an odd number of words). Row max and row sum are
// reduced across the 16 lanes that share a row with shuffles. Key tiles
// past the diagonal are never loaded, nor tiles wholly before the window.
// Masked scores give p = 0 exactly (never exp(-inf - -inf)), and the
// division guards the denominator with max(l, 1e-30), as the TPU kernel
// does, so a row with no key gives zeros, not NaN. Heavier (later) query
// tiles are scheduled first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int TM = 4;         // query rows per thread
constexpr int TN = 4;         // keys per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Row stride of a staged Q or K tile, in elements: an odd number of
// 32-bit words, so 16 lanes reading one column of 16 rows hit 16 banks.
template <typename T, int DH>
__host__ __device__ constexpr int row_stride() {
  return DH + (sizeof(T) == 4 ? 1 : 2);
}

template <typename T, int DH>
constexpr size_t smem_bytes() {
  return (size_t)(BQ + BK) * row_stride<T, DH>() * sizeof(T)  // Q, K
         + (size_t)BK * DH * sizeof(T)                         // V
         + (size_t)BK * (BQ + 1) * sizeof(float);              // P
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int s, int h,
             int hk, float scale, int causal, int window) {
  constexpr int RS = row_stride<T, DH>();
  constexpr int PS = BQ + 1;
  constexpr int TD = DH / 16;   // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + BQ * RS;
  T* vs = ks + BK * RS;
  float* ps = reinterpret_cast<float*>(vs + BK * DH);

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heavy tiles first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = head / (h / hk);
  const size_t q_row = (size_t)h * DH;    // elements between query rows
  const size_t k_row = (size_t)hk * DH;
  const T* qb = q + ((size_t)b * s * h + head) * DH;
  const T* kb = k + ((size_t)b * s * hk + kh) * DH;
  const T* vb = v + ((size_t)b * s * hk + kh) * DH;

  for (int l = tid; l < BQ * DH; l += THREADS) {
    const int r = l / DH, c = l % DH;
    qs[r * RS + c] = (q0 + r < s) ? qb[(q0 + r) * q_row + c] : from_f<T>(0.f);
  }

  float m[TM], lsum[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -INFINITY;
    lsum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }

  const int k_end = causal ? min(s, q0 + BQ) : s;
  int k_begin = 0;
  if (causal && window > 0) k_begin = max(0, q0 - window + 1) / BK * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int l = tid; l < BK * DH; l += THREADS) {
      const int r = l / DH, c = l % DH;
      const bool in = k0 + r < s;
      ks[r * RS + c] = in ? kb[(k0 + r) * k_row + c] : from_f<T>(0.f);
      vs[r * DH + c] = in ? vb[(k0 + r) * k_row + c] : from_f<T>(0.f);
    }
    __syncthreads();

    // scores of this thread's 4 x 4 (query, key) pairs
    float sc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float a[TM], bk[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = to_f(qs[(ty + 16 * i) * RS + d]);
#pragma unroll
      for (int j = 0; j < TN; ++j) bk[j] = to_f(ks[(tx + 16 * j) * RS + d]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) sc[i][j] += a[i] * bk[j];
    }

    // online softmax over the tile: the 16 lanes tx = 0..15 of a warp half
    // share each row
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < s;
        if (causal) {
          ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
        }
        sc[i][j] = ok ? sc[i][j] * scale : -INFINITY;
        tmax = fmaxf(tmax, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      const float corr = (m_new == -INFINITY) ? 1.f : expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = (sc[i][j] == -INFINITY) ? 0.f : expf(sc[i][j] - m_new);
        rsum += p;
        ps[(tx + 16 * j) * PS + ty + 16 * i] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      lsum[i] = lsum[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc += P V
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) p[i] = ps[kk * PS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TD; ++j) {
        const float vv = to_f(vs[kk * DH + tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][j] += p[i] * vv;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= s) continue;
    const float inv = 1.f / fmaxf(lsum[i], 1e-30f);
    T* o = out + (((size_t)b * s + qpos) * h + head) * DH;
#pragma unroll
    for (int j = 0; j < TD; ++j) o[tx + 16 * j] = from_f<T>(acc[i][j] * inv);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s, int h, int hk, float scale, int causal, int window,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes<T, DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + BQ - 1) / BQ, h, b);
  flash_kernel<T, DH><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s, h, hk, scale,
      causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* out, int b,
              int s, int h, int hk, int dh, float scale, int causal,
              int window, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, out, b, s, h, hk, scale, causal, window,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, out, b, s, h, hk, scale, causal, window,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, out, b, s, h, hk, scale, causal,
                            window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, S, H, dh), k/v: (B, S, Hk, dh), out: (B, S, H, dh), contiguous;
// dtype 0 = fp32, 1 = bf16; window <= 0 disables the window.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int s,
                                      int h, int hk, int dh, int dtype,
                                      float scale, int causal, int window,
                                      cudaStream_t stream) {
  if (dtype == 0)
    return launch_dh<float>(q, k, v, out, b, s, h, hk, dh, scale, causal,
                            window, stream);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, out, b, s, h, hk, dh, scale,
                                    causal, window, stream);
  return (int)cudaErrorInvalidValue;
}
