// Single-token decode attention against a KV cache (split-K flash
// decoding), for Hopper (sm_90a).
//
// Replaces the TPU kernel `decode_attention_pallas` (body `_decode_kernel`)
// in src/repro/kernels/decode_attention.py: out[b, h] = softmax(q[b, h] .
// k[b, t, h / rep] * scale over t < kv_len[b]) . v[b, t, h / rep], fp32
// softmax state, GQA through kv head h / rep.
//
// Bound: by bytes. Every valid cache row is read once (2 * Hk * dh values
// per position); at the serving shape (B = 16, T = 2048, H = 32, Hk = 8,
// dh = 128, an fp32 cache) that is up to 268 MB against 4 FLOP per cached
// value and query head: 33 us at 3.35 TB/s for a full cache.
//
// Design: the TPU kernel walks the cache of one (b, h) through a
// sequential grid axis; on the card B * H = 512 such rows are too few
// blocks for 132 SMs, and the H / Hk query heads that share a KV head
// would each read it again. So one block takes one (b, kv head, 128-key
// chunk) and computes ALL rep query heads of that KV head, reading each
// cache row once. Pass 1 scores the chunk (dh / 8 lanes per key, 8 values
// each as 16-byte loads, a shuffle reduction), pass 2 takes the chunk's
// max and sum of exponentials per head, pass 3 sums p . v with each
// thread owning one dh column (coalesced rows). The block writes a
// partial (max, sum, unnormalised accumulator); a second short kernel
// combines the chunks of each (b, h). The cache is read in its stored
// type and each value is rounded to the query's type in registers, the
// `ck.astype(q.dtype)` of the model's plain path, so no cast copy of the
// cache is ever made. Chunks past kv_len[b] exit at once, and a row with
// kv_len = 0 gives zeros (the denominator guard max(l, 1e-30) of the TPU
// kernel), never NaN.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CHUNK = 128;    // cache rows per block
constexpr int NT = 128;       // threads per block
constexpr int NWARPS = NT / 32;
constexpr int MAX_REP = 8;    // query heads per KV head

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
// a cache value as the query's type sees it
template <typename QT> __device__ __forceinline__ float as_q(float x) {
  return to_f(from_f<QT>(x));
}

// 8 consecutive cache values (16-byte aligned) as floats
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 raw = reinterpret_cast<const uint4*>(p)[0];
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = __bfloat162float(e[i]);
}

template <typename QT, typename CT, int DH>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const QT* __restrict__ q, const CT* __restrict__ k,
                    const CT* __restrict__ v, const int* __restrict__ kv_len,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int t, int h, int hk, int n_split, float scale) {
  constexpr int LPK = DH / 8;         // lanes per key in pass 1
  constexpr int KPW = 32 / LPK;       // keys per warp step
  constexpr int G = NT / DH;          // key groups in pass 3
  __shared__ float qsh[MAX_REP][DH];
  __shared__ float ssh[MAX_REP][CHUNK];
  __shared__ float red[G > 1 ? G * MAX_REP * DH : 1];

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int rep = h / hk;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int len = min(max(kv_len[b], 0), t);
  const int k0 = split * CHUNK;
  const int n = min(len - k0, CHUNK);   // valid keys of this chunk
  // partial index of query head kh * rep + r
  const size_t part0 = ((size_t)b * h + (size_t)kh * rep) * n_split + split;

  if (n <= 0) {
    for (int r = 0; r < rep; ++r) {
      const size_t pi = part0 + (size_t)r * n_split;
      for (int d = tid; d < DH; d += NT) part_acc[pi * DH + d] = 0.f;
      if (tid == 0) {
        part_ml[pi * 2] = -INFINITY;
        part_ml[pi * 2 + 1] = 0.f;
      }
    }
    return;
  }

  for (int l = tid; l < rep * DH; l += NT)
    qsh[l / DH][l % DH] =
        to_f(q[((size_t)b * h + (size_t)kh * rep) * DH + l]);
  __syncthreads();

  // pass 1: scores of the chunk, LPK lanes per key, 8 values a lane
  const int sub = lane / LPK, part = lane % LPK;
  float qr[MAX_REP][8];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qr[r][e] = r < rep ? qsh[r][part * 8 + e] : 0.f;
  const size_t row = (size_t)hk * DH;   // elements between cache rows
  const CT* kb = k + ((size_t)b * t + k0) * row + (size_t)kh * DH + part * 8;
  for (int jb = warp * KPW; jb < n; jb += NWARPS * KPW) {
    const int j = jb + sub;
    float kv[8];
    if (j < n) {
      load8(kb + (size_t)j * row, kv);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) kv[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) kv[e] = as_q<QT>(kv[e]);
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= rep) break;
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) dot += qr[r][e] * kv[e];
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (part == 0 && j < n) ssh[r][j] = dot * scale;
    }
  }
  __syncthreads();

  // pass 2: per head, the chunk's max and sum of exponentials
  for (int r = warp; r < rep; r += NWARPS) {
    float mx = -INFINITY;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, ssh[r][i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float p = expf(ssh[r][i] - mx);
      ssh[r][i] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      const size_t pi = part0 + (size_t)r * n_split;
      part_ml[pi * 2] = mx;
      part_ml[pi * 2 + 1] = sum;
    }
  }
  __syncthreads();

  // pass 3: acc[r][d] = sum_i p[r][i] v[i][d], thread (g, d) over keys g + G i
  const int d = tid % DH, g = tid / DH;
  float acc[MAX_REP];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) acc[r] = 0.f;
  const CT* vb = v + ((size_t)b * t + k0) * row + (size_t)kh * DH + d;
  for (int i = g; i < n; i += G) {
    const float vv = as_q<QT>(to_f(vb[(size_t)i * row]));
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r)
      if (r < rep) acc[r] += ssh[r][i] * vv;
  }
  if (G > 1) {
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r)
      if (r < rep) red[(g * MAX_REP + r) * DH + d] = acc[r];
    __syncthreads();
    if (g != 0) return;
    for (int gg = 1; gg < G; ++gg)
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r)
        if (r < rep) acc[r] += red[(gg * MAX_REP + r) * DH + d];
  }
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r)
    if (r < rep) part_acc[(part0 + (size_t)r * n_split) * DH + d] = acc[r];
}

// out[b, h] from the n_split partials of (b, h); one thread per column
template <typename QT, int DH>
__global__ void __launch_bounds__(DH)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml, QT* __restrict__ out,
                      int h, int n_split) {
  const int head = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const size_t base = ((size_t)b * h + head) * n_split;
  float mx = -INFINITY;
  for (int i = 0; i < n_split; ++i) mx = fmaxf(mx, part_ml[(base + i) * 2]);
  float l = 0.f, a = 0.f;
  if (mx != -INFINITY) {
    for (int i = 0; i < n_split; ++i) {
      const float mi = part_ml[(base + i) * 2];
      if (mi == -INFINITY) continue;
      const float w = expf(mi - mx);
      l += part_ml[(base + i) * 2 + 1] * w;
      a += part_acc[(base + i) * DH + d] * w;
    }
  }
  out[((size_t)b * h + head) * DH + d] = from_f<QT>(a / fmaxf(l, 1e-30f));
}

template <typename QT, typename CT, int DH>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* out, float* part_acc, float* part_ml, int b, int t, int h,
           int hk, float scale, cudaStream_t stream) {
  const int n_split = (t + CHUNK - 1) / CHUNK;
  decode_split_kernel<QT, CT, DH><<<dim3(n_split, hk, b), NT, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(k),
      static_cast<const CT*>(v), kv_len, part_acc, part_ml, t, h, hk,
      n_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<QT, DH><<<dim3(h, b), DH, 0, stream>>>(
      part_acc, part_ml, static_cast<QT*>(out), h, n_split);
  return (int)cudaGetLastError();
}

template <typename QT, typename CT>
int launch_dh(const void* q, const void* k, const void* v, const int* kv_len,
              void* out, float* part_acc, float* part_ml, int b, int t,
              int h, int hk, int dh, float scale, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<QT, CT, 32>(q, k, v, kv_len, out, part_acc, part_ml, b,
                                t, h, hk, scale, stream);
    case 64:
      return launch<QT, CT, 64>(q, k, v, kv_len, out, part_acc, part_ml, b,
                                t, h, hk, scale, stream);
    case 128:
      return launch<QT, CT, 128>(q, k, v, kv_len, out, part_acc, part_ml, b,
                                 t, h, hk, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int decode_attention_chunk() { return CHUNK; }

// q: (B, H, dh); k/v: (B, T, Hk, dh); kv_len: (B,) int32; out: (B, H, dh);
// part_acc: (B, H, n_split, dh) and part_ml: (B, H, n_split, 2) fp32
// scratch, n_split = ceil(T / chunk). q_dtype/kv_dtype: 0 = fp32, 1 = bf16;
// the pairs are (fp32, fp32), (bf16, fp32) and (bf16, bf16).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* kv_len,
                                       void* out, float* part_acc,
                                       float* part_ml, int b, int t, int h,
                                       int hk, int dh, int q_dtype,
                                       int kv_dtype, float scale,
                                       cudaStream_t stream) {
  if (h % hk != 0 || h / hk > MAX_REP) return (int)cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_dh<float, float>(q, k, v, kv_len, out, part_acc, part_ml,
                                   b, t, h, hk, dh, scale, stream);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_dh<__nv_bfloat16, float>(q, k, v, kv_len, out, part_acc,
                                           part_ml, b, t, h, hk, dh, scale,
                                           stream);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_dh<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, kv_len, out, part_acc, part_ml, b, t, h, hk, dh, scale,
        stream);
  return (int)cudaErrorInvalidValue;
}
