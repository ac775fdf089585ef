// Blocked causal prefill attention with an online softmax, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas` (body `_flash_kernel`)
// in src/repro/kernels/flash_attention.py: out = softmax(q k^T * scale,
// masked) v per (batch, head), GQA through kv head h / rep, optional
// sliding window (a key is kept where kpos <= qpos and kpos > qpos -
// window), fp32 running max, running sum and accumulator, q/k/v read as
// fp32 or bf16, the output written in the input type. Without the causal
// mask the keys may number S_kv != S (whisper's cross-attention: the
// decoder's prompt against the encoder's 1500 frames): the key loop, the
// tail mask and the K/V tensor maps run over S_kv, the work items over S.
//
// Bound: at the serving shape (B = 8, S = 1024, H = 32, Hk = 8, dh = 128,
// causal) the two products are 6.9e10 FLOP over 67 MB of bf16 traffic, so
// the work is bound by operations: 0.07 ms at the 989 TFLOP/s bf16
// tensor-core peak.
//
// Two routes, by input type:
//
// bf16 (every prefill of the serving path: the model's q, k and v are bf16
// even over an fp32 cache), `tc::flash_tc_kernel`: both products on the
// tensor cores with `wgmma`, bf16 operands and fp32 accumulation. The
// kernel is persistent: one block per SM, three warpgroups, walks the work
// items (128 query rows of one (batch, head)), the heaviest first. One
// thread of warpgroup 2, the producer, loads each item's Q tile once and
// each 128-key K and V tile by TMA (descriptors made on the host, 128-byte
// swizzle, or 64-byte at dh = 32) into a two-stage ring guarded by
// mbarriers (full: bytes arrived; empty: both consumers done); the ring
// runs on across items, so the next item's loads overlap this one's last
// products and its epilogue. Warpgroups 0 and 1 each own 64 query rows:
// S = Q K^T (A and B from shared memory, K-major) accumulates in
// registers; the online softmax (running max and sum in fp32, exp2 of
// pre-scaled scores) works on the S fragments with quad shuffles; P is
// rounded to bf16 in registers and is the register A operand of O += P V,
// whose B (V, keys x dh, MN-major) is read with the transposed-B form. P never goes through shared memory. `setmaxnreg`
// moves registers from the producer (24) to the consumers (240). TMA
// zero-fills rows past S, which gives the ragged tail; the scores there
// are masked. Rounding P to bf16 before the second product is the one
// numerical difference from an fp32-weight reference (the model's plain
// path rounds its weights to bf16 there too); `chip_smoke.py` derives its
// bar from it.
//
// fp32 (only the GPU tests reach it), `flash_kernel<float, DK, DV>`: the
// CUDA-core kernel, exact in fp32. One block per (64-row query tile, head,
// batch) with 256 threads in a 16 x 16 grid; Q, K and V tiles of 64 rows
// in shared memory, a thread owns 4 x 4 scores and 4 x dh / 16 outputs,
// the 64 x 64 probability tile goes through shared memory.
//
// Head widths 32, 64, 112, 128 and 256, the value as wide as the key, and
// one pair apart: a query/key width of 192 against a value width of 128
// (deepseek-v3's MLA prefill in its expanded form: 128 + 64 rope columns
// of q and k, 128 of v). Both routes are templates over the two widths
// (DK, DV). At dh = 256 (gemma3-12b) the bf16 route
// takes key tiles of 64 rows (Q 64 KB + two stages of K and V at 32 KB
// each: 193 KB of the 227 KB a block has; 128-key tiles would need 321
// KB), and each consumer holds its 64 x 256 fp32 O in 128 registers; the
// fp32 route's Q, K, V and P tiles take 213 KB, one block an SM. At (192,
// 128) Q is 48 KB and a stage 48 KB of K and 32 KB of V: 128-key tiles fit
// (209 KB). At dh = 112 (zamba2-7b) a row is staged 128 wide: the tensor
// maps' inner extent is 112 and their boxes 64 columns, so TMA fills
// columns 112..127 of the second chunk with zeros; Q K^T skips that
// chunk's last 16-column step, P V computes its 16 columns and the
// epilogue stores none of them. The fp32 route takes 112 as it is (7
// columns a thread).
//
// Both routes: key tiles past the diagonal are never loaded, nor tiles
// wholly before the window; heavier (later) query tiles are scheduled
// first. Masked scores give p = 0 exactly (never exp(-inf - -inf)), and
// the division guards the denominator with max(l, 1e-30), as the TPU
// kernel does, so a row with no key gives zeros, not NaN.
#include <cuda.h>          // CUtensorMap and its enums (no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int TM = 4;         // query rows per thread
constexpr int TN = 4;         // keys per thread

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// Row stride of a staged Q or K tile, in elements: an odd number of
// 32-bit words, so 16 lanes reading one column of 16 rows hit 16 banks.
template <typename T, int DH>
__host__ __device__ constexpr int row_stride() {
  return DH + (sizeof(T) == 4 ? 1 : 2);
}

template <typename T, int DK, int DV>
constexpr size_t smem_bytes() {
  return (size_t)(BQ + BK) * row_stride<T, DK>() * sizeof(T)  // Q, K
         + (size_t)BK * DV * sizeof(T)                         // V
         + (size_t)BK * (BQ + 1) * sizeof(float);              // P
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int s, int skv,
             int h, int hk, float scale, int causal, int window) {
  constexpr int RS = row_stride<T, DK>();
  constexpr int PS = BQ + 1;
  constexpr int TD = DV / 16;   // output columns per thread
  static_assert(DV % 16 == 0, "16 lanes over the value columns");
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + BQ * RS;
  T* vs = ks + BK * RS;
  float* ps = reinterpret_cast<float*>(vs + BK * DV);

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heavy tiles first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = head / (h / hk);
  const size_t q_row = (size_t)h * DK;    // elements between query rows
  const size_t k_row = (size_t)hk * DK;
  const size_t v_row = (size_t)hk * DV;
  const T* qb = q + ((size_t)b * s * h + head) * DK;
  const T* kb = k + ((size_t)b * skv * hk + kh) * DK;
  const T* vb = v + ((size_t)b * skv * hk + kh) * DV;

  for (int l = tid; l < BQ * DK; l += THREADS) {
    const int r = l / DK, c = l % DK;
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

  const int k_end = causal ? min(s, q0 + BQ) : skv;
  int k_begin = 0;
  if (causal && window > 0) k_begin = max(0, q0 - window + 1) / BK * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int l = tid; l < BK * DK; l += THREADS) {
      const int r = l / DK, c = l % DK;
      ks[r * RS + c] =
          k0 + r < skv ? kb[(k0 + r) * k_row + c] : from_f<T>(0.f);
    }
    for (int l = tid; l < BK * DV; l += THREADS) {
      const int r = l / DV, c = l % DV;
      vs[r * DV + c] =
          k0 + r < skv ? vb[(k0 + r) * v_row + c] : from_f<T>(0.f);
    }
    __syncthreads();

    // scores of this thread's 4 x 4 (query, key) pairs
    float sc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DK; ++d) {
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
        bool ok = kpos < skv;
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
        const float vv = to_f(vs[kk * DV + tx + 16 * j]);
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
    T* o = out + (((size_t)b * s + qpos) * h + head) * DV;
#pragma unroll
    for (int j = 0; j < TD; ++j) o[tx + 16 * j] = from_f<T>(acc[i][j] * inv);
  }
}

template <typename T, int DK, int DV>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s, int skv, int h, int hk, float scale, int causal,
           int window, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T, DK, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + BQ - 1) / BQ, h, b);
  flash_kernel<T, DK, DV><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s, skv, h, hk, scale,
      causal, window);
  return (int)cudaGetLastError();
}

// L<DK, DV>::run(args...) for the widths the kernels take: (dh, dh) at dh
// in {32, 64, 112, 128, 256}, and (192, 128)
template <template <int, int> class L, typename... A>
int by_widths(int dk, int dv, A... args) {
  if (dk == dv) {
    switch (dk) {
      case 32: return L<32, 32>::run(args...);
      case 64: return L<64, 64>::run(args...);
      case 112: return L<112, 112>::run(args...);
      case 128: return L<128, 128>::run(args...);
      case 256: return L<256, 256>::run(args...);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dk == 192 && dv == 128) return L<192, 128>::run(args...);
  return (int)cudaErrorInvalidValue;
}

template <int DK, int DV>
struct LaunchF32 {
  static int run(const void* q, const void* k, const void* v, void* out,
                 int b, int s, int skv, int h, int hk, float scale,
                 int causal, int window, cudaStream_t stream) {
    return launch<float, DK, DV>(q, k, v, out, b, s, skv, h, hk, scale,
                                 causal, window, stream);
  }
};

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA, warp-specialised
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 128;        // query rows per block: two consumers of 64
constexpr int STAGES = 2;      // K/V ring
constexpr int THREADS = 384;   // warpgroups 0, 1 consume; 2 loads
constexpr int CONSUMERS = 256;

constexpr int SMEM_MAX = 232448;   // dynamic shared memory a block

// DK: the query/key width, DV: the value width
template <int DK, int DV>
struct Cfg {
  // a row of a staged tile is cut into chunks of SWB bytes (the swizzle
  // width: 128, or 64 at dh = 32); chunk c of an R-row tile is R rows of
  // SWB bytes at offset c * R * SWB. A width that is no multiple of a
  // chunk (112) ends in a chunk that TMA fills with zeros past the width.
  static constexpr int SWB = DK * 2 < 128 ? DK * 2 : 128;
  static_assert((DV * 2 < 128 ? DV * 2 : 128) == SWB,
                "K and V tiles share one swizzle");
  static constexpr int SWE = SWB / 2;               // elements in a chunk row
  static constexpr int NCK = (DK + SWE - 1) / SWE;  // chunks in a Q or K row
  static constexpr int NCV = (DV + SWE - 1) / SWE;  // chunks in a V or O row
  static constexpr int NO = SWE / 2;           // O floats a thread, a chunk
  static constexpr uint64_t LAYOUT = SWB == 128 ? 1 : 2;   // wgmma swizzle
  static constexpr int Q_BYTES = BQ * NCK * SWB;
  static constexpr int BARS = 2 + 3 * STAGES;
  static constexpr int KEY_BYTES = (NCK + NCV) * SWB;   // K and V, a key
  // keys a tile: 128 where Q and two stages of 128-key K and V tiles fit
  // the 227 KB a block has, else 64 (dh = 256: 321 KB at 128 keys)
  static constexpr int BKV =
      1024 + Q_BYTES + STAGES * 128 * KEY_BYTES + 8 * BARS <= SMEM_MAX ? 128
                                                                      : 64;
  static constexpr int NH = BKV / 64;          // 64-key halves of S a tile
  static constexpr int K_BYTES = BKV * NCK * SWB;
  static constexpr int V_BYTES = BKV * NCV * SWB;
  static constexpr size_t SMEM =
      1024 + Q_BYTES + (size_t)STAGES * BKV * KEY_BYTES + 8 * BARS;
  static_assert(SMEM <= SMEM_MAX, "the tiles fit a block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 4-d tensor map (dh, heads, S, B) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle mode
template <class C>
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (C::LAYOUT << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define D8(o)                                                        \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),     \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// d(64 x 64) (+)= A(64 x 16, shared, K-major) B(16 x 64, shared, K-major)
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d(64 x 64) += A(64 x 16, registers) B(16 x 64, shared, MN-major)
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d(64 x 32) += A(64 x 16, registers) B(16 x 32, shared, MN-major)
__device__ __forceinline__ void mma_rs(float (&d)[16], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef D8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator fragments of a 64 x N wgmma (N / 2 floats a thread): float i
// of thread t (warp w of the warpgroup, lane l) is row 16 w + l / 4 +
// 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) + i % 2. Floats 8 kk .. 8 kk
// + 7 of S, rounded to bf16 in pairs, are exactly the A fragment of the
// 16-key step kk of P V.
// One work item: a 128-row query tile of one (batch, head), and the key
// tiles it reads.
struct Work {
  int b, head, kh, q0, k_begin, tiles;
};

// Work items in the order the blocks take them: every (batch, head) of
// the last (heaviest, under a causal mask) query tile first. Under a window
// every tile past the first window's reads about as many key tiles, so the
// order no longer follows the work; it is kept.
template <class C>
__device__ __forceinline__ Work work_item(int w, int q_tiles, int batch,
                                          int s, int skv, int h, int hk,
                                          int causal, int window) {
  constexpr int BKV = C::BKV;
  Work t;
  const int z = w / (h * batch), rem = w % (h * batch);
  t.head = rem % h;
  t.b = rem / h;
  t.kh = t.head / (h / hk);
  t.q0 = (q_tiles - 1 - z) * BQ;
  const int k_end = causal ? min(s, t.q0 + BQ) : skv;
  t.k_begin = 0;
  if (causal && window > 0) t.k_begin = max(0, t.q0 - window + 1) / BKV * BKV;
  t.tiles = (k_end - t.k_begin + BKV - 1) / BKV;
  return t;
}

template <int DK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ out, int s, int skv, int h,
                int hk, float scale_log2, int causal, int window, int batch,
                int q_tiles, int items) {
  using C = Cfg<DK, DV>;
  constexpr int BKV = C::BKV;
  extern __shared__ unsigned char smem_raw[];
  // tiles start on 1024 bytes, the period of the 128-byte swizzle
  const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ks = qs + C::Q_BYTES;              // stage st: + st K_BYTES
  const uint32_t vs = ks + STAGES * C::K_BYTES;     // stage st: + st V_BYTES
  const uint32_t bars = vs + STAGES * C::V_BYTES;
  const uint32_t q_full = bars;
  const uint32_t q_empty = bars + 8;
  auto k_full = [&](int st) { return bars + 8 * (2 + st); };
  auto v_full = [&](int st) { return bars + 8 * (2 + STAGES + st); };
  auto empty = [&](int st) { return bars + 8 * (2 + 2 * STAGES + st); };
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMERS);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == CONSUMERS) {
      // the ring runs on across work items: `it` counts every key tile
      int it = 0;
      for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
        const Work t =
            work_item<C>(w, q_tiles, batch, s, skv, h, hk, causal,
                         window);
        mbar_wait(q_empty, (n & 1) ^ 1);   // the last item's Q is read
        mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
        for (int c = 0; c < C::NCK; ++c)
          tma_load(qs + c * BQ * C::SWB, &tm_q, q_full, c * C::SWE, t.head,
                   t.q0, t.b);
        for (int i = 0; i < t.tiles; ++i, ++it) {
          const int st = it % STAGES;
          mbar_wait(empty(st), ((it / STAGES) & 1) ^ 1);   // round 0 passes
          const int k0 = t.k_begin + i * BKV;
          const uint32_t kt = ks + st * C::K_BYTES;
          const uint32_t vt = vs + st * C::V_BYTES;
          mbar_expect_tx(k_full(st), C::K_BYTES);
#pragma unroll
          for (int c = 0; c < C::NCK; ++c)
            tma_load(kt + c * BKV * C::SWB, &tm_k, k_full(st), c * C::SWE,
                     t.kh, k0, t.b);
          mbar_expect_tx(v_full(st), C::V_BYTES);
#pragma unroll
          for (int c = 0; c < C::NCV; ++c)
            tma_load(vt + c * BKV * C::SWB, &tm_v, v_full(st), c * C::SWE,
                     t.kh, k0, t.b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid / 128;
    const int lane = tid % 32;
    const int cq = 2 * (lane % 4);
    const uint32_t qa = qs + wg * 64 * C::SWB;
    constexpr uint32_t SBO = 8 * C::SWB;   // 8-row groups of a swizzled tile
    int it = 0;
    for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
      const Work t =
          work_item<C>(w, q_tiles, batch, s, skv, h, hk, causal, window);
      const int row_lo =
          t.q0 + wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
      const int first = t.q0 + wg * 64, last = first + 63;

      float o[C::NCV][C::NO];
#pragma unroll
      for (int c = 0; c < C::NCV; ++c)
#pragma unroll
        for (int i = 0; i < C::NO; ++i) o[c][i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};

      mbar_wait(q_full, n & 1);
      for (int i = 0; i < t.tiles; ++i, ++it) {
        const int st = it % STAGES;
        const uint32_t par = (it / STAGES) & 1;
        const int k0 = t.k_begin + i * BKV;
        const uint32_t kt = ks + st * C::K_BYTES;
        const uint32_t vt = vs + st * C::V_BYTES;

        // S = Q K^T: keys 0..63 of the tile in sc[0], 64..127 in sc[1]
        float sc[C::NH][32];
#pragma unroll
        for (int hh = 0; hh < C::NH; ++hh)
#pragma unroll
          for (int j = 0; j < 32; ++j) sc[hh][j] = 0.f;
        mbar_wait(k_full(st), par);
#pragma unroll
        for (int hh = 0; hh < C::NH; ++hh) pin(sc[hh]);
        wg_fence();
#pragma unroll
        for (int c = 0; c < C::NCK; ++c)
#pragma unroll
          for (int kq = 0; kq < C::SWE / 16; ++kq) {
            // the zero-filled columns past DK add nothing: skipped
            if (c * C::SWE + kq * 16 >= DK) continue;
            const uint64_t da =
                gmma_desc<C>(qa + c * BQ * C::SWB + kq * 32, 16, SBO);
#pragma unroll
            for (int hh = 0; hh < C::NH; ++hh)
              mma_ss_n64(sc[hh], da,
                         gmma_desc<C>(kt + c * BKV * C::SWB +
                                          hh * 64 * C::SWB + kq * 32,
                                      16, SBO),
                         (c | kq) != 0);
          }
        wg_commit();
        wg_wait0();
#pragma unroll
        for (int hh = 0; hh < C::NH; ++hh) pin(sc[hh]);

        // mask, running max, rescale
        const bool need = k0 + BKV > skv ||
                          (causal && (k0 + BKV - 1 > first ||
                                      (window > 0 && k0 <= last - window)));
        float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int hh = 0; hh < C::NH; ++hh)
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int r2 = (j / 2) % 2;
            float x = sc[hh][j] * scale_log2;
            if (need) {
              const int row = row_lo + 8 * r2;
              const int key = k0 + hh * 64 + 8 * (j / 4) + cq + (j % 2);
              bool ok = key < skv;
              if (causal) {
                ok = ok && key <= row;
                if (window > 0) ok = ok && key > row - window;
              }
              if (!ok) x = -INFINITY;
            }
            sc[hh][j] = x;
            tmax[r2] = fmaxf(tmax[r2], x);
          }
        // m_sub: the running max, or 0 while a row has no key, so that a
        // masked score gives exp2(-inf) = 0 exactly, never -inf - -inf
        float corr[2], m_sub[2];
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          tmax[r2] =
              fmaxf(tmax[r2], __shfl_xor_sync(0xffffffffu, tmax[r2], 1));
          tmax[r2] =
              fmaxf(tmax[r2], __shfl_xor_sync(0xffffffffu, tmax[r2], 2));
          const float m_new = fmaxf(m[r2], tmax[r2]);
          m_sub[r2] = m_new == -INFINITY ? 0.f : m_new;
          corr[r2] = exp2f(m[r2] - m_sub[r2]);
          m[r2] = m_new;
          l[r2] *= corr[r2];
        }
#pragma unroll
        for (int c = 0; c < C::NCV; ++c)
#pragma unroll
          for (int j = 0; j < C::NO; ++j) o[c][j] *= corr[(j / 2) % 2];

        // P in bf16, as the A fragments of P V
        uint32_t p[BKV / 16][4];
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hh = kk / 4, j = (kk % 4) * 8 + 2 * e, r2 = e % 2;
            const float x0 = sc[hh][j], x1 = sc[hh][j + 1];
            const float p0 = exp2f(x0 - m_sub[r2]);
            const float p1 = exp2f(x1 - m_sub[r2]);
            l[r2] += p0 + p1;
            p[kk][e] = pack_bf16(p0, p1);
          }

        // O += P V
        mbar_wait(v_full(st), par);
#pragma unroll
        for (int c = 0; c < C::NCV; ++c) pin(o[c]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
          for (int c = 0; c < C::NCV; ++c)
            mma_rs(o[c], p[kk],
                   gmma_desc<C>(vt + c * BKV * C::SWB + kk * 16 * C::SWB,
                                SBO, SBO));
        wg_commit();
        wg_wait0();
#pragma unroll
        for (int c = 0; c < C::NCV; ++c) pin(o[c]);
        mbar_arrive(empty(st));
      }
      // Q is no longer read: the producer may load the next item's
      mbar_arrive(q_empty);

#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        l[r2] += __shfl_xor_sync(0xffffffffu, l[r2], 1);
        l[r2] += __shfl_xor_sync(0xffffffffu, l[r2], 2);
        const int row = row_lo + 8 * r2;
        if (row >= s) continue;
        const float inv = 1.f / fmaxf(l[r2], 1e-30f);
        __nv_bfloat16* dst =
            out + (((size_t)t.b * s + row) * h + t.head) * DV;
#pragma unroll
        for (int c = 0; c < C::NCV; ++c)
#pragma unroll
          for (int j = 0; j < C::NO / 4; ++j)
            if (c * C::SWE + 8 * j < DV)    // none past the value width
              *reinterpret_cast<__nv_bfloat162*>(dst + c * C::SWE + 8 * j +
                                                 cq) =
                  __floats2bfloat162_rn(o[c][4 * j + 2 * r2] * inv,
                                        o[c][4 * j + 2 * r2 + 1] * inv);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the CUDA runtime has already
// loaded, so the library links no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (B, S, heads, width) bf16 tensor, boxes of `rows` rows x one chunk of
// C's swizzle (past `width`, TMA fills the box with zeros)
template <class C>
bool make_map(CUtensorMap* map, const void* ptr, int b, int s, int heads,
              int width, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)heads,
                              (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)width * 2,
                                 (cuuint64_t)heads * width * 2,
                                 (cuuint64_t)s * heads * width * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::SWE, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE,
                   C::SWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DK, int DV>
struct Launch {
  static int run(const void* q, const void* k, const void* v, void* out,
                 int b, int s, int skv, int h, int hk, float scale,
                 int causal, int window, cudaStream_t stream) {
    using C = Cfg<DK, DV>;
    if (encoder() == nullptr) return (int)cudaErrorNotSupported;
    CUtensorMap tq, tk, tv;
    if (!make_map<C>(&tq, q, b, s, h, DK, BQ) ||
        !make_map<C>(&tk, k, b, skv, hk, DK, C::BKV) ||
        !make_map<C>(&tv, v, b, skv, hk, DV, C::BKV))
      return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)C::SMEM);
    if (err != cudaSuccess) return (int)err;
    // persistent: one block per SM walks the work items
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      if (err != cudaSuccess) return (int)err;
    }
    const int q_tiles = (s + BQ - 1) / BQ;
    const int items = q_tiles * h * b;
    flash_tc_kernel<DK, DV><<<min(items, sms), THREADS, C::SMEM, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(out), s, skv, h, hk,
        scale * 1.4426950408889634f, causal, window, b, q_tiles, items);
    return (int)cudaGetLastError();
  }
};

}  // namespace tc

}  // namespace

// q: (B, S, H, dk), k: (B, S_kv, Hk, dk), v: (B, S_kv, Hk, dv), out: (B,
// S, H, dv), contiguous; (dk, dv) one of (dh, dh) at dh in {32, 64, 112,
// 128, 256} and (192, 128); S_kv != S only without the causal mask
// (cross-attention); dtype 0 = fp32 (CUDA cores), 1 = bf16 (tensor
// cores); window <= 0 disables the window.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int s,
                                      int s_kv, int h, int hk, int dk, int dv,
                                      int dtype, float scale, int causal,
                                      int window, cudaStream_t stream) {
  if (causal && s_kv != s) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return by_widths<LaunchF32>(dk, dv, q, k, v, out, b, s, s_kv, h, hk,
                                scale, causal, window, stream);
  if (dtype == 1)
    return by_widths<tc::Launch>(dk, dv, q, k, v, out, b, s, s_kv, h, hk,
                                 scale, causal, window, stream);
  return (int)cudaErrorInvalidValue;
}
