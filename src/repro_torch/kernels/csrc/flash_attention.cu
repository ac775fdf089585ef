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
// tensor cores with `wgmma`, bf16 operands and fp32 accumulation, one
// wgmma a k-step (N = the key tile for S, the staged value width for P
// V). The kernel is persistent: one block per SM, three warpgroups. Its
// work items (128 query rows of one (batch, head)) are ordered in runs of
// (batch, KV head) pairs whose K and V fit half the L2 cache, the heaviest
// first within a run, so that a pair's K and V come from memory about
// once; the blocks draw them from a counter as they come free (one with
// its heavy items behind does not hold up the rest), and the last block
// to finish resets the counter. One thread of warpgroup 2, the producer,
// loads each item's Q tile (two Q buffers where they fit) and each 128-key
// K and V tile by TMA (descriptors made on the host, 128-byte swizzle, or
// 64-byte at dh = 32) into two-stage K and V rings guarded by mbarriers
// (full: bytes arrived; empty: the consumers' warps done with it), tile
// i + 1's K before tile i's V; the rings run on across items.
// Warpgroups 0 and 1 each own 64 query rows: S = Q K^T (A and B from
// shared memory, K-major) accumulates in registers; the online softmax
// (running max and sum in fp32, exp2 of pre-scaled scores) works on the S
// fragments with quad shuffles; P is rounded to bf16 in registers and is
// the register A operand of O += P V, whose B (V, keys x dh, MN-major) is
// read with the transposed-B form. P never goes through shared memory.
// The consumers take turns at the tensor cores (FA3's schedule): a pair of
// named barriers passes the turn from one warpgroup to the other, and a
// turn issues one tile's S and the tile before's P V back to back, so one
// warpgroup's products run while the other computes its softmax; within
// a warpgroup, the softmax of a tile starts under the P V of the tile
// before (`wgmma.wait_group 1` retires S alone; ptxas places the wait for
// P V after the row max, and forcing the exponentials ahead of it too
// measured slower), then O is rescaled (skipped where no row's max moved)
// and the next P packed. ptxas serialises no instance's wgmmas. One S
// register set: two, for S of the next tile issued before the softmax of
// this one, would hold 2 x 64 S floats beside O and P at dh = 128. The
// finished rows go out as 16-byte stores (a quad's words transposed by
// shuffles). `setmaxnreg`
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
  static constexpr uint64_t LAYOUT = SWB == 128 ? 1 : 2;   // wgmma swizzle
  static constexpr int Q_BYTES = BQ * NCK * SWB;
  static constexpr int STAGES = 2;         // K and V stages
  static constexpr int BARS = 4 + 4 * STAGES;   // two Q buffers, the stages
  static constexpr int KEY_BYTES = (NCK + NCV) * SWB;   // K and V, a key
  // keys a tile: 128 where Q and two stages of 128-key K and V tiles fit
  // the 227 KB a block has, else 64 (dh = 256: 321 KB at 128 keys)
  static constexpr int BKV =
      1024 + Q_BYTES + STAGES * 128 * KEY_BYTES + 8 * BARS <= SMEM_MAX ? 128
                                                                        : 64;
  // Q buffers: two where they fit beside the stages, so that the next
  // item's Q loads while this item's last tiles run
  static constexpr int QBUF =
      1024 + 2 * Q_BYTES + STAGES * BKV * KEY_BYTES + 8 * BARS <= SMEM_MAX
          ? 2
          : 1;
  static constexpr int NS = BKV / 2;     // S floats a thread: one wgmma's
  static constexpr int NPV = NCV * SWE;  // the N of P V: dv, staged
  static constexpr int NOF = NPV / 2;    // O floats a thread: one wgmma's
  static constexpr int K_BYTES = BKV * NCK * SWB;
  static constexpr int V_BYTES = BKV * NCV * SWB;
  static constexpr size_t SMEM =
      1024 + QBUF * Q_BYTES + (size_t)STAGES * BKV * KEY_BYTES + 8 * BARS;
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
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define D8(o)                                                        \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),     \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// One wgmma an S or P V k-step: N = the key tile (64 or 128) for S, the
// staged value width (32, 64, 128 or 256) for P V, so each k-step reads
// its A once (an S k-step of two N = 64 halves read Q's slice twice from
// shared memory)
// d(64 x 64) (+)= A(64 x 16, shared, K-major) B(16 x 64, shared, K-major)
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d(64 x 128) (+)= A(64 x 16, shared, K-major) B(16 x 128, shared, K-major)
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d(64 x 32) += A(64 x 16, registers) B(16 x 32, shared, MN-major)
__device__ __forceinline__ void mma_rs(float (&d)[16], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d(64 x 64) += A(64 x 16, registers) B(16 x 64, shared, MN-major)
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d(64 x 128) += A(64 x 16, registers) B(16 x 128, shared, MN-major)
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d(64 x 256) += A(64 x 16, registers) B(16 x 256, shared, MN-major)
__device__ __forceinline__ void mma_rs(float (&d)[128], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, "
      "%71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, "
      "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, "
      "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, "
      "%121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56), D8(64),
        D8(72), D8(80), D8(88), D8(96), D8(104), D8(112), D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef D8

// 2^x on the special-function unit (flushes a subnormal result to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

// Work items in the order the blocks take them: in runs of `group`
// (batch, KV head) pairs, whose K and V the wrapper sizes to stay in the
// L2 cache while the run lasts (every query tile of a pair reads them
// again; with one head a KV head, an order over all pairs at once read
// them from memory each time), and within a run every pair's and head's
// last (heaviest, under a causal mask) query tile first. Under a window
// every tile past the first window's reads about as many key tiles, so the
// order no longer follows the work; it is kept.
template <class C>
__device__ __forceinline__ Work work_item(int w, int q_tiles, int batch,
                                          int s, int skv, int h, int hk,
                                          int causal, int window,
                                          int group) {
  constexpr int BKV = C::BKV;
  Work t;
  const int rep = h / hk;
  const int run = w / (group * q_tiles * rep);
  const int pairs = min(group, batch * hk - run * group);   // in this run
  const int wi = w - run * group * q_tiles * rep;
  const int z = wi / (pairs * rep), rem = wi % (pairs * rep);
  const int pair = run * group + rem / rep;
  t.b = pair / hk;
  t.kh = pair % hk;
  t.head = t.kh * rep + rem % rep;
  t.q0 = (q_tiles - 1 - z) * BQ;
  const int k_end = causal ? min(s, t.q0 + BQ) : skv;
  t.k_begin = 0;
  if (causal && window > 0) t.k_begin = max(0, t.q0 - window + 1) / BKV * BKV;
  t.tiles = (k_end - t.k_begin + BKV - 1) / BKV;
  return t;
}

// named barriers 1 and 2 (0 is __syncthreads'): barrier 1 + wg is
// warpgroup wg's turn at the tensor cores. A warpgroup waits for its turn
// on its own barrier and passes it on the other's; bar.sync and
// bar.arrive each count a warpgroup's 128 threads against 256.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// S = Q K^T over one key tile, one commit group, not waited for: one
// wgmma of N = BKV a k-step. Each k-step's first product starts from zero
// (scale-d 0), so sc needs no clearing.
template <int DK, int DV>
__device__ __forceinline__ void issue_qk(float (&sc)[Cfg<DK, DV>::NS],
                                         uint32_t qa, uint32_t kt) {
  using C = Cfg<DK, DV>;
  constexpr uint32_t SBO = 8 * C::SWB;   // 8-row groups of a swizzled tile
#pragma unroll
  for (int c = 0; c < C::NCK; ++c)
#pragma unroll
    for (int kq = 0; kq < C::SWE / 16; ++kq) {
      // the zero-filled columns past DK add nothing: skipped
      if (c * C::SWE + kq * 16 >= DK) continue;
      mma_ss(sc, gmma_desc<C>(qa + c * BQ * C::SWB + kq * 32, 16, SBO),
             gmma_desc<C>(kt + c * C::BKV * C::SWB + kq * 32, 16, SBO),
             (c | kq) != 0);
    }
  wg_commit();
}

// O += P V over one key tile (P: the bf16 A fragments in registers; V,
// keys x dv, MN-major in shared memory, its SWE-column chunks BKV * SWB
// bytes apart: the leading offset), one commit group, not waited for
template <int DK, int DV>
__device__ __forceinline__ void issue_pv(
    float (&o)[Cfg<DK, DV>::NOF],
    const uint32_t (&p)[Cfg<DK, DV>::BKV / 16][4], uint32_t vt) {
  using C = Cfg<DK, DV>;
  constexpr uint32_t SBO = 8 * C::SWB;
#pragma unroll
  for (int kk = 0; kk < C::BKV / 16; ++kk)
    mma_rs(o, p[kk],
           gmma_desc<C>(vt + kk * 16 * C::SWB, C::BKV * C::SWB, SBO));
  wg_commit();
}

// The online softmax of one tile's scores, in place: sc becomes the
// weights exp2(score * scale_log2 - m_sub) in fp32 (a masked score: 0
// exactly), one FFMA and one ex2 a score; m (in scaled units) and l move
// on to the tile, and corr is the factor that O, summed up to the last
// tile, is to be rescaled by. The max is taken over the raw scores and
// then scaled (scale_log2 > 0: the same value). m_sub: the running max,
// or 0 while a row has no key, so that a masked score gives exp2(-inf) =
// 0, never -inf - -inf.
template <int NS>
__device__ __forceinline__ void softmax_tile(float (&sc)[NS], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             bool need, int k0, int row_lo,
                                             int cq, int skv, int causal,
                                             int window, float scale_log2) {
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int r2 = (i / 2) % 2;
    if (need) {
      const int row = row_lo + 8 * r2;
      const int key = k0 + 8 * (i / 4) + cq + (i % 2);
      bool ok = key < skv;
      if (causal) {
        ok = ok && key <= row;
        if (window > 0) ok = ok && key > row - window;
      }
      if (!ok) sc[i] = -INFINITY;
    }
    tmax[r2] = fmaxf(tmax[r2], sc[i]);
  }
  float m_sub[2];
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    tmax[r2] = fmaxf(tmax[r2], __shfl_xor_sync(0xffffffffu, tmax[r2], 1));
    tmax[r2] = fmaxf(tmax[r2], __shfl_xor_sync(0xffffffffu, tmax[r2], 2));
    const float m_new = fmaxf(m[r2], tmax[r2] * scale_log2);
    m_sub[r2] = m_new == -INFINITY ? 0.f : m_new;
    corr[r2] = ex2(m[r2] - m_sub[r2]);
    m[r2] = m_new;
    l[r2] *= corr[r2];
  }
#pragma unroll
  for (int i = 0; i < NS; i += 2) {
    const int r2 = (i / 2) % 2;
    const float p0 = ex2(fmaf(sc[i], scale_log2, -m_sub[r2]));
    const float p1 = ex2(fmaf(sc[i + 1], scale_log2, -m_sub[r2]));
    l[r2] += p0 + p1;
    sc[i] = p0;
    sc[i + 1] = p1;
  }
}

// the weights in bf16, as the A fragments of P V: floats 8 kk .. 8 kk + 7
// of S are the 16-key step kk
template <int NS>
__device__ __forceinline__ void pack_p(uint32_t (&p)[NS / 8][4],
                                       const float (&sc)[NS]) {
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < N; ++j) o[j] *= corr[(j / 2) % 2];
}

template <int N>
__device__ __forceinline__ void pin_p(uint32_t (&p)[N][4]) {
#pragma unroll
  for (int kk = 0; kk < N; ++kk) pin(p[kk]);
}

template <int DK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ out, int s, int skv, int h,
                int hk, float scale_log2, int causal, int window, int batch,
                int q_tiles, int items, int group,
                int* __restrict__ sched) {
  using C = Cfg<DK, DV>;
  constexpr int BKV = C::BKV;
  extern __shared__ unsigned char smem_raw[];
  // tiles start on 1024 bytes, the period of the 128-byte swizzle
  const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ks = qs + C::QBUF * C::Q_BYTES;    // stage st: + st K_BYTES
  constexpr int STAGES = C::STAGES;
  const uint32_t vs = ks + STAGES * C::K_BYTES;     // stage st: + st V_BYTES
  const uint32_t bars = vs + STAGES * C::V_BYTES;
  auto q_full = [&](int qb) { return bars + 8 * qb; };
  auto q_empty = [&](int qb) { return bars + 8 * (2 + qb); };
  auto k_full = [&](int st) { return bars + 8 * (4 + st); };
  auto v_full = [&](int st) { return bars + 8 * (4 + STAGES + st); };
  auto k_empty = [&](int st) { return bars + 8 * (4 + 2 * STAGES + st); };
  auto v_empty = [&](int st) { return bars + 8 * (4 + 3 * STAGES + st); };
  const int tid = threadIdx.x;
  // the work items, in the order of work_item: each block's first is
  // blockIdx.x, the rest are drawn from sched[0] as blocks come free, so
  // a heavy item and a light one even out wherever they fall. The
  // producer hands each item's index to the consumers here, with the Q
  // tile's barrier (an index past the items ends the walk).
  __shared__ int item_sh[2];

  if (tid == 0) {
    // the empty barriers count the consumers' warps: lane 0 of each
    // arrives once its warp's products have read the tile
    for (int qb = 0; qb < C::QBUF; ++qb) {
      mbar_init(q_full(qb), 1);
      mbar_init(q_empty(qb), CONSUMERS / 32);
    }
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), CONSUMERS / 32);
      mbar_init(v_empty(st), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == CONSUMERS) {
      // the K and V rings run on across work items: kit and vit count
      // every K and V tile. Tile i + 1's K is loaded before tile i's V,
      // the order the consumers read them in.
      int kit = 0, vit = 0;
      auto load_k = [&](const Work& t, int i) {
        const int st = kit % STAGES;
        mbar_wait(k_empty(st), ((kit / STAGES) & 1) ^ 1);  // round 0 passes
        const uint32_t kt = ks + st * C::K_BYTES;
        mbar_expect_tx(k_full(st), C::K_BYTES);
#pragma unroll
        for (int c = 0; c < C::NCK; ++c)
          tma_load(kt + c * BKV * C::SWB, &tm_k, k_full(st), c * C::SWE,
                   t.kh, t.k_begin + i * BKV, t.b);
        ++kit;
      };
      auto load_v = [&](const Work& t, int i) {
        const int st = vit % STAGES;
        mbar_wait(v_empty(st), ((vit / STAGES) & 1) ^ 1);
        const uint32_t vt = vs + st * C::V_BYTES;
        mbar_expect_tx(v_full(st), C::V_BYTES);
#pragma unroll
        for (int c = 0; c < C::NCV; ++c)
          tma_load(vt + c * BKV * C::SWB, &tm_v, v_full(st), c * C::SWE,
                   t.kh, t.k_begin + i * BKV, t.b);
        ++vit;
      };
      for (int w = blockIdx.x, n = 0;; ++n) {
        const int qb = n % C::QBUF;
        const uint32_t q_free = ((n / C::QBUF) & 1) ^ 1;   // round 0 passes
        if (w >= items) {
          mbar_wait(q_empty(qb), q_free);
          item_sh[n & 1] = w;              // the end of the walk
          mbar_arrive(q_full(qb));
          // the last block to finish drawing resets the counters for
          // the next launch (or graph replay)
          if (atomicAdd(sched + 1, 1) == (int)gridDim.x - 1) {
            sched[0] = 0;
            sched[1] = 0;
          }
          break;
        }
        // the item after this one, drawn now: its number is back before
        // its first load
        const int next = gridDim.x + atomicAdd(sched, 1);
        const Work t =
            work_item<C>(w, q_tiles, batch, s, skv, h, hk, causal,
                         window, group);
        if (t.tiles > 0) load_k(t, 0);
        mbar_wait(q_empty(qb), q_free);    // the buffer's last Q is read
        item_sh[n & 1] = w;
        mbar_expect_tx(q_full(qb), C::Q_BYTES);
#pragma unroll
        for (int c = 0; c < C::NCK; ++c)
          tma_load(qs + qb * C::Q_BYTES + c * BQ * C::SWB, &tm_q,
                   q_full(qb), c * C::SWE, t.head, t.q0, t.b);
        for (int i = 0; i < t.tiles; ++i) {
          if (i + 1 < t.tiles) load_k(t, i + 1);
          load_v(t, i);
        }
        w = next;
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ----
    // Each turn at the tensor cores issues tile i's S = Q K^T and then
    // tile i - 1's O += P V, and passes the turn to the other warpgroup,
    // whose products then run under this one's softmax. The softmax of
    // tile i starts under P V of tile i - 1 (wait_group 1 retires S
    // alone); O is rescaled and P packed once that product is done.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid / 128;
    const int lane = tid % 32;
    const int cq = 2 * (lane % 4);
    int kit = 0, vit = 0;
    // the turns alternate 0, 1, 0, 1, ...: warpgroup 0's first turn of
    // the kernel waits for none, and after its last it takes warpgroup
    // 1's last pass, so every arrival on a barrier meets its wait
    bool opened = wg == 1;
    for (int n = 0;; ++n) {
      const int qb = n % C::QBUF;
      mbar_wait(q_full(qb), (n / C::QBUF) & 1);
      const int w = item_sh[n & 1];
      if (w >= items) {
        if (wg == 0 && opened) turn_wait(0);
        break;
      }
      const Work t =
          work_item<C>(w, q_tiles, batch, s, skv, h, hk, causal, window,
                       group);
      const uint32_t qa = qs + qb * C::Q_BYTES + wg * 64 * C::SWB;
      const int row_lo =
          t.q0 + wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
      const int first = t.q0 + wg * 64, last = first + 63;
      // whether tile k0 holds a masked score for these rows
      auto need = [&](int k0) {
        return k0 + BKV > skv ||
               (causal && (k0 + BKV - 1 > first ||
                           (window > 0 && k0 <= last - window)));
      };

      float o[C::NOF];
#pragma unroll
      for (int i = 0; i < C::NOF; ++i) o[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};
      float corr[2];
      float sc[C::NS];
      uint32_t p[BKV / 16][4];

      {
        // tile 0: S alone (every item has a tile: S_kv > 0)
        const int kst = kit % STAGES;
        mbar_wait(k_full(kst), (kit / STAGES) & 1);
        if (opened) turn_wait(wg);
        opened = true;
        pin(sc);
        wg_fence();
        issue_qk<DK, DV>(sc, qa, ks + kst * C::K_BYTES);
        turn_pass(wg);
        wg_wait0();
        pin(sc);
        if (lane == 0) mbar_arrive(k_empty(kst));       // K of tile 0 is read
        ++kit;
        softmax_tile(sc, m, l, corr, need(t.k_begin), t.k_begin, row_lo, cq,
                     skv, causal, window, scale_log2);
        pack_p(p, sc);                   // O is 0: nothing to rescale
      }
      for (int i = 1; i < t.tiles; ++i) {
        const int kst = kit % STAGES, vst = vit % STAGES;
        const int k0 = t.k_begin + i * BKV;
        mbar_wait(k_full(kst), (kit / STAGES) & 1);
        mbar_wait(v_full(vst), (vit / STAGES) & 1);
        turn_wait(wg);
        pin(sc);
        pin(o);
        pin_p(p);
        wg_fence();
        issue_qk<DK, DV>(sc, qa, ks + kst * C::K_BYTES);
        issue_pv<DK, DV>(o, p, vs + vst * C::V_BYTES);
        turn_pass(wg);
        wg_wait1();                      // S of tile i; P V still runs
        pin(sc);
        if (lane == 0) mbar_arrive(k_empty(kst));
        ++kit;
        softmax_tile(sc, m, l, corr, need(k0), k0, row_lo, cq, skv, causal,
                     window, scale_log2);
        wg_wait0();                      // P V of tile i - 1
        pin(o);
        pin_p(p);
        if (lane == 0) mbar_arrive(v_empty(vst));
        ++vit;
        // once the running max stops moving corr is 1 on every row, and
        // the warp skips the pass (a product by 1 changes nothing)
        if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f))
          rescale(o, corr);
        pack_p(p, sc);
      }
      // Q is no longer read: the producer may load the next item's
      if (lane == 0) mbar_arrive(q_empty(qb));
      {
        // the last tile's P V, outside the turns
        const int vst = vit % STAGES;
        mbar_wait(v_full(vst), (vit / STAGES) & 1);
        pin(o);
        pin_p(p);
        wg_fence();
        issue_pv<DK, DV>(o, p, vs + vst * C::V_BYTES);
        wg_wait0();
        pin(o);
        if (lane == 0) mbar_arrive(v_empty(vst));
        ++vit;
      }

#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        l[r2] += __shfl_xor_sync(0xffffffffu, l[r2], 1);
        l[r2] += __shfl_xor_sync(0xffffffffu, l[r2], 2);
        const int row = row_lo + 8 * r2;
        const float inv = 1.f / fmaxf(l[r2], 1e-30f);
        __nv_bfloat16* dst =
            out + (((size_t)t.b * s + row) * h + t.head) * DV;
        // a quad's words transposed by shuffles: each lane stores 16
        // bytes, columns 8 (4 a + lane % 4) .. + 7 (4-byte stores, one a
        // float pair, measured slower)
        const int t4 = lane & 3;
#pragma unroll
        for (int a = 0; a < C::NOF / 16; ++a) {
          uint32_t wd[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wd[j] = pack_bf16(o[4 * (4 * a + j) + 2 * r2] * inv,
                              o[4 * (4 * a + j) + 2 * r2 + 1] * inv);
#pragma unroll
          for (int mk = 1; mk <= 2; mk <<= 1) {
            uint32_t got[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              got[j] = __shfl_xor_sync(0xffffffffu, wd[j ^ mk], mk);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if ((j ^ t4) & mk) wd[j] = got[j];
          }
          const int col = 8 * (4 * a + t4);
          if (row < s && col < DV)    // none past S or the value width
            *reinterpret_cast<uint4*>(dst + col) =
                make_uint4(wd[0], wd[1], wd[2], wd[3]);
        }
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
                 int* sched, int b, int s, int skv, int h, int hk,
                 float scale, int causal, int window, cudaStream_t stream) {
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
    static int sms = 0, l2 = 0;
    if (sms == 0) {
      int dev = 0;
      err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
      if (err != cudaSuccess) return (int)err;
    }
    const int q_tiles = (s + BQ - 1) / BQ;
    const int items = q_tiles * h * b;
    // a run's pairs: their K and V in half the L2 cache, the runs of
    // one size (a short last run's heavy items would come last)
    const long long pair_bytes = 2LL * skv * (DK + DV);
    const int pairs = b * hk;
    const int most = (int)max(1LL, min((long long)pairs,
                                       l2 / 2 / max(pair_bytes, 1LL)));
    const int runs = (pairs + most - 1) / most;
    const int group = (pairs + runs - 1) / runs;
    flash_tc_kernel<DK, DV><<<min(items, sms), THREADS, C::SMEM, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(out), s, skv, h, hk,
        scale * 1.4426950408889634f, causal, window, b, q_tiles, items,
        group, sched);
    return (int)cudaGetLastError();
  }
};

}  // namespace tc

}  // namespace

// q: (B, S, H, dk), k: (B, S_kv, Hk, dk), v: (B, S_kv, Hk, dv), out: (B,
// S, H, dv), contiguous; (dk, dv) one of (dh, dh) at dh in {32, 64, 112,
// 128, 256} and (192, 128); S_kv != S only without the causal mask
// (cross-attention); dtype 0 = fp32 (CUDA cores), 1 = bf16 (tensor
// cores); window <= 0 disables the window. sched: two int32 counters of
// the bf16 route's work items, zero before the call and after it (the
// kernel resets them), unused by the fp32 route.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int* sched,
                                      int b, int s, int s_kv, int h, int hk,
                                      int dk, int dv, int dtype, float scale,
                                      int causal, int window,
                                      cudaStream_t stream) {
  if (causal && s_kv != s) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return by_widths<LaunchF32>(dk, dv, q, k, v, out, b, s, s_kv, h, hk,
                                scale, causal, window, stream);
  if (dtype == 1)
    return by_widths<tc::Launch>(dk, dv, q, k, v, out, sched, b, s, s_kv, h,
                                 hk, scale, causal, window, stream);
  return (int)cudaErrorInvalidValue;
}
