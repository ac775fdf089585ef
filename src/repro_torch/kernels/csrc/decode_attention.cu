// Single-token decode attention against a KV cache, for Hopper (sm_90a):
// one pipelined pass over the cache, the splits' combine in the same
// launch.
//
// Replaces the TPU kernel `decode_attention_pallas` (body `_decode_kernel`)
// in src/repro/kernels/decode_attention.py: out[b, h] = softmax(q[b, h] .
// k[b, t, h / rep] * scale over t < kv_len[b]) . v[b, t, h / rep], fp32
// softmax state, GQA through kv head h / rep. With a window w > 0 only the
// rows kv_len[b] - w <= t < kv_len[b] count: the query at position
// kv_len[b] - 1 under a sliding window over the full cache (gemma3's local
// layers; the JAX model computes that decode in jnp `attend`, the TPU
// kernel has no window).
//
// Bound: by bytes. Every valid cache row is read once (2 * Hk * dh values
// per position) against 4 FLOP per cached value and query head; at the
// qwen3-8b serving layout (B = 16, T = 2048, H = 32, Hk = 8, dh = 128, an
// fp32 cache, ~20,000 valid rows) that is ~165 MB, 49 us at 3.35 TB/s.
// What keeps a kernel from that rate is bytes not in flight: a load
// issued and waited on at once, or passes that run with no load
// outstanding, and too few warps on an SM to cover the latency of the
// arithmetic between two loads.
//
// Design. One block takes one (b, kv head, split), a split being a
// contiguous range of `split_rows` cache rows, and computes all rep query
// heads of that kv head, so each cache row is read once. The wrapper
// chooses the split count from the card (`decode_attention.split_plan`:
// about four waves of blocks over the SMs, at least four stages a split),
// static for a given (B, T, Hk, dh), so CUDA graphs stay valid. Splits
// that start at or past kv_len[b], or end at or before the window's first
// row max(0, kv_len[b] - w) (computed on the device, so one captured graph
// serves every position), exit at once; the arrival count and the merge
// take the splits in between only.
//
// Inside its split a block streams the rows through a ring of two 32 KB
// stages in shared memory, each holding ROWS rows of K and the same rows
// of V, filled by 16-byte `cp.async` copies: while stage i is computed,
// stage i + 1 is in flight, and one barrier a stage hands a consumed stage
// back. Rows past kv_len are zero-filled without a read. Three blocks fit
// an SM (12 warps). On the H100 three stages of 32 KB (two blocks an SM),
// 64-thread blocks over 16 KB stages, a ring of 32-row stages and per-row
// TMA bulk copies all read slower or no faster. Each warp takes
// its own ROWS / 4 rows of a stage, 8 at a step, and keeps its own online
// softmax (running max and sum per head, a rescaled fp32 accumulator): no
// block-wide pass waits on another. At dh = 256 over an fp32 cache a stage
// holds 16 rows, two steps: on the CUDA cores the warps take the steps of
// successive stages in turn (stage s's to warps 2s mod 4 and 2s + 1 mod
// 4), so the stage keeps its 32 KB and three blocks an SM. Two ways to
// compute a step:
//   tensor cores (a bf16 query over rep >= 2 heads: qwen3-8b, phi3.5-moe):
//     the heads are the rows of `mma.sync` tiles (`stream_mma`), so the
//     products and the softmax's shuffles cost the same at any rep. At
//     dh = 256 (gemma3-12b) every warp takes the whole stage instead
//     (`stream_mma256`): warp w computes P V for value columns 64 w .. 64
//     w + 63, the stage's scores are four partial sums (one a warp's
//     columns) added through shared memory, so the warps keep equal
//     softmax states and their merge is a concatenation of columns; no
//     warp idles on a stage, and a lane holds 8 registers of Q and 16 of
//     O (the one-warp-a-step form held 32 and 64 and spilled);
//   CUDA cores (an fp32 query, or one head a KV head):
//     scores: lane (key, part) dots a quarter of the key's 16-byte chunks
//       with every head's query (broadcast reads from shared memory), two
//       shuffles a head sum the quarters; odd keys walk the chunks from
//       another quad, so the two keys of a quarter-warp read different
//       banks;
//     p . v: lane (key group, column group) owns 4 contiguous columns
//       (at dh = 256: two groups of 4, 128 columns apart) and reads them
//       for its keys (one 16- or 8-byte read a row); the step's weights
//       come from shared memory, not from shuffles.
//     The registers hold REP heads, rep rounded up to 1, 2, 4 or 8.
//
// Combine. The four warps' states merge in shared memory. A split that
// is its pair's only one writes the output. Otherwise it writes its
// partial (max, sum, unnormalised accumulator per head) to scratch,
// fences, and counts itself on the pair's arrival counter; the last of
// the pair's active splits (those that cover kv_len[b]) merges them and
// writes the output, then resets the counter to 0, so the counters are
// zero again for the next call or graph replay. No second launch.
//
// Head widths 32, 64, 112, 128 and 256. A width that is no power of two
// (112: zamba2-7b's 32 heads over d = 3584) is staged at the next one
// (128): each cache row's 16-byte chunks land as they are, the chunks past
// the width are zero-filled without a read, and the queries are zero there
// too, so the scores are the 112-column ones; the stage keeps its rows and
// lane splits of dh = 128, the padded columns' p . v sums are computed and
// never stored. The cache is read at its own width (no padded copy), so
// the bytes moved are the 112-column ones.
//
// The cache is read in its stored type and each value is rounded to the
// query's type in registers (the `ck.astype(q.dtype)` of the model's
// plain path), so no cast copy of the cache is made. Products and sums
// are fp32 (on the tensor cores: bf16 products, which are exact, summed in
// fp32); exponentials are exp2 of scores scaled by log2(e). A row with
// kv_len = 0 gives zeros (the denominator guard max(l, 1e-30) of the TPU
// kernel), never NaN.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int NT = 128;               // threads a block
constexpr int NW = NT / 32;
constexpr int MIN_BLOCKS = 3;         // resident an SM (shared memory)
constexpr int MAX_REP = 8;            // query heads a KV head
constexpr int RING_BYTES = 65536;     // the ring of stages a block
constexpr int STEP = 8;               // a warp's keys a step (4 lanes a key)
constexpr float LOG2E = 1.4426950408889634f;

// the width a cache row of dh columns is staged at: the next power of two
constexpr int staged(int dh) {
  return dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 128 ? 128 : 256;
}

template <typename CT, int DH>
struct Tile {
  static constexpr int DP = staged(DH);           // staged row width
  static constexpr int ROW_BYTES = DP * (int)sizeof(CT);
  static constexpr int CPR = ROW_BYTES / 16;      // 16-byte chunks a row
  static constexpr int CPG = DH * (int)sizeof(CT) / 16;  // of them, read
  static constexpr int VPC = 16 / (int)sizeof(CT);  // values a chunk
  static constexpr int STAGE = 32768;                  // K and V bytes
  static constexpr int ROWS = STAGE / (2 * ROW_BYTES);  // a stage's rows
  static constexpr int STAGES = RING_BYTES / STAGE;
  static constexpr int SPS = ROWS / STEP;         // a stage's steps
  static constexpr int WROWS = ROWS / NW;         // a warp's, a stage
  static constexpr int C4 = DP / 4;               // 4-column groups a row
  static constexpr int C4G = DH / 4;              // of them, stored
  static constexpr int CG = C4 < 32 ? C4 : 32;    // p . v: lanes over them
  static constexpr int NCG = C4 / CG;             // p . v: groups a lane
  static constexpr int KG = 32 / CG;  // p . v: key groups in a warp
  static_assert(CPR % 4 == 0 && ROWS % STEP == 0 &&
                    (SPS % NW == 0 || NW % SPS == 0) && C4 % CG == 0 &&
                    CPG * 16 == DH * (int)sizeof(CT),
                "stage shape");
  static_assert(RING_BYTES >= NW * MAX_REP * (DP + 2) * 4,
                "the warps' merge fits in the stages");
};

// dynamic shared memory: the stages, the queries (at the staged width),
// the step's weights
constexpr size_t smem_bytes(int dh, int rep) {
  return (size_t)RING_BYTES + (size_t)rep * staged(dh) * 4 +
         (size_t)NW * rep * STEP * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;    // 0: zero-fill, no read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// N cache values at p (16 or 8 bytes) as floats, rounded to QT as the
// plain path's cast does
template <typename QT, typename CT, int N>
__device__ __forceinline__ void load_vals(const unsigned char* p, float* o) {
  if constexpr (std::is_same<CT, float>::value) {
    static_assert(N == 4, "fp32: 4 values");
    const float4 a = *reinterpret_cast<const float4*>(p);
    if constexpr (std::is_same<QT, float>::value) {
      o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    } else {
      const float2 x = __bfloat1622float2(__floats2bfloat162_rn(a.x, a.y));
      const float2 y = __bfloat1622float2(__floats2bfloat162_rn(a.z, a.w));
      o[0] = x.x; o[1] = x.y; o[2] = y.x; o[3] = y.y;
    }
  } else {
    // a bf16 value is the high half of the float it widens to
    static_assert(N == 4 || N == 8, "bf16: 4 or 8 values");
    unsigned w[N / 2];
    if constexpr (N == 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p);
      w[0] = raw.x; w[1] = raw.y; w[2] = raw.z; w[3] = raw.w;
    } else {
      const uint2 raw = *reinterpret_cast<const uint2*>(p);
      w[0] = raw.x; w[1] = raw.y;
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// the physical 16-byte chunk of chunk c in stage row r for the tensor-core
// path (its fragment reads walk one column over 8 rows): c ^ (r mod 8),
// and for rows of four chunks c ^ (r / 2 mod 4); the CUDA-core path keeps
// rows as they are
template <bool SWZ, int CPR>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (!SWZ) return c;
  else if constexpr (CPR >= 8) return c ^ (r & 7);
  else return c ^ ((r >> 1) & 3);
}

// issue the copies of split rows [r0, r0 + ROWS) into a stage (rows in
// order); rows at or past n, and a staged row's chunks past the cache's
// width, are zero-filled without a read
template <bool SWZ, typename CT, int DH>
__device__ __forceinline__ void load_stage(unsigned char* st, const CT* kb,
                                           const CT* vb, size_t row_stride,
                                           int r0, int n, int tid) {
  using TL = Tile<CT, DH>;
  constexpr int CHUNKS = TL::ROWS * TL::CPR;    // of K, and of V
  static_assert(CHUNKS % NT == 0, "whole copies a thread");
#pragma unroll
  for (int j = 0; j < CHUNKS / NT; ++j) {
    const int i = tid + j * NT;
    const int row = i / TL::CPR, c = i % TL::CPR;
    const bool ok = r0 + row < n && (TL::CPG == TL::CPR || c < TL::CPG);
    const size_t off = (size_t)(ok ? r0 + row : 0) * row_stride +
                       (size_t)c * TL::VPC;
    const int dst = row * TL::ROW_BYTES + swz<SWZ, TL::CPR>(row, c) * 16;
    cp_async16(st + dst, kb + off, ok);
    cp_async16(st + TL::STAGE / 2 + dst, vb + off, ok);
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// two floats as bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&x);
}
__device__ __forceinline__ void mma_k16(float* c, unsigned a0, unsigned a2,
                                        unsigned b0, unsigned b1) {
  // rows 8..15 of A are zero: at most 8 heads
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}
// c: rows 0..7 of the tile (the heads); rows 8..15 of A are zero, their
// sums start at 0 and are dropped, so they hold no registers between steps
__device__ __forceinline__ void mma_k8(float* c, unsigned a0, unsigned b0) {
  float d2, d3;
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %7, %7};\n"
      : "+f"(c[0]), "+f"(c[1]), "=f"(d2), "=f"(d3)
      : "r"(a0), "r"(0u), "r"(b0), "f"(0.f));
}
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(unsigned* r, unsigned addr) {
  if constexpr (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

// Streams the split's n_stages stages through the ring: waits for stage
// s, hands the consumed stage back to the copies of stage s + 1, and
// calls step(ks, vs, row0, stage_n) for each of this warp's 8-row steps
// that starts below stage_n (the stage's valid rows; ks, vs: its K and V
// rows). On return the copies are done and the ring is free.
template <bool SWZ, typename CT, int DH, bool WHOLE = false, typename Step>
__device__ __forceinline__ void stream(unsigned char* smem, const CT* kb,
                                       const CT* vb, size_t row_stride,
                                       int n, int n_stages, Step&& step) {
  using TL = Tile<CT, DH>;
  const int warp = threadIdx.x / 32;
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<TL::STAGES - 2>();
    __syncthreads();    // stage s landed; stage s - 1 consumed by all
    const int nxt = s + TL::STAGES - 1;
    if (nxt < n_stages)
      load_stage<SWZ, CT, DH>(smem + (nxt % TL::STAGES) * TL::STAGE, kb, vb,
                              row_stride, nxt * TL::ROWS, n, threadIdx.x);
    cp_async_commit();
    const unsigned char* ks = smem + (s % TL::STAGES) * TL::STAGE;
    const int stage_n = min(TL::ROWS, n - s * TL::ROWS);
    if constexpr (WHOLE) {
      // every warp takes the whole stage
      step(ks, ks + TL::STAGE / 2, 0, stage_n);
    } else if constexpr (TL::SPS >= NW) {
#pragma unroll 1
      for (int row0 = warp * TL::WROWS;
           row0 < (warp + 1) * TL::WROWS && row0 < stage_n; row0 += STEP)
        step(ks, ks + TL::STAGE / 2, row0, stage_n);
    } else {
      // fewer steps than warps: step j of stage s to warp (s SPS + j) % NW
      const int j = (warp + NW - (s * TL::SPS) % NW) % NW;
      if (j < TL::SPS && j * STEP < stage_n)
        step(ks, ks + TL::STAGE / 2, j * STEP, stage_n);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The CUDA-core path (fp32 queries, or rep = 1; fp32 products): each
// warp's online softmax over its steps, then the warps' states in shared
// memory: racc [NW][REP][DP], rml [NW][REP][2] at the ring (DP: the staged
// width; the queries qsh are [REP][DP], zero past DH).
template <typename QT, typename CT, int DH, int REP>
__device__ __forceinline__ void stream_cores(unsigned char* smem,
                                             const float* qsh, float* psh,
                                             const CT* kb, const CT* vb,
                                             size_t row_stride, int n,
                                             int n_stages, int rep) {
  using TL = Tile<CT, DH>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int key = lane / 4, part = lane % 4;     // scores
  const int cg = lane % TL::CG, kg = lane / TL::CG;   // p . v
  float* pw = psh + warp * REP * STEP;
  constexpr int NA = 4 * TL::NCG;     // accumulated columns a lane
  float m_run[REP], l_run[REP], acc[REP][NA];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int e = 0; e < NA; ++e) acc[r][e] = 0.f;
  }
  // byte offset of this lane's 4 columns in a row
  constexpr int COL_BYTES = 4 * (int)sizeof(CT);

  stream<false, CT, DH>(smem, kb, vb, row_stride, n, n_stages,
                        [&](const unsigned char* ks, const unsigned char* vs,
                            int row0, int stage_n) {
    const int row = row0 + key;
    float sc[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) sc[r] = 0.f;
    // chunks at a time: at dh = 256 and 8 heads, every chunk's loads
    // unrolled at once held more than the 168 registers that three blocks
    // an SM leave a thread, and spilled; two at a time (and two keys at a
    // time below) do not
    constexpr int IU = DH == 256 && REP == 8 ? 2 : TL::CPR / 4;
#pragma unroll 1
    for (int i0 = 0; i0 < TL::CPR / 4; i0 += IU)
#pragma unroll
    for (int i = i0; i < i0 + IU; ++i) {
      // odd keys take the quads in another order: the two keys that
      // share a quarter-warp read different banks
      const int c = part + 4 * ((i + (key & 1)) % (TL::CPR / 4));
      float kv[TL::VPC];
      load_vals<QT, CT, TL::VPC>(ks + row * TL::ROW_BYTES + c * 16, kv);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        if (r < rep) {
          const float4* qp =
              reinterpret_cast<const float4*>(qsh + r * TL::DP + c * TL::VPC);
#pragma unroll
          for (int e = 0; e < TL::VPC / 4; ++e) {
            const float4 qq = qp[e];
            sc[r] += qq.x * kv[4 * e] + qq.y * kv[4 * e + 1] +
                     qq.z * kv[4 * e + 2] + qq.w * kv[4 * e + 3];
          }
        }
      }
    }
    const bool valid = row < stage_n;
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (r < rep) {
        float x = sc[r];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        x = valid ? x : -INFINITY;
        float mx = x;
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        // key 0 of the step is valid, so mx is finite
        const float m_new = fmaxf(m_run[r], mx);
        const float corr = exp2f(m_run[r] - m_new);
        const float p = exp2f(x - m_new);
        m_run[r] = m_new;
        l_run[r] = l_run[r] * corr + p;   // this lane's key's share
#pragma unroll
        for (int e = 0; e < NA; ++e) acc[r][e] *= corr;
        if (part == 0) pw[r * STEP + key] = p;
      }
    }
    __syncwarp();
    constexpr int JU = DH == 256 && REP == 8 ? 2 : STEP;
    static_assert(JU == STEP || TL::KG == 1, "keys a lane");
#pragma unroll 1
    for (int j0 = 0; j0 < STEP; j0 += JU)
#pragma unroll
    for (int j = j0 + kg; j < j0 + JU; j += TL::KG) {
      const int vr = row0 + j;
#pragma unroll
      for (int c = 0; c < TL::NCG; ++c) {
        float vv[4];
        load_vals<QT, CT, 4>(
            vs + vr * TL::ROW_BYTES + (cg + c * TL::CG) * COL_BYTES, vv);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          if (r < rep) {
            const float p = pw[r * STEP + j];
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][4 * c + e] += p * vv[e];
          }
        }
      }
    }
    __syncwarp();     // the weights are read before the next step's
  });

  // the warp's sums: over its keys' lanes, and over the key groups
  float* racc = reinterpret_cast<float*>(smem);
  float* rml = racc + NW * REP * TL::DP;
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (r < rep) {
      float x = l_run[r];
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
#pragma unroll
      for (int off = TL::CG; off < 32; off <<= 1)
#pragma unroll
        for (int e = 0; e < NA; ++e)
          acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
      if (kg == 0)
#pragma unroll
        for (int c = 0; c < TL::NCG; ++c)
          *reinterpret_cast<float4*>(racc + (warp * REP + r) * TL::DP +
                                     (cg + c * TL::CG) * 4) =
              make_float4(acc[r][4 * c], acc[r][4 * c + 1],
                          acc[r][4 * c + 2], acc[r][4 * c + 3]);
      if (lane == 0) {
        rml[(warp * REP + r) * 2] = m_run[r];
        rml[(warp * REP + r) * 2 + 1] = x;
      }
    }
  }
}

// The tensor-core path (bf16 queries, rep >= 2): a warp's step of 8 keys
// as two products on `mma.sync`, heads as the 16 rows of A (rows rep..15
// zero). Scores S (16 x 8) = Q (16 x dh) K^T, m16n8k16, bf16 in (the
// query and the cache rounded to it: exact products), fp32 sums. Lane
// (g, t) = (lane / 4, lane % 4) holds S[g][2t], S[g][2t + 1]: head g's
// online softmax takes two shuffles. O (16 x dh) += P V, m16n8k8, P split
// into bf16 hi + lo parts (two products: P within 2^-16 of its fp32
// value, so the decode bar of an fp32 P holds). Leaves racc/rml as
// stream_cores does.
template <typename CT, int DH, int REP>
__device__ __forceinline__ void stream_mma(unsigned char* smem,
                                           const float* qsh, const CT* kb,
                                           const CT* vb, size_t row_stride,
                                           int n, int n_stages, int rep,
                                           float scale2) {
  using TL = Tile<CT, DH>;
  constexpr bool BF16 = std::is_same<CT, __nv_bfloat16>::value;
  constexpr int KS = TL::DP / 16, NTILES = TL::DP / 8;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  // A fragments of Q: row g, columns 16 ks + 2t (+1) and + 8
  unsigned qa[KS][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const float* qr = qsh + g * TL::DP + 16 * ks + 2 * t;
    qa[ks][0] = g < rep ? pack_bf16(qr[0], qr[1]) : 0u;
    qa[ks][1] = g < rep ? pack_bf16(qr[8], qr[9]) : 0u;
  }
  // O rows 0..7 (the heads): lane (g, t) holds O[g][8 i + 2t (+1)]
  float o[NTILES][2];
#pragma unroll
  for (int i = 0; i < NTILES; ++i) o[i][0] = o[i][1] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  stream<true, CT, DH>(smem, kb, vb, row_stride, n, n_stages,
                       [&](const unsigned char* ks_, const unsigned char* vs,
                           int row0, int stage_n) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (BF16) {
      // B fragments of K^T by ldmatrix: matrix m of a load is key rows
      // row0..row0 + 7, chunk 4 kp + m (k-step 2 kp + m / 2, half m % 2)
      const int r = row0 + lane % 8;
#pragma unroll
      for (int kp = 0; kp < KS / 2; ++kp) {
        unsigned b[4];
        ldsm_x4<false>(b, smem_u32(ks_ + r * TL::ROW_BYTES +
                                   swz<true, TL::CPR>(r, 4 * kp + lane / 8) *
                                       16));
        mma_k16(c, qa[2 * kp][0], qa[2 * kp][1], b[0], b[1]);
        mma_k16(c, qa[2 * kp + 1][0], qa[2 * kp + 1][1], b[2], b[3]);
      }
    } else {
      // key g's columns 16 ks + 2t (+1) and + 8, rounded to bf16
      const int r = row0 + g;
      const unsigned char* kr = ks_ + r * TL::ROW_BYTES + (t & 1) * 8;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int c0 = 4 * ks + t / 2;
        const float2 x0 = *reinterpret_cast<const float2*>(
            kr + swz<true, TL::CPR>(r, c0) * 16);
        const float2 x1 = *reinterpret_cast<const float2*>(
            kr + swz<true, TL::CPR>(r, c0 + 2) * 16);
        mma_k16(c, qa[ks][0], qa[ks][1], pack_bf16(x0.x, x0.y),
                pack_bf16(x1.x, x1.y));
      }
    }
    // head g's scores of keys row0 + 2t, row0 + 2t + 1
    const float s0 = row0 + 2 * t < stage_n ? c[0] * scale2 : -INFINITY;
    const float s1 = row0 + 2 * t + 1 < stage_n ? c[1] * scale2 : -INFINITY;
    float mx = fmaxf(s0, s1);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // key row0 is valid, so mx is finite
    const float m_new = fmaxf(m_run, mx);
    const float corr = exp2f(m_run - m_new);
    const float p0 = exp2f(s0 - m_new), p1 = exp2f(s1 - m_new);
    m_run = m_new;
    l_run = l_run * corr + (p0 + p1);     // this lane's two keys
    const unsigned hi = pack_bf16(p0, p1);
    const __nv_bfloat162 hb = *reinterpret_cast<const __nv_bfloat162*>(&hi);
    const unsigned lo = pack_bf16(p0 - __low2float(hb),
                                  p1 - __high2float(hb));
#pragma unroll
    for (int i = 0; i < NTILES; ++i) {
      o[i][0] *= corr;
      o[i][1] *= corr;
    }
    if constexpr (BF16) {
      // B fragments of V by ldmatrix.trans: matrix m of a load is key
      // rows row0..row0 + 7, chunk (columns) 4 np + m
      const int r = row0 + lane % 8;
#pragma unroll
      for (int np = 0; np < NTILES / 4; ++np) {
        unsigned b[4];
        ldsm_x4<true>(b, smem_u32(vs + r * TL::ROW_BYTES +
                                  swz<true, TL::CPR>(r, 4 * np + lane / 8) *
                                      16));
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          mma_k8(o[4 * np + m], hi, b[m]);
          mma_k8(o[4 * np + m], lo, b[m]);
        }
      }
    } else {
      // V[row0 + 2t (+1)][8 i + g], rounded to bf16
      const int r0 = row0 + 2 * t, r1 = r0 + 1;
      const unsigned char* v0 = vs + r0 * TL::ROW_BYTES + (g & 3) * 4;
      const unsigned char* v1 = vs + r1 * TL::ROW_BYTES + (g & 3) * 4;
#pragma unroll
      for (int i = 0; i < NTILES; ++i) {
        const int cc = 2 * i + g / 4;
        const float x0 = *reinterpret_cast<const float*>(
            v0 + swz<true, TL::CPR>(r0, cc) * 16);
        const float x1 = *reinterpret_cast<const float*>(
            v1 + swz<true, TL::CPR>(r1, cc) * 16);
        const unsigned b = pack_bf16(x0, x1);
        mma_k8(o[i], hi, b);
        mma_k8(o[i], lo, b);
      }
    }
  });

  // head g's sum over its four lanes
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  float* racc = reinterpret_cast<float*>(smem);
  float* rml = racc + NW * REP * TL::DP;
  if (g < rep) {
#pragma unroll
    for (int i = 0; i < NTILES; ++i)
      *reinterpret_cast<float2*>(racc + (warp * REP + g) * TL::DP + 8 * i +
                                 2 * t) = make_float2(o[i][0], o[i][1]);
    if (t == 0) {
      rml[(warp * REP + g) * 2] = m_run;
      rml[(warp * REP + g) * 2 + 1] = l_run;
    }
  }
}

// c (+)= A B on `mma.sync` m16n8k16 for rows 0..7 of the tile (the heads):
// rows 8..15 of A are zero, their sums are dropped and hold no registers
__device__ __forceinline__ void mma_k16_top(float* c, unsigned a0,
                                            unsigned a2, unsigned b0,
                                            unsigned b1) {
  float d2, d3;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %10, %10};\n"
      : "+f"(c[0]), "+f"(c[1]), "=f"(d2), "=f"(d3)
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "f"(0.f));
}

// The tensor-core path at dh = 256 (bf16 queries, rep >= 2): every warp
// takes every row of every stage, and warp w owns the value columns 64 w
// .. 64 w + 63. Its scores over those columns (its 4 k-steps of Q, held
// as A fragments: 8 registers) are one partial sum a key; the four warps'
// partials meet in shared memory (xsh, over the queries' fp32 copy, which
// no warp reads after its fragments), and every warp adds them in warp
// order, so the four softmax states are equal. Then P V over its 64
// columns, 16 keys a product (m16n8k16; P split into bf16 hi + lo, as at
// dh <= 128). O is 16 registers a lane and no warp idles on a stage.
// Leaves one state: racc [REP][DP] (the warps' columns side by side) and
// rml [REP][2].
template <typename CT, int REP>
__device__ __forceinline__ void stream_mma256(unsigned char* smem,
                                              float* qsh, const CT* kb,
                                              const CT* vb,
                                              size_t row_stride, int n,
                                              int n_stages, int rep,
                                              float scale2) {
  using TL = Tile<CT, 256>;
  constexpr bool BF16 = std::is_same<CT, __nv_bfloat16>::value;
  constexpr int NT8 = TL::ROWS / 8;     // 8-key tiles a stage
  constexpr int NK16 = TL::ROWS / 16;   // 16-key steps of P V a stage
  static_assert(TL::ROWS % 16 == 0 && REP == 8 &&
                    NW * NT8 * 32 * 8 <= REP * TL::DP * 4,
                "stage shape; the partials fit over the queries");
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  float2* xsh = reinterpret_cast<float2*>(qsh);   // [NW][NT8][32]
  // A fragments of Q, head g, columns 64 warp + 16 ks + 2t (+1) and + 8
  unsigned qa[4][2];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const float* qr = qsh + g * TL::DP + 64 * warp + 16 * ks + 2 * t;
    qa[ks][0] = g < rep ? pack_bf16(qr[0], qr[1]) : 0u;
    qa[ks][1] = g < rep ? pack_bf16(qr[8], qr[9]) : 0u;
  }
  // O[g][64 warp + 8 i + 2t (+1)]
  float o[8][2];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i][0] = o[i][1] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  // this warp's partial scores of K rows 8 j .. 8 j + 7: its query
  // columns 64 warp .. 64 warp + 63 (k-steps 4 warp .. 4 warp + 3), into c
  auto scores = [&](const unsigned char* ks_, int j, float* c) {
    if constexpr (BF16) {
      // matrix m of a load: key rows 8 j .. 8 j + 7, chunk 2 k2 + m (k-step
      // k2 + m / 2, half m % 2)
      const int r = 8 * j + lane % 8;
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {
        const int k2 = 4 * warp + 2 * kp;
        unsigned b[4];
        ldsm_x4<false>(b, smem_u32(ks_ + r * TL::ROW_BYTES +
                                   swz<true, TL::CPR>(r, 2 * k2 + lane / 8) *
                                       16));
        mma_k16_top(c, qa[2 * kp][0], qa[2 * kp][1], b[0], b[1]);
        mma_k16_top(c, qa[2 * kp + 1][0], qa[2 * kp + 1][1], b[2], b[3]);
      }
    } else {
      // key 8 j + g's columns 16 ks + 2t (+1) and + 8, rounded to bf16
      const int r = 8 * j + g;
      const unsigned char* kr = ks_ + r * TL::ROW_BYTES + (t & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int c0 = 4 * (4 * warp + kk) + t / 2;
        const float2 x0 = *reinterpret_cast<const float2*>(
            kr + swz<true, TL::CPR>(r, c0) * 16);
        const float2 x1 = *reinterpret_cast<const float2*>(
            kr + swz<true, TL::CPR>(r, c0 + 2) * 16);
        mma_k16_top(c, qa[kk][0], qa[kk][1], pack_bf16(x0.x, x0.y),
                    pack_bf16(x1.x, x1.y));
      }
    }
  };

  stream<true, CT, 256, true>(smem, kb, vb, row_stride, n, n_stages,
                              [&](const unsigned char* ks_,
                                  const unsigned char* vs, int,
                                  int stage_n) {
    // head g's scores of keys 8 j + 2t, 8 j + 2t + 1
    float sc[NT8][2];
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
      float c[2] = {0.f, 0.f};
      if (8 * j < stage_n) scores(ks_, j, c);
      xsh[(warp * NT8 + j) * 32 + lane] = make_float2(c[0], c[1]);
    }
    __syncthreads();     // every warp's partials
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
      float2 a = xsh[j * 32 + lane];
#pragma unroll
      for (int w = 1; w < NW; ++w) {
        const float2 x = xsh[(w * NT8 + j) * 32 + lane];
        a.x += x.x;
        a.y += x.y;
      }
      sc[j][0] = a.x;
      sc[j][1] = a.y;
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
      const int key = 8 * j + 2 * t;
      sc[j][0] = key < stage_n ? sc[j][0] * scale2 : -INFINITY;
      sc[j][1] = key + 1 < stage_n ? sc[j][1] * scale2 : -INFINITY;
      mx = fmaxf(mx, fmaxf(sc[j][0], sc[j][1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // key 0 of the stage is valid, so mx is finite
    const float m_new = fmaxf(m_run, mx);
    const float corr = exp2f(m_run - m_new);
    m_run = m_new;
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
      sc[j][0] = exp2f(sc[j][0] - m_new);
      sc[j][1] = exp2f(sc[j][1] - m_new);
      lsum += sc[j][0] + sc[j][1];
    }
    l_run = l_run * corr + lsum;     // this lane's keys
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o[i][0] *= corr;
      o[i][1] *= corr;
    }
#pragma unroll
    for (int kk = 0; kk < NK16; ++kk) {
      if (16 * kk >= stage_n) break;
      // A of the 16-key step: P[g][16 kk + 2t (+1)] and P[g][16 kk + 8 +
      // 2t (+1)], each split into bf16 hi + lo
      unsigned hi[2], lo[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = sc[2 * kk + e][0], p1 = sc[2 * kk + e][1];
        hi[e] = pack_bf16(p0, p1);
        const __nv_bfloat162 hb =
            *reinterpret_cast<const __nv_bfloat162*>(&hi[e]);
        lo[e] = pack_bf16(p0 - __low2float(hb), p1 - __high2float(hb));
      }
      if constexpr (BF16) {
        // B fragments of V by ldmatrix.trans: matrix m of a load is key
        // rows 16 kk + 8 (m % 2) .. + 7, chunk 8 warp + 2 np + m / 2
        const int r = 16 * kk + 8 * ((lane / 8) % 2) + lane % 8;
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          unsigned b[4];
          ldsm_x4<true>(b, smem_u32(vs + r * TL::ROW_BYTES +
                                    swz<true, TL::CPR>(
                                        r, 8 * warp + 2 * np + lane / 16) *
                                        16));
          mma_k16_top(o[2 * np], hi[0], hi[1], b[0], b[1]);
          mma_k16_top(o[2 * np], lo[0], lo[1], b[0], b[1]);
          mma_k16_top(o[2 * np + 1], hi[0], hi[1], b[2], b[3]);
          mma_k16_top(o[2 * np + 1], lo[0], lo[1], b[2], b[3]);
        }
      } else {
        // V[16 kk + 2t (+1), + 8][64 warp + 8 i + g], rounded to bf16
        const int r0 = 16 * kk + 2 * t;
        const unsigned char* v0 = vs + r0 * TL::ROW_BYTES + (g & 3) * 4;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int cc = 16 * warp + 2 * i + g / 4;
          float x[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int dr = (e % 2) + 8 * (e / 2);    // rows +0, +1, +8, +9
            x[e] = *reinterpret_cast<const float*>(
                v0 + dr * TL::ROW_BYTES + swz<true, TL::CPR>(r0 + dr, cc) * 16);
          }
          const unsigned b0 = pack_bf16(x[0], x[1]);
          const unsigned b1 = pack_bf16(x[2], x[3]);
          mma_k16_top(o[i], hi[0], hi[1], b0, b1);
          mma_k16_top(o[i], lo[0], lo[1], b0, b1);
        }
      }
    }
  });

  // head g's sum over its four lanes; every warp's state is the same
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  float* racc = reinterpret_cast<float*>(smem);
  float* rml = racc + REP * TL::DP;
  if (g < rep) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float2*>(racc + g * TL::DP + 64 * warp + 8 * i +
                                 2 * t) = make_float2(o[i][0], o[i][1]);
    if (warp == 0 && t == 0) {
      rml[g * 2] = m_run;
      rml[g * 2 + 1] = l_run;
    }
  }
}

// REP: the query heads a block holds (rep <= REP of them used). MMA: the
// tensor-core path (bf16 queries), else the CUDA-core path.
template <typename QT, typename CT, int DH, int REP, bool MMA>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
decode_kernel(const QT* __restrict__ q, const CT* __restrict__ k,
              const CT* __restrict__ v, const int* __restrict__ kv_len,
              QT* __restrict__ out, float* __restrict__ part_acc,
              float* __restrict__ part_ml, unsigned* __restrict__ arrivals,
              int t, int h, int hk, int n_split, int split_rows, int window,
              float scale2) {
  using TL = Tile<CT, DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qsh = reinterpret_cast<float*>(smem + RING_BYTES);
  float* psh = qsh + REP * TL::DP;      // [NW][REP][STEP] weights
  __shared__ int last;

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int rep = h / hk;
  const int tid = threadIdx.x;
  const int len = min(max(kv_len[b], 0), t);
  // the valid rows [lo, len): the window's start, or row 0
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int s_lo = lo / split_rows;     // the first split holding one
  const int k0 = split * split_rows;
  // no valid row in this split (an empty row is split 0's)
  if (len > 0 ? split < s_lo || k0 >= len : split > 0) return;
  const int r0 = max(k0, lo);
  const int n = max(min(k0 + split_rows, len) - r0, 0);   // its valid rows
  const int n_active =
      len > 0 ? (len + split_rows - 1) / split_rows - s_lo : 1;
  const int n_stages = (n + TL::ROWS - 1) / TL::ROWS;
  const size_t row_stride = (size_t)hk * DH;
  const size_t first = (((size_t)b * t + r0) * hk + kh) * DH;
  const CT* kb = k + first;
  const CT* vb = v + first;

#pragma unroll
  for (int s = 0; s < TL::STAGES - 1; ++s) {
    if (s < n_stages)
      load_stage<MMA, CT, DH>(smem + s * TL::STAGE, kb, vb, row_stride,
                              s * TL::ROWS, n, tid);
    cp_async_commit();
  }
  // the rep heads' queries as floats (the CUDA-core path's times scale *
  // log2(e); the tensor-core path scales its fp32 scores)
  const size_t head0 = (size_t)b * h + (size_t)kh * rep;
  for (int l = tid; l < rep * TL::DP; l += NT) {
    const int r = l / TL::DP, c = l % TL::DP;   // zero past the width
    qsh[l] = c < DH ? to_f(q[(head0 + r) * DH + c]) * (MMA ? 1.f : scale2)
                    : 0.f;
  }
  if constexpr (MMA && DH == 256) {
    __syncthreads();    // the queries, before the A fragments
    stream_mma256<CT, REP>(smem, qsh, kb, vb, row_stride, n, n_stages, rep,
                           scale2);
  } else if constexpr (MMA) {
    __syncthreads();    // the queries, before the A fragments
    stream_mma<CT, DH, REP>(smem, qsh, kb, vb, row_stride, n, n_stages, rep,
                            scale2);
  } else {
    stream_cores<QT, CT, DH, REP>(smem, qsh, psh, kb, vb, row_stride, n,
                                  n_stages, rep);
  }
  __syncthreads();
  // the states to merge: one a warp, or one at dh = 256 on the tensor
  // cores (the warps' columns side by side)
  constexpr int NS = MMA && DH == 256 ? 1 : NW;
  float* racc = reinterpret_cast<float*>(smem);   // [NS][REP][DP]
  float* rml = racc + NS * REP * TL::DP;          // [NS][REP][2]

  const size_t pair = (size_t)b * hk + kh;
  // the split's state, head r and columns 4 c .. 4 c + 3 a thread (the
  // stored ones, c < DH / 4)
  for (int i = tid; i < rep * TL::C4G; i += NT) {
    const int r = i / TL::C4G, c = i % TL::C4G;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NS; ++w) mx = fmaxf(mx, rml[(w * REP + r) * 2]);
    float l = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < NS; ++w) {
        const float mw = rml[(w * REP + r) * 2];
        if (mw == -INFINITY) continue;
        const float f = exp2f(mw - mx);
        l += f * rml[(w * REP + r) * 2 + 1];
        const float4 x = *reinterpret_cast<const float4*>(
            racc + (w * REP + r) * TL::DP + c * 4);
        a[0] += f * x.x; a[1] += f * x.y; a[2] += f * x.z; a[3] += f * x.w;
      }
    }
    if (n_active == 1) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      QT* o = out + (head0 + r) * DH + c * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = from_f<QT>(a[e] * inv);
    } else {
      const size_t pi = (pair * n_split + split) * rep + r;
      *reinterpret_cast<float4*>(part_acc + pi * DH + c * 4) =
          make_float4(a[0], a[1], a[2], a[3]);
      if (c == 0) {
        part_ml[pi * 2] = mx;
        part_ml[pi * 2 + 1] = l;
      }
    }
  }
  if (n_active == 1) return;

  __threadfence();      // the partial is visible before the arrival
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(arrivals + pair, 1u) == (unsigned)(n_active - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();      // the other splits' partials are visible
  for (int i = tid; i < rep * TL::C4G; i += NT) {
    const int r = i / TL::C4G, c = i % TL::C4G;
    // split s_lo, head r: the active splits follow it
    const size_t p0 = (pair * n_split + s_lo) * rep + r;
    float mx = -INFINITY;
    for (int sp = 0; sp < n_active; ++sp)
      mx = fmaxf(mx, __ldcg(part_ml + (p0 + (size_t)sp * rep) * 2));
    float l = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int sp = 0; sp < n_active; ++sp) {
      const size_t pi = p0 + (size_t)sp * rep;
      const float f = exp2f(__ldcg(part_ml + pi * 2) - mx);
      l += f * __ldcg(part_ml + pi * 2 + 1);
      const float4 x =
          __ldcg(reinterpret_cast<const float4*>(part_acc + pi * DH + c * 4));
      a[0] += f * x.x; a[1] += f * x.y; a[2] += f * x.z; a[3] += f * x.w;
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    QT* o = out + (head0 + r) * DH + c * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = from_f<QT>(a[e] * inv);
  }
  if (tid == 0) arrivals[pair] = 0u;    // zero for the next call
}

template <typename QT, typename CT, int DH, int REP, bool MMA>
struct Launch {
  static int run(const void* q, const void* k, const void* v,
                 const int* kv_len, void* out, float* part_acc,
                 float* part_ml, unsigned* arrivals, int b, int t, int h,
                 int hk, int n_split, int split_rows, int window,
                 float scale, cudaStream_t stream) {
    const auto kernel = decode_kernel<QT, CT, DH, REP, MMA>;
    const size_t bytes = smem_bytes(DH, REP);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(n_split, hk, b), NT, bytes, stream>>>(
        static_cast<const QT*>(q), static_cast<const CT*>(k),
        static_cast<const CT*>(v), kv_len, static_cast<QT*>(out), part_acc,
        part_ml, arrivals, t, h, hk, n_split, split_rows, window,
        scale * LOG2E);
    return (int)cudaGetLastError();
  }
};

template <typename QT, typename CT, int DH, int REP, bool MMA>
struct Occupancy {
  static int run() {
    const auto kernel = decode_kernel<QT, CT, DH, REP, MMA>;
    const size_t bytes = smem_bytes(DH, REP);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                          NT, bytes);
    return err == cudaSuccess ? blocks : -(int)err;
  }
};

// F<QT, CT, DH, REP, MMA>::run(args...) for the pair's codes, dh and rep:
// a bf16 query over rep >= 2 heads takes the tensor-core path (REP 8: the
// heads are A's rows), any other the CUDA-core path with rep rounded up to
// 1, 2, 4 or 8 (on the H100 the tensor-core path is the faster at rep 4,
// the slower at rep 1: scripts/decode_path_variants.py times both)
template <template <typename, typename, int, int, bool> class F,
          typename QT, typename CT, int DH, typename... A>
int by_rep(int rep, A... args) {
  if (rep == 1) return F<QT, CT, DH, 1, false>::run(args...);
  if constexpr (std::is_same<QT, __nv_bfloat16>::value) {
    return F<QT, CT, DH, 8, true>::run(args...);
  } else {
    if (rep == 2) return F<QT, CT, DH, 2, false>::run(args...);
    if (rep <= 4) return F<QT, CT, DH, 4, false>::run(args...);
    return F<QT, CT, DH, 8, false>::run(args...);
  }
}
template <template <typename, typename, int, int, bool> class F,
          typename QT, typename CT, typename... A>
int by_dh(int dh, int rep, A... args) {
  switch (dh) {
    case 32: return by_rep<F, QT, CT, 32>(rep, args...);
    case 64: return by_rep<F, QT, CT, 64>(rep, args...);
    case 112: return by_rep<F, QT, CT, 112>(rep, args...);
    case 128: return by_rep<F, QT, CT, 128>(rep, args...);
    case 256: return by_rep<F, QT, CT, 256>(rep, args...);
    default: return (int)cudaErrorInvalidValue;
  }
}
template <template <typename, typename, int, int, bool> class F,
          typename... A>
int dispatch(int q_dtype, int kv_dtype, int dh, int rep, A... args) {
  if (rep < 1 || rep > MAX_REP) return (int)cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0)
    return by_dh<F, float, float>(dh, rep, args...);
  if (q_dtype == 1 && kv_dtype == 0)
    return by_dh<F, __nv_bfloat16, float>(dh, rep, args...);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_dh<F, __nv_bfloat16, __nv_bfloat16>(dh, rep, args...);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: (B, H, dh); k/v: (B, T, Hk, dh); kv_len: (B,) int32; out: (B, H, dh);
// part_acc: (B, Hk, n_split, H / Hk, dh) and part_ml: (B, Hk, n_split,
// H / Hk, 2) fp32 scratch (unused when n_split = 1); arrivals: B * Hk
// uint32 counters, zero before the call and zero after it. Split s takes
// rows [s * split_rows, (s + 1) * split_rows). window > 0 keeps only the
// rows at or past kv_len - window; 0 disables it. q_dtype/kv_dtype: 0 =
// fp32, 1 = bf16; the pairs are (fp32, fp32), (bf16, fp32) and (bf16, bf16).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* kv_len,
                                       void* out, float* part_acc,
                                       float* part_ml, unsigned* arrivals,
                                       int b, int t, int h, int hk, int dh,
                                       int q_dtype, int kv_dtype,
                                       int n_split, int split_rows,
                                       int window, float scale,
                                       cudaStream_t stream) {
  if (hk <= 0 || h % hk != 0 || n_split <= 0 || split_rows <= 0 ||
      window < 0 || (long long)n_split * split_rows < t)
    return (int)cudaErrorInvalidValue;
  return dispatch<Launch>(q_dtype, kv_dtype, dh, h / hk, q, k, v, kv_len,
                          out, part_acc, part_ml, arrivals, b, t, h, hk,
                          n_split, split_rows, window, scale, stream);
}

// resident blocks an SM for the pair, dh and rep (a negative CUDA error
// on failure)
extern "C" int decode_attention_occupancy(int q_dtype, int kv_dtype, int dh,
                                          int rep) {
  return dispatch<Occupancy>(q_dtype, kv_dtype, dh, rep);
}
