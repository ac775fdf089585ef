// Batched ELO replay, with an optional budget-selection epilogue and an
// optional in-place record gather, for Hopper (sm_90a).
//
// Replaces the TPU kernels `elo_scan_pallas` (body `_elo_kernel`) and
// `elo_scan_select_pallas` (body `_elo_select_kernel`) in
// src/repro/kernels/elo_scan.py. For each query, T pairwise records are
// replayed in order, each step as the TPU kernel computes it:
//   E = 1 / (1 + exp2((r_b - r_a) * log2(10) / 400)),
//   delta = K v (S - E),  r_a += delta,  r_b -= delta.
// With SELECT, the epilogue combines p * Global + (1 - p) * Local, masks
// models costing more than the query's budget, takes the first index of
// the maximum, and falls back to the first cheapest model when nothing
// fits. With GATHER, the records are read in place from the (C, R)
// panels through the query's top-n rows, farthest neighbour first, as
// `ref.gather_records` orders them, and the prior is one (M,) row.
//
// Bound: the records are a few MB even at the largest shapes (Q = 1024,
// T = 160: 2.1 MB; the fit's fold, T = 262,144: 3.4 MB), well under a
// few microseconds of bandwidth. What bounds the kernel is the dependent
// chain of the T steps of one query: the byte bound is unreachable, the
// time is T x the latency of one step.
//
// Design, all of it to shorten that step and keep everything else off
// the chain:
// - Lane m of a W-lane segment holds rating m; a warp holds 32 / W
//   queries (W = 8, 16 or 32, the smallest that holds M, at least 8 so
//   that a lane keeps at most 4 records of a chunk). Q = 1024 at M = 10
//   is 512 warps, one wave.
// - A step on the chain is FFMA, MUFU.EX2, FADD, MUFU.RCP: the argument
//   d = (r_b - r_a) * c, c = log2(10) / 400, is carried, not read. While
//   step i runs, step i+1's r_a', r_b' are shuffled from the ratings
//   before step i; d' = (r_b' - r_a') * c + delta_i * (coef_i(b') -
//   coef_i(a')) * c (coef_i(x) = [x == a_i] - [x == b_i], the update lane
//   x applies), with delta_i = K v s - K v E_i written out, is one FFMA
//   on E_i. 10^x is one ex2.approx, the reciprocal one rcp.approx.
//   Beside the chain, delta = K v s - K v E is one FFMA, 0 exactly when
//   v = 0, and each lane applies r + delta * coef as the reference writes
//   it, so an invalid record is an exact no-op.
// - The carried d' equals (r_b' - r_a') * c after the update in exact
//   arithmetic, not bit for bit: it is rounded in other places than the
//   reference's operand, a few ulp of d apart. The carry does not build
//   up across steps: each step's d is rebuilt from the ratings stored
//   before the step ahead of it plus one correction, never from an
//   earlier d, so its error enters that step's E once, as the error of
//   ex2.approx and rcp.approx does.
// - Records come in chunks of 32 a query. Lane j of a segment loads
//   records j, j + W, ... of the chunk; the next chunk's loads are issued
//   before the current chunk runs, so they are in flight while its 32
//   steps do. Each record is decoded once, off the chain, into shared
//   memory (indices, -K v, K v s and the carry factor
//   (coef_{i-1}(b_i) - coef_{i-1}(a_i)) * c), and a step reads it with
//   one 16-byte load that every lane of the segment shares. The step
//   loop is unrolled over the chunk; a short last chunk runs a copy,
//   after the loop, with a uniform exit.
// - A chunk whose records are invalid for every query of the warp is
//   skipped with a warp-uniform branch (the fit's padded tail).
// - GATHER stages each query's top-n rows in shared memory once (a miss
//   as -1), so a record load is one dependent load, not two.
// - The epilogue runs in registers: a butterfly max inside the segment,
//   then __ballot_sync masked to the segment + __ffs for the first index,
//   so ties break as torch.argmax does.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 4;                // warps per block
constexpr int CHUNK = 32;               // records a segment decodes at once
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2_10_OVER_400 = 0.0083048202372184f;  // log2(10) / 400

struct Args {
  const float* ratings;  // (Q, M) rows at `ratings_stride` (0: one prior)
  int ratings_stride;
  const int* a;          // (Q, T) records, or the (C, R) panels (GATHER)
  const int* b;
  const float* s;
  const unsigned char* v;
  const long long* top_i;     // (Q, n) GATHER: retrieved rows
  const unsigned char* hit;   // (Q, n) GATHER: row is live
  int n, r;                   // GATHER: neighbours, records per row
  const float* g;             // (M,) SELECT: global ratings
  const float* costs;         // (M,)
  const float* budgets;       // (Q,) at `budget_stride`
  int budget_stride;
  float* out;                 // (Q, M)
  int* choices;               // (Q,)
  int nq, t, m;
  float k, p, pc;
};

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One chunk of raw records of a lane, as loaded.
template <int RPL>
struct Raw {
  int a[RPL], b[RPL];
  float s[RPL];
  bool v[RPL];
};

// Loads the lane's records of the chunk starting at t0: record t0 + lis +
// W * i of its query into slot i. Records past T, and those of a query
// past Q, come back invalid.
template <int W, bool GATHER>
__device__ __forceinline__ void load_chunk(Raw<CHUNK / W>& x, const Args& A,
                                           const int* rows, int qi,
                                           int lis, int t0) {
#pragma unroll
  for (int i = 0; i < CHUNK / W; ++i) {
    const int j = t0 + lis + W * i;
    x.a[i] = 0;
    x.b[i] = 0;
    x.s[i] = 0.f;
    x.v[i] = false;
    if (qi >= A.nq || j >= A.t) continue;
    size_t off;
    if constexpr (GATHER) {
      // farthest neighbour first: slot n - 1 holds records 0 .. R - 1
      const int nb = j / A.r;
      const int row = rows[A.n - 1 - nb];
      if (row < 0) continue;  // a miss: no records
      off = (size_t)row * A.r + (j - nb * A.r);
    } else {
      off = (size_t)qi * A.t + j;
    }
    x.a[i] = A.a[off];
    x.b[i] = A.b[off];
    x.s[i] = A.s[off];
    x.v[i] = A.v[off] != 0;
  }
}

// A decoded record, as a step reads it: the model indices, -K v, K v s,
// and c * (coef_{j-1}(b) - coef_{j-1}(a)), where coef_{j-1}(x) = [x ==
// a_{j-1}] - [x == b_{j-1}] is the previous record's update of rating x,
// so that d = (r_b - r_a) * c can be carried across the previous step.
struct __align__(16) Rec {  // one 16-byte shared load a step
  int ab;  // a | b << 16
  float nkv, kvs, cd;
};

// Decodes the lane's raw records of a chunk into the segment's shared
// records `rec` (record lis + W * i from slot i). Returns whether any of
// the lane's records is valid.
template <int W>
__device__ __forceinline__ bool decode(const Raw<CHUNK / W>& x, float k,
                                       int lis, Rec* rec) {
  constexpr int RPL = CHUNK / W;
  constexpr float C = LOG2_10_OVER_400;
  bool any = false;
  __syncwarp();  // the previous chunk's steps have read `rec`
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int a = x.a[i] & (W - 1), b = x.b[i] & (W - 1);
    const int ab = a | b << 16;
    // the previous record: lane lis - 1, or lane W - 1 of slot i - 1
    const int up = __shfl_sync(FULL, ab, lis - 1, W);
    const int wrap = __shfl_sync(FULL, i ? (x.a[i - 1] & (W - 1)) |
                                         (x.b[i - 1] & (W - 1)) << 16 : 0,
                                 W - 1, W);
    const int prev = lis ? up : wrap;
    const int pa = prev & 0xffff, pb = prev >> 16;
    const float ca = (float)(a == pa) - (float)(a == pb);
    const float cb = (float)(b == pa) - (float)(b == pb);
    const float kv = x.v[i] ? k : 0.f;
    rec[lis + W * i] = Rec{ab, -kv, kv * x.s[i], (cb - ca) * C};
    any |= x.v[i];
  }
  __syncwarp();
  return any;
}

// The steps of one decoded chunk of the segment's records `rec`. Lane
// lis holds rating lis; shuffles stay in the W-lane segment. `steps` is
// CHUNK except in the last chunk.
template <int W>
__device__ __forceinline__ void run_chunk(float& r, const Rec* rec, int lis,
                                          int steps) {
  constexpr float C = LOG2_10_OVER_400;
  Rec cur = rec[0];
  int a = cur.ab & 0xffff, b = cur.ab >> 16;
  float d = (__shfl_sync(FULL, r, b, W) - __shfl_sync(FULL, r, a, W)) * C;
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) {
    if (j >= steps) break;  // uniform: every query of the launch has T steps
    // off the chain: step j+1's record, and its operands before step j
    Rec nxt{0, 0.f, 0.f, 0.f};
    float dsh = 0.f;
    if (j + 1 < CHUNK) {
      nxt = rec[j + 1];
      dsh = (__shfl_sync(FULL, r, nxt.ab >> 16, W) -
             __shfl_sync(FULL, r, nxt.ab & 0xffff, W)) * C;
    }
    // d' = delta * cd' + dsh = e * (-K v cd') + (K v s cd' + dsh): one
    // FFMA after e, with delta and the update beside the chain
    const float de = cur.nkv * nxt.cd;
    const float d0 = fmaf(cur.kvs, nxt.cd, dsh);
    // the chain
    const float e = rcp_approx(1.f + ex2_approx(d));
    const float delta = fmaf(cur.nkv, e, cur.kvs);
    const float coef = (float)(lis == a) - (float)(lis == b);
    r = fmaf(delta, coef, r);
    d = fmaf(e, de, d0);
    cur = nxt;
    a = cur.ab & 0xffff;
    b = cur.ab >> 16;
  }
}

template <int W, bool SELECT, bool GATHER>
__global__ void __launch_bounds__(WARPS * 32) elo_scan_kernel(const Args A) {
  constexpr int G = 32 / W;        // queries per warp
  constexpr int RPL = CHUNK / W;   // records per lane per chunk
  // per query: CHUNK records, then (GATHER) its n top-n rows
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lis = lane & (W - 1);  // lane in segment = model index
  const int seg0 = lane & ~(W - 1);
  const int q0 = (blockIdx.x * WARPS + warp) * G;  // the warp's first query
  if (q0 >= A.nq) return;  // uniform across the warp
  const int qi = q0 + lane / W;
  const bool live = qi < A.nq && lis < A.m;
  float r = live ? A.ratings[(size_t)qi * A.ratings_stride + lis] : 0.f;

  const int* rows = nullptr;
  if constexpr (GATHER) {
    int* mine = reinterpret_cast<int*>(smem + WARPS * G * CHUNK * sizeof(Rec))
                + warp * G * A.n;
    for (int i = lane; i < G * A.n; i += 32) {
      const int qq = q0 + i / A.n;
      int row = -1;
      if (qq < A.nq) {
        const size_t at = (size_t)qq * A.n + i % A.n;
        if (A.hit[at]) row = (int)A.top_i[at];
      }
      mine[i] = row;
    }
    __syncwarp();
    rows = mine + (lane / W) * A.n;
  }

  // the full chunks, each loading the next while it runs, then the tail
  Rec* rec = reinterpret_cast<Rec*>(smem) + (warp * G + lane / W) * CHUNK;
  Raw<RPL> next;
  load_chunk<W, GATHER>(next, A, rows, qi, lis, 0);
  int t0 = 0;
  for (; t0 + CHUNK <= A.t; t0 += CHUNK) {
    const bool any = decode<W>(next, A.k, lis, rec);
    if (t0 + CHUNK < A.t)
      load_chunk<W, GATHER>(next, A, rows, qi, lis, t0 + CHUNK);
    if (__any_sync(FULL, any))  // else every step is an exact no-op
      run_chunk<W>(r, rec, lis, CHUNK);
  }
  if (t0 < A.t && __any_sync(FULL, decode<W>(next, A.k, lis, rec)))
    run_chunk<W>(r, rec, lis, A.t - t0);
  if (live) A.out[(size_t)qi * A.m + lis] = r;
  if constexpr (!SELECT) return;

  const bool qlive = qi < A.nq;
  const float c = live ? A.costs[lis] : INFINITY;
  const bool feasible = live && c <= A.budgets[(size_t)qi * A.budget_stride];
  // rounded products, never contracted into an FMA: the reference
  // rounds p * g and (1 - p) * r separately, and near-tied scores must
  // pick the same model
  const float combined = __fadd_rn(__fmul_rn(A.p, live ? A.g[lis] : 0.f),
                                   __fmul_rn(A.pc, r));
  const float masked = feasible ? combined : -INFINITY;
  float mx = masked;
  float cmin = c;
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {  // stays inside the segment
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    cmin = fminf(cmin, __shfl_xor_sync(FULL, cmin, off));
  }
  const unsigned seg = (W == 32) ? FULL : ((1u << (W & 31)) - 1u) << seg0;
  const unsigned any_ok = __ballot_sync(FULL, feasible) & seg;
  const unsigned at_max = __ballot_sync(FULL, live && masked == mx) & seg;
  const unsigned at_min = __ballot_sync(FULL, live && c == cmin) & seg;
  if (qlive && lis == 0)
    A.choices[qi] = (any_ok ? __ffs(at_max) : __ffs(at_min)) - 1 - seg0;
}

template <int W, bool SELECT, bool GATHER>
int launch(const Args& A, cudaStream_t stream) {
  constexpr int per_block = WARPS * (32 / W);
  const int blocks = (A.nq + per_block - 1) / per_block;
  const size_t smem = per_block * (CHUNK * sizeof(Rec) +
                                   (GATHER ? A.n * sizeof(int) : 0));
  elo_scan_kernel<W, SELECT, GATHER>
      <<<blocks, WARPS * 32, smem, stream>>>(A);
  return (int)cudaGetLastError();
}

template <int W>
int launch_width(const Args& A, int select, int gather, cudaStream_t stream) {
  if (gather)
    return select ? launch<W, true, true>(A, stream)
                  : launch<W, false, true>(A, stream);
  return select ? launch<W, true, false>(A, stream)
                : launch<W, false, false>(A, stream);
}

}  // namespace

// ratings: (Q, M) at ratings_stride (0: one (M,) prior for every query).
// Pre-gathered (top_i == NULL): a, b, s, v are (Q, T) records. Gather
// (top_i != NULL): a, b, s, v are the (C, R) panels, top_i / hit (Q, n),
// T = n * R. select: g, costs (M,), budgets at budget_stride, choices
// (Q,).
extern "C" int elo_scan_launch(const float* ratings, int ratings_stride,
                               const int* a, const int* b, const float* s,
                               const unsigned char* v, const long long* top_i,
                               const unsigned char* hit, int n, int r,
                               const float* g, const float* costs,
                               const float* budgets, int budget_stride,
                               float* out, int* choices, int nq, int t, int m,
                               float k, float p, float pc, int select,
                               cudaStream_t stream) {
  const Args A{ratings, ratings_stride, a, b, s, v, top_i, hit, n, r, g,
               costs, budgets, budget_stride, out, choices, nq, t, m, k, p,
               pc};
  const int gather = top_i != nullptr;
  if (m < 1 || m > 32 || (gather && t != n * r))
    return (int)cudaErrorInvalidValue;
  if (m <= 8) return launch_width<8>(A, select, gather, stream);
  if (m <= 16) return launch_width<16>(A, select, gather, stream);
  return launch_width<32>(A, select, gather, stream);
}
