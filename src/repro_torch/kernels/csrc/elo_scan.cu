// Batched ELO replay, with an optional budget-selection epilogue, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels `elo_scan_pallas` (body `_elo_kernel`) and
// `elo_scan_select_pallas` (body `_elo_select_kernel`) in
// src/repro/kernels/elo_scan.py. For each query, T pairwise records are
// replayed in order:
//   E = 1 / (1 + 10^((r_b - r_a) / 400)),  r_a += K (S - E) v,
//   r_b -= K (S - E) v.
// With `select` set, the epilogue combines p * Global + (1 - p) * Local,
// masks models costing more than the query's budget, takes the first
// index of the maximum, and falls back to the first cheapest model when
// nothing fits.
//
// Bound: the records are a few MB even at the top bucket (Q = 1024,
// T = 160: 2.6 MB), well under a microsecond of bandwidth. What bounds
// the kernel is the dependent chain of T steps of one query, each a
// pow and a divide.
//
// Design: one warp per query, lane m holding rating m (so M <= 32). The
// TPU kernel applies each step as a one-hot masked add over its whole
// rating tile; here r_a and r_b are read directly from their lanes with
// __shfl_sync. The warp loads 32 records at a time, coalesced, one per
// lane, and broadcasts record i from lane i at step i. The update is
// written r + delta * coef with coef in {-1, 0, 1}, the reference's own
// formula, so a record with v = 0 (delta = 0) is an exact no-op.
// The epilogue runs in registers: a butterfly max, then __ballot_sync +
// __ffs for the first index, so ties break as torch.argmax does.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 4;  // queries per block
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARPS * 32)
elo_scan_kernel(const float* __restrict__ ratings, const int* __restrict__ a,
                const int* __restrict__ b, const float* __restrict__ s,
                const unsigned char* __restrict__ v,
                const float* __restrict__ g, const float* __restrict__ costs,
                const float* __restrict__ budgets, float* __restrict__ out,
                int* __restrict__ choices, int nq, int t, int m, float k,
                float p, float pc, int select) {
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * WARPS + threadIdx.x / 32;
  if (qi >= nq) return;  // uniform across the warp
  const bool live = lane < m;
  float r = live ? ratings[(size_t)qi * m + lane] : 0.f;
  const size_t base = (size_t)qi * t;

  for (int t0 = 0; t0 < t; t0 += 32) {
    const int idx = t0 + lane;
    int ca = 0, cb = 0;
    float cs = 0.f, cv = 0.f;
    if (idx < t) {
      ca = a[base + idx];
      cb = b[base + idx];
      cs = s[base + idx];
      cv = v[base + idx] ? 1.f : 0.f;
    }
    const int steps = min(32, t - t0);
    for (int i = 0; i < steps; ++i) {
      const int ai = __shfl_sync(FULL, ca, i);
      const int bi = __shfl_sync(FULL, cb, i);
      const float si = __shfl_sync(FULL, cs, i);
      const float vi = __shfl_sync(FULL, cv, i);
      const float ra = __shfl_sync(FULL, r, ai);
      const float rb = __shfl_sync(FULL, r, bi);
      const float e = 1.f / (1.f + powf(10.f, (rb - ra) / 400.f));
      const float delta = k * (si - e) * vi;
      const float coef = (float)(lane == ai) - (float)(lane == bi);
      r = r + delta * coef;
    }
  }
  if (live) out[(size_t)qi * m + lane] = r;
  if (!select) return;

  const float c = live ? costs[lane] : INFINITY;
  const bool feasible = live && c <= budgets[qi];
  // rounded products, never contracted into an FMA: the reference
  // rounds p * g and (1 - p) * r separately, and near-tied scores must
  // pick the same model
  const float combined = __fadd_rn(__fmul_rn(p, live ? g[lane] : 0.f),
                                   __fmul_rn(pc, r));
  const float masked = feasible ? combined : -INFINITY;
  float mx = masked;
  float cmin = c;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    cmin = fminf(cmin, __shfl_xor_sync(FULL, cmin, off));
  }
  const unsigned any_ok = __ballot_sync(FULL, feasible);
  const unsigned at_max = __ballot_sync(FULL, live && masked == mx);
  const unsigned at_min = __ballot_sync(FULL, live && c == cmin);
  if (lane == 0) choices[qi] = any_ok ? __ffs(at_max) - 1 : __ffs(at_min) - 1;
}

}  // namespace

extern "C" int elo_scan_launch(const float* ratings, const int* a,
                               const int* b, const float* s,
                               const unsigned char* v, const float* g,
                               const float* costs, const float* budgets,
                               float* out, int* choices, int nq, int t, int m,
                               float k, float p, float pc, int select,
                               cudaStream_t stream) {
  const int blocks = (nq + WARPS - 1) / WARPS;
  elo_scan_kernel<<<blocks, WARPS * 32, 0, stream>>>(
      ratings, a, b, s, v, g, costs, budgets, out, choices, nq, t, m, k, p,
      pc, select);
  return (int)cudaGetLastError();
}
