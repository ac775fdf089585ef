"""The fused retrieve's share of its roofline, in %: over the traced
slice's routes, the sum of each call's bound (eaglebench/bounds/route.py
at the bucket the kernels ran and the live rows the route read) over the
sum of the profiler's device time of its kernel 1
(`panel_gemm_kernel` / `panel_gemv_kernel`) and its select
(`topn_select_kernel`), every one the slice holds.

Each route launches one kernel 1 and one select, and the profiler holds
only the slice's routes, so the kernels are matched to the routes by
count, not by time: the card's and the host's clocks in a trace may
drift apart by more than a short route lasts. Where the counts differ
there is nothing to read."""
from eaglebench.bounds.route import retrieve_bound_ms

KERNEL_1 = ("panel_gemm_kernel", "panel_gemv_kernel")
SELECT = ("topn_select_kernel",)


def _has(name, keys):
    return any(k in name for k in keys)


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.slice_routes:
        return None
    k1 = [e.dur for e in tr.device if _has(e.name, KERNEL_1)]
    k2 = [e.dur for e in tr.device if _has(e.name, SELECT)]
    if not len(k1) == len(k2) == len(ctx.slice_routes):
        return None
    bound = sum(retrieve_bound_ms(
        qb, ctx.rows_fit + ctx.rows_per_batch * (ctx.warm + epoch), ctx.dim,
        ctx.n) for _, qb, epoch in ctx.slice_routes)
    return 100.0 * bound / ((sum(k1) + sum(k2)) / 1e3)
