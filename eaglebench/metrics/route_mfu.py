"""The whole route's share of the card's fp32 peak, in %: the useful
operations of every routed query (the live queries only, not the
bucket's padding: the similarity to the live DB rows, the norms and the
replay; eaglebench/bounds/route.py) over every `route` call's wall time
(the harness's clock) times 67 TFLOP/s."""
from eaglebench.bounds import PEAK_FP32_FLOPS
from eaglebench.bounds.route import route_useful_ops


def read(ctx):
    wall = sum(ctx.route_s)
    if not wall:
        return None
    ops = sum(route_useful_ops(
        nq, ctx.rows_fit + ctx.rows_per_batch * (ctx.warm + epoch), ctx.dim,
        ctx.n, ctx.records) for nq, qb, epoch in ctx.routes)
    return 100.0 * ops / (wall * PEAK_FP32_FLOPS)
