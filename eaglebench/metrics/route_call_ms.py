"""Mean host time of a `RouteDispatcher` route call, which ends in its
host readout: the program's `dispatch.route` span (obs enabled), with
the sampled calls' `dispatch.route_result` (the same step, its top-n
rows read back too)."""
import numpy as np


def read(ctx):
    spans = ctx.spans.get("dispatch.route", []) + \
        ctx.spans.get("dispatch.route_result", [])
    return float(np.mean(spans)) * 1e3 if spans else None
