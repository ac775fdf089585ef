"""Mean host time of a `RouteDispatcher` route call: its
`dispatch.route` and `dispatch.route_result` spans' mean less the mean
of its `dispatch.device` spans (the H2D copies and the replay on the
card's clock, one a route). None when the two counts differ (no device
span, as before the program recorded them)."""
import numpy as np


def read(ctx):
    route = ctx.spans.get("dispatch.route", []) + \
        ctx.spans.get("dispatch.route_result", [])
    device = ctx.spans.get("dispatch.device", [])
    if not route or len(route) != len(device):
        return None
    return (float(np.mean(route)) - float(np.mean(device))) * 1e3
