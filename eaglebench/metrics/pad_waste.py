"""The share of the rows the dispatcher sent to the card that were
padding: (padded rows - rows) / padded rows over the window, from the
program's counters (`RouteDispatcher.telemetry()`), in %."""


def read(ctx):
    t = ctx.telemetry
    if not t or not t["padded_rows"]:
        return None
    return 100.0 * (t["padded_rows"] - t["rows"]) / t["padded_rows"]
