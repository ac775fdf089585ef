"""Mean time of a route's `dispatch.stage` span: the copy of its queries
and budgets into the pinned host staging and the zero fill of the
bucket's rest."""
import numpy as np


def read(ctx):
    spans = ctx.spans.get("dispatch.stage", [])
    return float(np.mean(spans)) * 1e3 if spans else None
