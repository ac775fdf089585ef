"""Mean `router.update.add` span over the window's feedback batches (the
set-up's `ctx.warm` batches, the first spans, left out, as `update_ms`
leaves them out): the DB's append of a batch inside `EagleRouter.update`
(`VectorDB.add`)."""
import numpy as np


def read(ctx):
    spans = ctx.spans.get("router.update.add", [])[ctx.warm:]
    return float(np.mean(spans)) * 1e3 if spans else None
