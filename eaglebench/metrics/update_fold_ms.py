"""Mean `router.update.fold` plus mean `router.update.sync` span over the
window's feedback batches (the set-up's `ctx.warm` batches, the first
spans, left out): the global fold's enqueue inside `EagleRouter.update`
(the pinned pack, the H2D copy, the scan) and the synchronise that waits
for it."""
import numpy as np


def read(ctx):
    fold = ctx.spans.get("router.update.fold", [])[ctx.warm:]
    sync = ctx.spans.get("router.update.sync", [])[ctx.warm:]
    if not fold or not sync:
        return None
    return (float(np.mean(fold)) + float(np.mean(sync))) * 1e3
