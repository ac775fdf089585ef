"""Mean `state.commit` span over the window's feedback batches (the
set-up's `ctx.warm` batches, the first spans, left out, as `commit_ms`
leaves them out): the host's part of `DoubleBuffer.commit` (the ledger's
drain, the gather of the rows, the copies), without the synchronise the
harness adds after it."""
import numpy as np


def read(ctx):
    spans = ctx.spans.get("state.commit", [])[ctx.warm:]
    return float(np.mean(spans)) * 1e3 if spans else None
