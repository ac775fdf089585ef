"""Mean wall time of `DoubleBuffer.commit` after a feedback batch, with
a synchronise after it (the front replica then holds the batch), by the
harness's clock around the two."""
import numpy as np


def read(ctx):
    return float(np.mean(ctx.commit_s)) * 1e3 if ctx.commit_s else None
