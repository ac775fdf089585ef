"""Mean wall time of `EagleRouter.update` on a feedback batch (the DB's
append and the global fold, which ends in a synchronise), by the
harness's clock around the call."""
import numpy as np


def read(ctx):
    return float(np.mean(ctx.update_s)) * 1e3 if ctx.update_s else None
