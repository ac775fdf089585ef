"""How stale the router is: the window's time from each feedback batch's
due time to its commit's return (synchronised, the front replaced),
over the number of batches, in ms. Its wait behind queued routes is part
of it."""
import numpy as np


def read(ctx):
    return float(np.mean(ctx.fb_apply)) * 1e3 if ctx.fb_apply else None
