"""Mean `dispatch.device` span, on the card's clock: a route's H2D
copies of its queries and budgets and the replay of its captured step
(the fused retrieve and the replay kernel's route)."""
import numpy as np


def read(ctx):
    spans = ctx.spans.get("dispatch.device", [])
    return float(np.mean(spans)) * 1e3 if spans else None
