"""Paper Fig. 4 on the port: (a) Eagle vs Eagle-Global-only vs
Eagle-Local-only; (b) local neighbour size N sweep."""
from __future__ import annotations

import numpy as np

from benchmarks_torch import common as C
from repro_torch import DeviceLike
from repro_torch.core.router import (EagleRouter, GlobalOnlyRouter,
                                     LocalOnlyRouter)

N_SWEEP = (5, 10, 20, 40, 80)


def run(seeds=C.SEEDS, verbose=True, device: DeviceLike = None):
    # (a) component ablation
    comp = {k: [] for k in ("eagle", "global_only", "local_only")}
    builds = []
    for seed in seeds:
        corpus, fb = C.build(seed, device)
        builds.append((corpus, fb))
        for name, cls in (("eagle", EagleRouter),
                          ("global_only", GlobalOnlyRouter),
                          ("local_only", LocalOnlyRouter)):
            r, _ = C.fit_eagle(corpus, fb, cls=cls, device=device)
            comp[name].append(C.sum_auc(r, corpus))
    comp_summary = {k: {"mean": float(np.mean(v)), "std": float(np.std(v))}
                    for k, v in comp.items()}

    # (b) neighbour size sweep
    n_sweep = {}
    for n in N_SWEEP:
        vals = []
        for corpus, fb in builds:
            r, _ = C.fit_eagle(corpus, fb, device=device, n_neighbors=n)
            vals.append(C.sum_auc(r, corpus))
        n_sweep[n] = {"mean": float(np.mean(vals)), "std": float(np.std(vals))}

    out = {"components": comp_summary, "n_sweep": n_sweep}
    if verbose:
        print("[fig4a] " + "  ".join(
            f"{k} {v['mean']:.3f}" for k, v in comp_summary.items()))
        print("[fig4b] N sweep: " + "  ".join(
            f"N={n}:{v['mean']:.3f}" for n, v in n_sweep.items()))
    C.save_json("fig4_ablation.json", out)
    return out


if __name__ == "__main__":
    run()
