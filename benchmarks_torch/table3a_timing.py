"""Paper Table 3a on the port: training/updating time at the 70/85/100%
data stages.

Eagle: fit once on the first 70%, then INCREMENTAL updates for each +15%.
Baselines: full retrain on all data seen so far at every stage.

Methodology (as benchmarks/table3a_timing.py): every fit is run twice and
the SECOND measurement is kept. The first fit of an MLP or SVM router
captures its training step (the JAX package's jit compile); the second
replays it, and a timed fit that captured raises. Each time ends in a
synchronise of the card."""
from __future__ import annotations

import numpy as np

from benchmarks_torch import common as C
from repro_torch import DeviceLike, graphs
from repro_torch.data.routerbench import pairwise_feedback, winrate_targets

STAGES = (0.7, 0.85, 1.0)


def timed(fn, *args, **kw):
    """fn(*args, **kw), a fit that must run warm: one that captures a
    graph would time the capture, and raises."""
    c0 = graphs.capture_count()
    out = fn(*args, **kw)
    if graphs.capture_count() != c0:
        raise RuntimeError(f"a timed fit ({fn}) captured "
                           f"{graphs.capture_count() - c0} graph(s)")
    return out


def run(seeds=C.SEEDS, verbose=True, device: DeviceLike = None):
    names = ("eagle", "knn", "mlp", "svm")
    times = {n: {s: [] for s in STAGES} for n in names}

    for seed in seeds:
        corpus, _ = C.build(seed, device)
        eagle = None
        prev_n = 0
        for stage in STAGES:
            idx = corpus.stage_indices(stage)
            new_idx = idx[prev_n:]
            fb_new = pairwise_feedback(corpus, new_idx,
                                       seed=seed * 100 + int(stage * 100),
                                       pairs_per_query=C.PAIRS_PER_QUERY)
            records = (fb_new["emb"], fb_new["model_a"], fb_new["model_b"],
                       fb_new["outcome"])
            if eagle is None:
                C.fit_eagle(corpus, fb_new, device=device)  # warm
                eagle, secs = timed(C.fit_eagle, corpus, fb_new,
                                    device=device)
            else:
                eagle.update(*records, query_id=fb_new["query_idx"])  # warm
                secs = timed(eagle.update, *records,
                             query_id=fb_new["query_idx"])
            times["eagle"][stage].append(secs)

            # baselines retrain from scratch on the cumulative data
            fb_all = pairwise_feedback(corpus, idx, seed=seed,
                                       pairs_per_query=C.PAIRS_PER_QUERY)
            emb, tgt, mask = winrate_targets(fb_all, corpus.n_models)
            for name, r in C.baselines(corpus.costs, device):
                r.fit(emb, tgt, mask)                # warm
                times[name][stage].append(timed(r.fit, emb, tgt, mask))
            prev_n = len(idx)

    table = {n: {f"{int(s*100)}%": float(np.median(times[n][s]))
                 for s in STAGES} for n in names}
    ratios = {}
    for s in STAGES:
        base_mean = np.mean([np.median(times[n][s])
                             for n in ("knn", "mlp", "svm")])
        ratios[f"{int(s*100)}%"] = float(
            100.0 * np.median(times["eagle"][s]) / base_mean)
    out = {"seconds": table, "eagle_pct_of_baseline_mean": ratios}
    if verbose:
        print("[table3a] seconds (median over seeds):")
        for n in names:
            row = "  ".join(f"{table[n][f'{int(s*100)}%']*1e3:9.1f}ms"
                            for s in STAGES)
            print(f"  {n:6s} {row}")
        print(f"[table3a] eagle as % of baseline mean: "
              + "  ".join(f"{k}={v:.2f}%" for k, v in ratios.items()))
    C.save_json("table3a_timing.json", out)
    return out


if __name__ == "__main__":
    run()
