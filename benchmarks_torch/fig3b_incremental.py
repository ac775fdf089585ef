"""Paper Fig. 3b on the port: test AUC as the feedback stream grows 70% ->
85% -> 100%. Eagle updates incrementally; baselines retrain on the
cumulative data."""
from __future__ import annotations

import numpy as np

from benchmarks_torch import common as C
from repro_torch import DeviceLike
from repro_torch.data.routerbench import pairwise_feedback, winrate_targets

STAGES = (0.7, 0.85, 1.0)


def run(seeds=C.SEEDS, verbose=True, device: DeviceLike = None):
    names = ("eagle", "knn", "mlp", "svm")
    aucs = {n: {s: [] for s in STAGES} for n in names}

    for seed in seeds:
        corpus, _ = C.build(seed, device)
        eagle = None
        prev_n = 0
        for stage in STAGES:
            idx = corpus.stage_indices(stage)
            fb_new = pairwise_feedback(
                corpus, idx[prev_n:], seed=seed * 100 + int(stage * 100),
                pairs_per_query=C.PAIRS_PER_QUERY)
            if eagle is None:
                eagle, _ = C.fit_eagle(corpus, fb_new, device=device)
            else:
                eagle.update(fb_new["emb"], fb_new["model_a"],
                             fb_new["model_b"], fb_new["outcome"],
                             query_id=fb_new["query_idx"])
            aucs["eagle"][stage].append(C.sum_auc(eagle, corpus))

            fb_all = pairwise_feedback(corpus, idx, seed=seed,
                                       pairs_per_query=C.PAIRS_PER_QUERY)
            emb, tgt, mask = winrate_targets(fb_all, corpus.n_models)
            for name, r in C.baselines(corpus.costs, device):
                r.fit(emb, tgt, mask)
                aucs[name][stage].append(C.sum_auc(r, corpus))
            prev_n = len(idx)

    table = {n: {f"{int(s*100)}%": float(np.mean(aucs[n][s]))
                 for s in STAGES} for n in names}
    imp = {}
    for s in STAGES:
        base = np.mean([np.mean(aucs[n][s]) for n in ("knn", "mlp", "svm")])
        imp[f"{int(s*100)}%"] = float(
            100.0 * (np.mean(aucs["eagle"][s]) / base - 1.0))
    out = {"auc": table, "eagle_improvement_vs_baseline_mean_pct": imp}
    if verbose:
        print("[fig3b] summed AUC by stage:")
        for n in names:
            row = "  ".join(f"{table[n][f'{int(s*100)}%']:.3f}"
                            for s in STAGES)
            print(f"  {n:6s} {row}")
        print("[fig3b] eagle improvement vs baseline mean: "
              + "  ".join(f"{k}=+{v:.2f}%" for k, v in imp.items()))
    C.save_json("fig3b_incremental.json", out)
    return out


if __name__ == "__main__":
    run()
