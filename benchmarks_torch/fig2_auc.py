"""Paper Fig. 2a/2b on the port: cost->quality curves + per-dataset AUC,
Eagle vs KNN/MLP/SVM, in both supervision regimes (online = feedback-only,
the paper's deployment scenario; offline = full quality matrix)."""
from __future__ import annotations

import numpy as np

from benchmarks_torch import common as C
from repro_torch import DeviceLike
from repro_torch.data.routerbench import DATASETS, evaluate_router


def run(seeds=C.SEEDS, verbose=True, device: DeviceLike = None):
    out = {"regimes": {}, "curve_mmlu": None}
    for regime in ("online", "offline"):
        accum = {k: [] for k in ("eagle", "knn", "mlp", "svm")}
        per_ds = {k: {d: [] for d in DATASETS} for k in accum}
        for seed in seeds:
            corpus, fb = C.build(seed, device)
            eagle, _ = C.fit_eagle(corpus, fb, device=device)
            routers = {"eagle": eagle}
            routers.update({k: v[0] for k, v in C.fit_baselines(
                corpus, fb, regime, device).items()})
            for name, r in routers.items():
                accum[name].append(C.sum_auc(r, corpus))
                for d, auc in C.per_dataset_auc(r, corpus).items():
                    per_ds[name][d].append(auc)
            if regime == "online" and seed == seeds[0]:
                # Fig 2a: the MMLU cost->quality curve
                curves = {}
                for name, r in routers.items():
                    res = evaluate_router(lambda e, b: r.route(e, b), corpus,
                                          dataset=0)
                    curves[name] = {"budgets": res["budgets"].tolist(),
                                    "quality": res["quality"].tolist()}
                out["curve_mmlu"] = curves
        summary = {k: {"mean": float(np.mean(v)), "std": float(np.std(v)),
                       "per_dataset": {d: float(np.mean(a))
                                       for d, a in per_ds[k].items()}}
                   for k, v in accum.items()}
        e = summary["eagle"]["mean"]
        summary["improvement_vs"] = {
            k: 100.0 * (e / summary[k]["mean"] - 1.0)
            for k in ("knn", "mlp", "svm")}
        out["regimes"][regime] = summary
        if verbose:
            imp = summary["improvement_vs"]
            print(f"[fig2/{regime}] summed AUC: " + "  ".join(
                f"{k} {summary[k]['mean']:.3f}" for k in accum))
            print(f"[fig2/{regime}] eagle improvement: "
                  f"knn +{imp['knn']:.2f}%  mlp +{imp['mlp']:.2f}%  "
                  f"svm +{imp['svm']:.2f}%")
    C.save_json("fig2_auc.json", out)
    return out


if __name__ == "__main__":
    run()
