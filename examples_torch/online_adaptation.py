"""Online adaptation (paper §3.2) on the port: stream the 70 -> 85 ->
100% feedback stages, timing Eagle's incremental update against full
baseline retrains, and tracking test AUC after each stage: the paper's
update-speed claim, on the card (the counterpart of
`examples/online_adaptation.py`).

  PYTHONPATH=src python examples_torch/online_adaptation.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core.router import EagleConfig, EagleRouter
from repro_torch.data.routerbench import (evaluate_router, make_corpus,
                                          pairwise_feedback)
from repro_torch.routing.baselines import KNNRouter, MLPRouter, SVMRouter


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = args.device
    corpus = make_corpus(seed=0, n_per_dataset=200, dim=64)
    stages = [0.7, 0.85, 1.0]

    eagle = EagleRouter(corpus.model_names, corpus.costs,
                        EagleConfig(embed_dim=64), db_capacity=2048,
                        device=dev)
    if eagle.device.type == "cuda":
        print(f"on {torch.cuda.get_device_name(eagle.device)}")
    baselines = {"knn": KNNRouter(corpus.costs, device=dev),
                 "mlp": MLPRouter(corpus.costs, device=dev),
                 "svm": SVMRouter(corpus.costs, device=dev)}

    prev_n = 0
    for stage in stages:
        idx = corpus.stage_indices(stage)
        new_idx = idx[prev_n:]
        fb = pairwise_feedback(corpus, new_idx, seed=int(stage * 100),
                               pairs_per_query=8)
        if prev_n == 0:
            t_eagle = eagle.fit(fb["emb"], fb["model_a"], fb["model_b"],
                                fb["outcome"], query_id=fb["query_idx"])
        else:
            t_eagle = eagle.update(fb["emb"], fb["model_a"], fb["model_b"],
                                   fb["outcome"], query_id=fb["query_idx"])
        print(f"\n=== stage {int(stage*100)}% "
              f"({len(idx)} prompts, +{len(new_idx)} new) ===")
        print(f"  eagle {'update' if prev_n else 'fit':6s} "
              f"{t_eagle*1e3:9.1f} ms")
        for name, r in baselines.items():
            # baselines retrain from scratch on ALL data seen so far
            t = r.fit(corpus.embeddings[idx], corpus.quality[idx])
            print(f"  {name} retrain  {t*1e3:9.1f} ms "
                  f"({t/max(t_eagle,1e-9):6.1f}x eagle)")
        for name, r in {"eagle": eagle, **baselines}.items():
            auc = evaluate_router(lambda e, b: r.route(e, b), corpus)["auc"]
            print(f"  {name:6s} test AUC {auc:.4f}")
        prev_n = len(idx)


if __name__ == "__main__":
    main()
