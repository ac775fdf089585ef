"""Quickstart on the port: build an Eagle router over the 10-model fleet,
fit it on pairwise feedback, and route budget-constrained queries, on
the card (the counterpart of `examples/quickstart.py`).

  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.router import EagleConfig, EagleRouter
from repro_torch.core.state import route_batch
from repro_torch.data.routerbench import (evaluate_router, make_corpus,
                                          pairwise_feedback)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    # 1. a RouterBench-like corpus over the assigned 10-architecture fleet
    corpus = make_corpus(seed=0, n_per_dataset=120, dim=64)
    print(f"fleet: {corpus.model_names}")
    print(f"costs: {np.round(corpus.costs, 2)}")

    # 2. user feedback history (pairwise comparisons) for the train split
    fb = pairwise_feedback(corpus, corpus.train_idx, seed=0,
                           pairs_per_query=8)
    print(f"history: {len(fb['outcome'])} comparisons "
          f"over {len(corpus.train_idx)} prompts")

    # 3. fit Eagle (training-free: one ELO pass + DB insert)
    router = EagleRouter(corpus.model_names, corpus.costs,
                         EagleConfig(embed_dim=64), db_capacity=2048,
                         device=args.device)
    if router.device.type == "cuda":
        print(f"on {torch.cuda.get_device_name(router.device)}")
    secs = router.fit(fb["emb"], fb["model_a"], fb["model_b"], fb["outcome"],
                      query_id=fb["query_idx"])
    print(f"fit in {secs*1e3:.1f} ms; global ELO ratings:")
    for name, r in zip(corpus.model_names,
                       router.global_ratings.cpu().numpy()):
        print(f"  {name:26s} {r:7.1f}")

    # 4. route some test queries at different budgets: the whole hot path
    #    (the fused retrieve -> replay -> budget masking) runs on the
    #    device-resident RouterState
    q = corpus.embeddings[corpus.test_idx[:4]]
    for budget in (corpus.costs.min() * 1.5, corpus.costs.max()):
        picks = router.route(q, float(budget)).cpu().numpy()
        names = [corpus.model_names[i] for i in picks]
        print(f"budget {budget:6.1f}: {names}")

    # 4b. or call the functional core directly (what ServingEngine
    #     does). NOTE: router.state is valid until the router's next
    #     write — re-read it after fit/update rather than caching it.
    res = route_batch(router.state, q,
                      np.full(len(q), float(corpus.costs.max()),
                              np.float32),
                      router.costs, p_global=router.cfg.p_global,
                      n_neighbors=router.cfg.n_neighbors,
                      k=router.cfg.k_factor)
    print(f"route_batch choices {res.choices.cpu().tolist()}, "
          f"top-1 neighbors {res.topk_idx[:, 0].cpu().tolist()}")

    # 5. cost-quality curve + AUC on the test split
    auc = evaluate_router(lambda e, b: router.route(e, b), corpus)["auc"]
    print(f"AUC over the budget grid: {auc:.4f}")

    # 6. online update with fresh feedback (no retraining)
    fb2 = pairwise_feedback(corpus, corpus.test_idx[:50], seed=7,
                            pairs_per_query=4)
    secs = router.update(fb2["emb"], fb2["model_a"], fb2["model_b"],
                         fb2["outcome"], query_id=fb2["query_idx"])
    print(f"online update with {len(fb2['outcome'])} new records "
          f"in {secs*1e3:.1f} ms")


if __name__ == "__main__":
    main()
