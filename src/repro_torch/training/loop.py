"""Training loop: data iterator -> train step -> checkpoints, the JAX
package's `training/loop.py` in PyTorch.

Used by `examples_torch/train_small.py` (a ~100M-parameter run) and by
`launch/train.py`. The step is eager: the forward under autograd, the
backward, then `AdamW.update` in place. Its attention runs the plain
`layers.attend` (`transformer.TRAIN_ATTENTION`), the counterpart of the
jnp `attend` the JAX train step differentiates: the CUDA attention
kernels have no backward, and their wrappers refuse inputs that need a
gradient.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch import tree as TR
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.training import checkpoint as CKPT
from repro_torch.training.optim import AdamW

def synthetic_lm_batches(cfg: ModelConfig, batch: int, seq: int,
                         seed: int = 0, device: DeviceLike = None
                         ) -> Iterator[Dict[str, Any]]:
    """Self-supervised synthetic corpus: noisy arithmetic progressions
    over the vocab, so the loss has signal to descend. The numpy draws
    are the JAX package's, so the integers are equal to its; "tokens"
    and "targets" (B, seq) int64 on the device."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    while True:
        start = rng.integers(0, cfg.vocab, (batch, 1))
        step = rng.integers(1, 17, (batch, 1))
        seqs = (start + step * np.arange(seq + 1)[None, :]) % cfg.vocab
        flip = rng.random((batch, seq + 1)) < 0.02
        noise = rng.integers(0, cfg.vocab, (batch, seq + 1))
        seqs = torch.from_numpy(np.where(flip, noise, seqs)).to(dev)
        yield {"tokens": seqs[:, :-1], "targets": seqs[:, 1:]}


def make_train_step(cfg: ModelConfig, optimizer: AdamW):
    """step(params, opt_state, batch) -> (params, opt_state, metrics): the
    gradient of `transformer.loss_fn` with respect to every master
    parameter, then the optimiser's update in place, with the JAX
    package's decay flags (`transformer.decay_flags`). metrics are the
    loss's fp32 scalars on the device, detached. The parameters come
    back as they went in, requiring no grad."""
    def train_step(params, opt_state, batch):
        masters = TR.leaves(params)
        for p in masters:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                total, metrics = T.loss_fn(cfg, params, batch)
                grads = torch.autograd.grad(total, masters)
        finally:
            for p in masters:
                p.requires_grad_(False)
        params, opt_state = optimizer.update(
            TR.unflatten(params, grads), opt_state, params,
            decay=T.decay_flags(params))
        return params, opt_state, {k: v.detach() for k, v in
                                   metrics.items()}

    return train_step


def train(cfg: ModelConfig, *, steps: int = 100, batch: int = 8,
          seq: int = 128, lr: float = 3e-4, seed: int = 0,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
          log_every: int = 10, data: Optional[Iterator] = None,
          device: DeviceLike = None) -> Dict[str, Any]:
    """Run a small training job on the device (the card unless `device`
    says otherwise): parameters drawn from `seed` (the mtp head too),
    AdamW(lr), `ce` logged every `log_every` steps and at the last,
    {"params", "opt"} saved to `ckpt_dir/step_N.npz` every `ckpt_every`
    steps. Returns {"params", "opt_state", "history": [(step, ce)],
    "wall": [(step, seconds since the start)] at each logged step (the
    ce read waits for the device)}."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.init_params(cfg, gen, train=True)
    opt = AdamW(lr=lr)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    it = data if data is not None else synthetic_lm_batches(
        cfg, batch, seq, seed, device=dev)

    history, wall = [], []
    t0 = time.perf_counter()
    for i in range(steps):
        params, opt_state, metrics = step_fn(params, opt_state, next(it))
        if i % log_every == 0 or i == steps - 1:
            ce = float(metrics["ce"])
            history.append((i, ce))
            wall.append((i, time.perf_counter() - t0))
            print(f"step {i:5d}  ce {ce:.4f}  "
                  f"({wall[-1][1] / (i + 1):.2f}s/step)", flush=True)
        if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
            CKPT.save(f"{ckpt_dir}/step_{i + 1}.npz",
                      {"params": params, "opt": opt_state}, step=i + 1)
    return {"params": params, "opt_state": opt_state, "history": history,
            "wall": wall}
