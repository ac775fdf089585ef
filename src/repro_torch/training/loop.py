"""Training loop: data iterator -> train step -> checkpoints, the JAX
package's `training/loop.py` in PyTorch.

Used by `examples_torch/train_small.py` (a ~100M-parameter run) and by
`launch/train.py`. The step is eager: the forward under autograd, the
backward, then `AdamW.update` in place. Its attention runs the plain
`layers.attend` (`transformer.TRAIN_ATTENTION`), the counterpart of the
jnp `attend` the JAX train step differentiates: the CUDA attention
kernels have no backward, and their wrappers refuse inputs that need a
gradient.

On a fleet mesh (`launch/mesh.py`) the step is SPMD, one rank a
process, where JAX's is one GSPMD program (its `train` places no
parameter shardings: the mesh reaches only the MoE's `shard_map`). Each
rank keeps the whole parameter tree, takes its batch shard of the global
batch (contiguous rows, batch-rank order over the axes other than
"model"), and runs the forward on it; the MoE layers split their experts
over "model" (models/moe.py). Then the gradients are summed over the
batch axes and divided by their rank count, so that the step is the
gradient of the mean of the shards' losses (the global batch's mean
where the shards hold as many unmasked targets: the synthetic corpus
masks none), and the routed experts' weights are summed over "model"
first, where each rank computed its own experts only; what every model
rank computed redundantly is not summed there. AdamW's global-norm clip
then sees the global gradient, and the metrics are the batch ranks'
mean. On DTensors (the dry-run's meshes) none of this applies: DTensor
places the collectives, as GSPMD does.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import DeviceLike, resolve_device
from repro_torch import sharding as SH
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


def _all_reduce(t, groups):
    for g in groups:
        dist.all_reduce(t, group=g)
    return t


def make_train_step(cfg: ModelConfig, optimizer: AdamW, mesh=None,
                    constrain=None):
    """step(params, opt_state, batch) -> (params, opt_state, metrics): the
    gradient of `transformer.loss_fn` with respect to every master
    parameter, then the optimiser's update in place, with the JAX
    package's decay flags (`transformer.decay_flags`). metrics are the
    loss's fp32 scalars on the device, detached. The parameters come
    back as they went in, requiring no grad. With a `mesh` (JAX's
    signature) on plain tensors the step is SPMD (module docstring):
    `batch` is the global batch, of which the step takes this rank's
    shard; `constrain` is passed to the loss (the JAX constraint points;
    the identity on plain tensors)."""
    def train_step(params, opt_state, batch):
        masters = TR.leaves(params)
        spmd = mesh is not None and not SH.is_dtensor(masters[0])
        if spmd:
            index, n, groups = SH.batch_shard(mesh)
            rows = TR.leaves(batch)[0].shape[0]
            if rows % n:
                raise ValueError(f"a global batch of {rows} rows does not "
                                 f"split over {n} batch ranks")
            k = rows // n
            batch = {name: v[index * k:(index + 1) * k]
                     for name, v in batch.items()}
        for p in masters:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                total, metrics = T.loss_fn(cfg, params, batch, mesh=mesh,
                                           constrain=constrain)
                grads = torch.autograd.grad(total, masters)
        finally:
            for p in masters:
                p.requires_grad_(False)
        metrics = {key: v.detach() for key, v in metrics.items()}
        if spmd:
            model = [mesh.get_group("model")] \
                if SH.axis_sizes(mesh).get("model", 1) > 1 else []
            experts = TR.leaves(T.expert_flags(cfg, params))
            grads = [_all_reduce(g.contiguous(),
                                 (model if e else []) + groups) / n
                     for g, e in zip(grads, experts)]
            metrics = {key: _all_reduce(v.clone(), groups) / n
                       for key, v in metrics.items()}
        params, opt_state = optimizer.update(
            TR.unflatten(params, grads), opt_state, params,
            decay=T.decay_flags(params))
        return params, opt_state, metrics

    return train_step


def train(cfg: ModelConfig, *, steps: int = 100, batch: int = 8,
          seq: int = 128, lr: float = 3e-4, seed: int = 0,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
          log_every: int = 10, mesh=None, data: Optional[Iterator] = None,
          device: DeviceLike = None) -> Dict[str, Any]:
    """Run a small training job on the device (the card unless `device`
    says otherwise): parameters drawn from `seed` (the mtp head too),
    AdamW(lr), `ce` logged every `log_every` steps and at the last,
    {"params", "opt"} saved to `ckpt_dir/step_N.npz` every `ckpt_every`
    steps. Returns {"params", "opt_state", "history": [(step, ce)],
    "wall": [(step, seconds since the start)] at each logged step (the
    ce read waits for the device)}. With a `mesh` every rank draws the
    same parameters and batches and trains SPMD (`make_train_step`); the
    log and the checkpoints are rank 0's."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.init_params(cfg, gen, train=True)
    opt = AdamW(lr=lr)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, mesh=mesh)
    lead = mesh is None or dist.get_rank() == 0
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
            if lead:
                print(f"step {i:5d}  ce {ce:.4f}  "
                      f"({wall[-1][1] / (i + 1):.2f}s/step)", flush=True)
        if lead and ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
            CKPT.save(f"{ckpt_dir}/step_{i + 1}.npz",
                      {"params": params, "opt": opt_state}, step=i + 1)
    return {"params": params, "opt_state": opt_state, "history": history,
            "wall": wall}
