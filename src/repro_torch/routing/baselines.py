"""Baseline routers from the paper (RouterBench-style): KNN, MLP, SVM —
the port of the JAX package's `routing/baselines.py`.

All three are quality-vector regressors f(embedding) -> (M,) predicted
quality, trained on the pointwise quality matrix, or on win-rate targets
with a mask of the observed entries (`data.routerbench.winrate_targets`):

  * KNN — 40 nearest neighbours by cosine similarity (Appendix A.2),
    through the fused retrieve (`kernels/ops.py:similarity_topk`: no
    score panel, ties to the lowest row, JAX's order); the masked mean
    quality of the neighbours, 0.5 where none observed the model.
    "Training" stores the normalised corpus.
  * MLP — two layers, hidden 100, ReLU, masked MSE, AdamW full-batch
    epochs (lr 1e-3, no decay, no clip).
  * SVM — LinearSVR with epsilon = 0 per model: the epsilon-insensitive
    L1 loss + L2 regularisation, by subgradient descent (AdamW, lr 5e-3).

The MLP's and the SVM's training step (forward, `torch.autograd.grad`,
the AdamW update in place) runs on the card as one captured graph
(`graphs.Step`), the counterpart of the `jax.jit` around the JAX step.
Each router keeps its steps in a `graphs.StepCache` keyed by the data's
(Q, D, M): the first fit of a shape captures, a later one writes its data,
fresh initial weights and zeroed moments into the step's tensors and
replays. On the CPU the step runs eagerly.

fit()/update() return wall seconds (Table 3a), after a synchronise on
the card. Baselines RETRAIN FROM SCRATCH on update (the paper's point:
no incremental path).
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from repro_torch import DeviceLike, graphs, resolve_device
from repro_torch.core.state import select_within_budget
from repro_torch.kernels import ops as KOPS
from repro_torch.training.optim import AdamW

Params = Dict[str, torch.Tensor]


class BaselineRouter:
    """Shared budget selection (the `select_within_budget` the Eagle
    pipeline uses)."""

    def __init__(self, costs, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.costs = self._f32(costs)

    def _f32(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict(self, emb) -> torch.Tensor:  # (Q, M) quality scores
        raise NotImplementedError

    def route(self, emb, budget) -> torch.Tensor:
        choice, _ = select_within_budget(self.predict(emb), self.costs, budget)
        return choice

    def fit(self, emb, quality, mask=None) -> float:
        """mask: optional (Q, M) observed-entry mask — the feedback-only
        supervision regime (targets are win-rates derived from the same
        pairwise comparisons Eagle consumes)."""
        raise NotImplementedError

    def update(self, emb, quality, mask=None) -> float:
        """Baselines have no incremental path: full retrain (paper §3.2)."""
        return self.fit(emb, quality, mask)


class KNNRouter(BaselineRouter):
    def __init__(self, costs, n_neighbors: int = 40, backend: str = "cuda",
                 device: DeviceLike = None):
        super().__init__(costs, device)
        self.n = n_neighbors
        self.backend = backend
        self.emb: Optional[torch.Tensor] = None
        self.quality: Optional[torch.Tensor] = None
        self.mask: Optional[torch.Tensor] = None

    def fit(self, emb, quality, mask=None) -> float:
        t0 = time.perf_counter()
        emb = self._f32(emb)
        self.quality = self._f32(quality)
        self.mask = (self._f32(mask) if mask is not None
                     else torch.ones_like(self.quality))
        # build = normalise the index (KNN "training")
        self.emb = emb / (torch.linalg.norm(emb, dim=-1, keepdim=True) + 1e-9)
        self._sync()
        return time.perf_counter() - t0

    def predict(self, emb) -> torch.Tensor:
        _, idx = KOPS.similarity_topk(self._f32(emb), self.emb,
                                      min(self.n, self.emb.shape[0]),
                                      backend=self.backend)
        # plain KNN mean (Appendix A.2: distance only selects the
        # neighbourhood); with feedback-only supervision, unobserved
        # entries are masked out
        m = self.mask[idx]
        num = torch.sum(self.quality[idx] * m, dim=1)
        den = torch.sum(m, dim=1)
        return torch.where(den > 0, num / torch.clamp_min(den, 1.0), 0.5)


class TrainStep:
    """One full-batch training step of a gradient router over tensors of
    its own (the static tensors of a captured step): the loss, its
    gradients, and the AdamW update in place. `load` writes a fit's data
    and initial weights in and zeroes the optimiser; each call takes one
    step and writes the loss before it into `losses[step % epochs]` (a
    ring: a step past `epochs` stays in bounds on the device)."""

    def __init__(self, router: "GradientRouter", x, y, init: Params):
        self.router = router
        self.x, self.y, self.mk = (torch.empty_like(x), torch.empty_like(y),
                                   torch.empty_like(y))
        self.params = {k: torch.empty_like(v).requires_grad_()
                       for k, v in init.items()}
        self.state = router.opt.init(self.params)
        self.losses = torch.empty(router.epochs, device=x.device)

    @torch.no_grad()
    def load(self, x, y, mk, init: Params) -> "TrainStep":
        self.x.copy_(x)
        self.y.copy_(y)
        self.mk.copy_(mk)
        for k, p in self.params.items():
            p.copy_(init[k])
        for t in (*self.state["m"].values(), *self.state["v"].values(),
                  self.state["step"], self.losses):
            t.zero_()
        return self

    def __call__(self) -> torch.Tensor:
        names = list(self.params)
        loss = self.router._loss(self.params, self.x, self.y, self.mk)
        grads = torch.autograd.grad(loss, [self.params[k] for k in names])
        with torch.no_grad():
            at = torch.remainder(self.state["step"].long(), len(self.losses))
            self.losses.index_copy_(0, at.view(1), loss.view(1))
            self.router.opt.update(dict(zip(names, grads)), self.state,
                                   self.params)
        return loss


class GradientRouter(BaselineRouter):
    """A router fitted by `epochs` full-batch AdamW steps of `_loss` from
    the weights `_init` makes; the step is captured per (Q, D, M)."""

    def __init__(self, costs, epochs: int, opt: AdamW,
                 device: DeviceLike = None):
        super().__init__(costs, device)
        self.epochs = epochs
        self.opt = opt
        # the last fit's weights and losses: the captured step's own
        # tensors, which a later fit of the same shape overwrites
        self.params: Optional[Params] = None
        self.losses: Optional[torch.Tensor] = None   # (epochs,)
        self._steps = graphs.StepCache()

    def _init(self, d: int, m: int) -> Params:
        raise NotImplementedError

    def _loss(self, p: Params, x, y, mk) -> torch.Tensor:
        raise NotImplementedError

    def _make(self, x, y, mk, init: Params, pool):
        train = TrainStep(self, x, y, init).load(x, y, mk, init)
        return train, graphs.Step(train, device=self.device, pool=pool)

    def fit(self, emb, quality, mask=None) -> float:
        x = self._f32(emb)
        y = self._f32(quality)
        mk = self._f32(mask) if mask is not None else torch.ones_like(y)
        t0 = time.perf_counter()
        init = self._init(x.shape[1], y.shape[1])
        train, step = self._steps.get(
            (x.shape[0], x.shape[1], y.shape[1]),
            lambda pool: self._make(x, y, mk, init, pool),
            device=self.device)
        # a capture ran one real step eagerly first (graphs.Step): start
        # every fit, the first included, from the initial weights
        train.load(x, y, mk, init)
        for _ in range(self.epochs):
            step()
        self._sync()
        self.params, self.losses = train.params, train.losses
        return time.perf_counter() - t0

    def cache_stats(self) -> Dict:
        """The step cache's ledger (misses == captures on the card)."""
        return self._steps.as_dict()


class MLPRouter(GradientRouter):
    def __init__(self, costs, hidden: int = 100, epochs: int = 300,
                 lr: float = 1e-3, seed: int = 0, device: DeviceLike = None):
        super().__init__(costs, epochs,
                         AdamW(lr=lr, weight_decay=0.0, grad_clip=0.0),
                         device)
        self.hidden = hidden
        self.seed = seed

    def _init(self, d, m) -> Params:
        """The initial weights: JAX's shapes and scales, drawn from an
        explicit generator on the host (the only place they are made)."""
        g = torch.Generator().manual_seed(self.seed)
        w1 = torch.randn((d, self.hidden), generator=g) * d ** -0.5
        w2 = torch.randn((self.hidden, m), generator=g) * self.hidden ** -0.5
        return {"w1": w1.to(self.device),
                "b1": torch.zeros(self.hidden, device=self.device),
                "w2": w2.to(self.device),
                "b2": torch.zeros(m, device=self.device)}

    @staticmethod
    def _fwd(params, x):
        h = torch.relu(x @ params["w1"] + params["b1"])
        return h @ params["w2"] + params["b2"]

    def _loss(self, p, x, y, mk):
        se = (self._fwd(p, x) - y) ** 2 * mk
        return se.sum() / torch.clamp_min(mk.sum(), 1.0)

    @torch.no_grad()
    def predict(self, emb) -> torch.Tensor:
        return self._fwd(self.params, self._f32(emb))


class _Hinge(torch.autograd.Function):
    """max(|r| - eps, 0) with JAX's subgradient. `jax.grad` of `jnp.abs`
    is 1 at r >= 0 (-0.0 included), and `jnp.maximum` gives each side
    half the gradient at a tie, so the JAX hinge has slope 0.5 at |r| =
    eps; torch's `abs` and `clamp_min` give 0 there. The SVM starts from
    w = b = 0, where every target of 0 gives r = 0 exactly, so the two
    conventions part in the first step."""

    @staticmethod
    def forward(ctx, r, eps: float):
        ctx.save_for_backward(r)
        ctx.eps = eps
        return torch.clamp_min(r.abs() - eps, 0.0)

    @staticmethod
    def backward(ctx, g):
        (r,) = ctx.saved_tensors
        a = r.abs() - ctx.eps
        d_max = torch.where(a > 0, 1.0, torch.where(a == 0, 0.5, 0.0))
        d_abs = torch.where(r >= 0, 1.0, -1.0)
        return g * d_max * d_abs, None


class SVMRouter(GradientRouter):
    """LinearSVR (epsilon=0) per model: L1-insensitive loss, subgradient."""

    def __init__(self, costs, epochs: int = 300, lr: float = 5e-3,
                 reg: float = 1e-4, epsilon: float = 0.0,
                 device: DeviceLike = None):
        super().__init__(costs, epochs,
                         AdamW(lr=lr, weight_decay=0.0, grad_clip=0.0),
                         device)
        self.lr = lr
        self.reg = reg
        self.epsilon = epsilon

    def _init(self, d, m) -> Params:
        return {"w": torch.zeros((d, m), device=self.device),
                "b": torch.zeros(m, device=self.device)}

    def _loss(self, p, x, y, mk):
        r = x @ p["w"] + p["b"] - y
        hinge = _Hinge.apply(r, self.epsilon) * mk   # eps-insensitive
        return hinge.sum() / torch.clamp_min(mk.sum(), 1.0) \
            + self.reg * torch.sum(p["w"] ** 2)

    @property
    def w(self) -> torch.Tensor:
        return self.params["w"].detach()

    @property
    def b(self) -> torch.Tensor:
        return self.params["b"].detach()

    @torch.no_grad()
    def predict(self, emb) -> torch.Tensor:
        return self._f32(emb) @ self.params["w"] + self.params["b"]
