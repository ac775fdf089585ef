"""AdamW, a copy of the JAX package's `training/optim.py` in PyTorch.

The API stays functional over a dict of tensors: `init(params) -> state`
and `update(grads, state, params) -> (params, state)`, where the state
is {"m", "v"} (dicts like `params`, in `state_dtype`: fp32, or bf16 to
save memory) and "step", an int32 tensor on the parameters' device.
`update` writes the parameters and the state in place and returns the
same dicts, so that a captured training step (`repro_torch.graphs`) owns
the tensors it updates; nothing in it reads a value back to the host.

The rules are the JAX package's, which `torch.optim.AdamW` does not
compute (it decays every parameter, and before the step):
  * clip by the global norm of all gradients, scale = min(1, clip /
    (norm + 1e-9)), when `grad_clip` is set;
  * bias corrections 1 - b ** step, taken in fp32;
  * decoupled weight decay added to the update of the tensors with two
    or more dimensions only;
  * lr scaled by `schedule(step)` where a schedule is given.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: torch.dtype = torch.float32
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def init(self, params: Params) -> Dict:
        def zeros():
            return {k: torch.zeros(p.shape, dtype=self.state_dtype,
                                   device=p.device)
                    for k, p in params.items()}
        device = next(iter(params.values())).device
        return {"m": zeros(), "v": zeros(),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def update(self, grads: Params, state: Dict, params: Params
               ) -> Tuple[Params, Dict]:
        step = state["step"]
        step.add_(1)
        lr = self.lr if self.schedule is None \
            else self.lr * self.schedule(step)

        if self.grad_clip:
            # summed in the JAX pytree's leaf order (sorted keys)
            gnorm = torch.sqrt(sum(torch.sum(torch.square(grads[k].float()))
                                   for k in sorted(grads)))
            scale = torch.clamp_max(self.grad_clip / (gnorm + 1e-9), 1.0)
        else:
            scale = 1.0

        c1 = 1.0 - self.b1 ** step.float()
        c2 = 1.0 - self.b2 ** step.float()
        for name, p in params.items():
            m, v = state["m"][name], state["v"][name]
            g32 = grads[name].float() * scale
            m32 = self.b1 * m.float() + (1 - self.b1) * g32
            v32 = self.b2 * v.float() + (1 - self.b2) * g32 * g32
            delta = (m32 / c1) / (torch.sqrt(v32 / c2) + self.eps)
            if p.ndim >= 2:  # decoupled weight decay on matrices only
                delta = delta + self.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            m.copy_(m32)
            v.copy_(v32)
        return params, state


def cosine_schedule(warmup: int, total: int) -> Callable:
    """Linear warmup to 1 over `warmup` steps, then a cosine to 0 at
    `total`; a function of the device step."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = torch.clamp_max(s / max(warmup, 1), 1.0)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return warm * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return fn
