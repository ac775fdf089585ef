"""Carry router state, model parameters and baseline-router parameters
across from host arrays, so the port can route over exactly the state,
and run exactly the weights, another implementation built (the parity
tests hand over the JAX package's RouterState field by field, its
`init_params` pytree leaf by leaf and a baseline's initial weights, each
taken with `np.asarray`)."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.state import RouterState
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Params, check_supported, \
    torch_dtype

_DTYPES = {"global_ratings": np.float32, "emb": np.float32,
           "model_a": np.int32, "model_b": np.int32, "outcome": np.float32,
           "valid": np.bool_, "size": np.int32}


def ratings_from_numpy(ratings, device: DeviceLike = None) -> torch.Tensor:
    """(M,) float32 rating vector on the device."""
    return torch.tensor(np.asarray(ratings, np.float32),
                        device=resolve_device(device))


def state_from_numpy(fields: Mapping[str, np.ndarray],
                     device: DeviceLike = None) -> RouterState:
    """RouterState from a mapping of its 7 field names to host arrays."""
    missing = set(_DTYPES) - set(fields)
    if missing:
        raise ValueError(f"state_from_numpy: missing fields {sorted(missing)}")
    dev = resolve_device(device)
    return RouterState(**{
        name: torch.tensor(np.asarray(fields[name], dtype), device=dev)
        for name, dtype in _DTYPES.items()})


#: attention projections stored as (d, H, hd) / (H, hd, d) in the JAX
#: pytree; the port keeps them as 2-D matrices
_FLATTEN = {"wq": lambda a: a.reshape(a.shape[0], -1),
            "wk": lambda a: a.reshape(a.shape[0], -1),
            "wv": lambda a: a.reshape(a.shape[0], -1),
            "wo": lambda a: a.reshape(-1, a.shape[-1])}


def model_params_from_numpy(cfg: ModelConfig, tree: Mapping,
                            device: DeviceLike = None) -> Params:
    """The port's parameters (`transformer.init_params`' layout) from a
    model's pytree in the JAX package's layout, each leaf taken with
    `np.asarray`: the stacked (L, ...) leaves of every block group
    (dense and decoder blocks with their cross-attention, encoder
    blocks, mamba2 blocks) are split per layer and the attention
    projections flattened to 2-D. Values and the type `cfg.param_dtype`
    are kept exactly."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)

    def t(a, name=""):
        a = np.asarray(a, np.float32)   # bf16 widens exactly
        return torch.tensor(_FLATTEN.get(name, lambda x: x)(a),
                            device=dev).to(dtype)

    def per_layer(blocks, n):
        leaves = {group: {name: np.asarray(leaf, np.float32)
                          for name, leaf in sub.items()}
                  for group, sub in blocks.items()}
        return [{group: {name: t(leaf[i], name)
                         for name, leaf in sub.items()}
                 for group, sub in leaves.items()}
                for i in range(n)]

    norm = lambda p: {k: t(v) for k, v in p.items()}
    out: Params = {"embed": t(tree["embed"]),
                   "final_norm": norm(tree["final_norm"])}
    if "lm_head" in tree:
        out["lm_head"] = t(tree["lm_head"])
    out["blocks"] = per_layer(tree["blocks"], cfg.n_layers)
    if cfg.arch_type == "encdec":
        out["enc_blocks"] = per_layer(tree["enc_blocks"], cfg.n_enc_layers)
        out["enc_norm"] = norm(tree["enc_norm"])
    return out


def router_params_from_numpy(tree: Mapping[str, np.ndarray],
                             device: DeviceLike = None
                             ) -> Dict[str, torch.Tensor]:
    """A baseline router's parameters (`routing/baselines.py`: the MLP's
    w1, b1, w2, b2, the SVM's w, b) from a flat mapping of host arrays,
    as fp32 tensors on the device, values kept exactly."""
    dev = resolve_device(device)
    return {name: torch.tensor(np.asarray(a, np.float32), device=dev)
            for name, a in tree.items()}
