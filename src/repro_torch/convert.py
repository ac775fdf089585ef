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
    hybrid_shape, torch_dtype

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
    blocks, mamba2 blocks, the moe family's dense_blocks then moe_blocks,
    either of which may be None, into one list; the hybrid family's
    (G, per, ...) groups into G lists and its tail) are split per layer,
    at any depth of nesting (a MoE's "shared" dict), and the attention
    projections flattened to 2-D (MLA's wo too; its (r, H, k) up
    projections keep their shape); the hybrid's unstacked shared block
    is taken as one block; the (E, d, ff) expert leaves keep their
    shape. deepseek-v3's multi-token-prediction head ("mtp"), where the
    tree holds one, is carried as `init_params(..., train=True)` lays
    it out (its block unstacked, as the shared block). Values and the
    type `cfg.param_dtype` are kept exactly. Any tree of that layout
    converts so, a gradient tree of `jax.grad` among them."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)

    def t(a, name=""):
        a = np.asarray(a, np.float32)   # bf16 widens exactly
        return torch.tensor(_FLATTEN.get(name, lambda x: x)(a),
                            device=dev).to(dtype)

    def host(tree):     # every stacked leaf read once
        return {k: host(v) if isinstance(v, Mapping)
                else np.asarray(v, np.float32) for k, v in tree.items()}

    def pick(leaves, i):     # block i's host leaves
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in leaves.items()}

    def block(leaves):
        return {k: block(v) if isinstance(v, dict) else t(v, k)
                for k, v in leaves.items()}

    def layer(leaves, i):
        return block(pick(leaves, i))

    def per_layer(blocks, n):
        if blocks is None:
            return []
        leaves = host(blocks)
        return [layer(leaves, i) for i in range(n)]

    def groups(blocks, n, per):      # (G, per, ...) leaves
        leaves = host(blocks)
        return [[layer(pick(leaves, g), i) for i in range(per)]
                for g in range(n)]

    norm = lambda p: {k: t(v) for k, v in p.items()}
    out: Params = {"embed": t(tree["embed"]),
                   "final_norm": norm(tree["final_norm"])}
    if "lm_head" in tree:
        out["lm_head"] = t(tree["lm_head"])
    if cfg.arch_type == "moe":
        k = cfg.first_k_dense
        out["blocks"] = per_layer(tree["dense_blocks"], k) + per_layer(
            tree["moe_blocks"], cfg.n_layers - k)
    elif cfg.arch_type == "hybrid":
        n_groups, per, tail = hybrid_shape(cfg)
        out["groups"] = groups(tree["groups"], n_groups, per)
        out["shared_attn"] = block(host(tree["shared_attn"]))
        out["tail"] = per_layer(tree["tail"], tail)
    else:
        out["blocks"] = per_layer(tree["blocks"], cfg.n_layers)
    if cfg.arch_type == "encdec":
        out["enc_blocks"] = per_layer(tree["enc_blocks"], cfg.n_enc_layers)
        out["enc_norm"] = norm(tree["enc_norm"])
    if "mtp" in tree:
        mtp = tree["mtp"]
        out["mtp"] = {"proj": t(mtp["proj"]),
                      "block": block(host(mtp["block"])),
                      "norm_h": norm(mtp["norm_h"]),
                      "norm_e": norm(mtp["norm_e"])}
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
