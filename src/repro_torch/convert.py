"""Carry router state across from host arrays, so the port can route over
exactly the state another implementation built (the parity tests hand
over the JAX package's RouterState field by field, each taken with
`np.asarray`)."""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.state import RouterState

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
