"""PyTorch/CUDA port of the Eagle router for one NVIDIA H100.

Mirrors the layout of the JAX package `repro` module for module, so each
counterpart is easy to find. It imports `torch`, never `jax`, and
nothing of `repro`: what it needs from there (the synthetic RouterBench
corpus, the fleet constants) is copied in.

Every entry point takes a `device` argument that defaults to the card.
Without a card the default raises instead of running on the CPU; the CPU
tests pass `device="cpu"` explicitly.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means the card. A CUDA device without a card raises: the
    port never silently runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU")
    return dev


__all__ = ["resolve_device", "DeviceLike"]
