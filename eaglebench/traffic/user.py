"""The simulated user who compares two answers.

Copied from src/repro_torch/launch/serve.py:quality_oracle at commit
7f915e9: a quality in [0, 1) per (prompt, model), a hash of the prompt's
embedding and the model's index, so that runs repeat. The program's copy
may change; this one is the benchmark's yardstick.
"""
from __future__ import annotations

import zlib

import numpy as np


def quality_oracle(emb, mi) -> float:
    """The simulated user's quality of model `mi`'s answer to the prompt
    of embedding `emb`."""
    return float(np.random.default_rng(
        zlib.crc32(emb[:2].tobytes() + bytes([mi]))).random())


def outcome(emb, a: int, b: int) -> float:
    """S for model a against model b: 1 a win, 0.5 a draw, 0 a loss."""
    qa, qb = quality_oracle(emb, a), quality_oracle(emb, b)
    return 0.5 if qa == qb else float(qa > qb)
