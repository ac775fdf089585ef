"""Assigned input shapes and meta-device stand-ins for the dry-run.

A copy of the JAX package's `configs/shapes.py`. The four assigned shapes
map to the step the dry-run builds (`launch/dryrun.py`):

  train_4k     -> the train step (tokens+targets, global_batch=256, S=4096)
  prefill_32k  -> prefill        (tokens, global_batch=32, S=32768)
  decode_32k   -> decode_step    (ONE new token; KV/state cache of S=32768)
  long_500k    -> decode_step    (ONE token, 524288 context, batch=1) —
                  sub-quadratic archs only (see supports()).

Where the JAX module returns `jax.ShapeDtypeStruct`s, `input_specs`
returns tensors on the meta device: shapes and dtypes, no storage.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_cache, torch_dtype

SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k": dict(seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524_288, global_batch=1, kind="decode"),
}

# Archs allowed to run long_500k: linear-state or sliding-window families.
_LONG_OK = {"mamba2-780m", "zamba2-7b", "gemma3-12b"}


def supports(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """Whether (arch, shape) is runnable; reason string when skipped."""
    if shape == "long_500k" and cfg.name not in _LONG_OK:
        return False, ("full-attention arch without a sliding-window/"
                       "block-sparse variant; 524k decode skipped per "
                       "assignment (see DESIGN.md)")
    return True, ""


def input_specs(cfg: ModelConfig, shape: str,
                device="meta") -> Dict[str, Any]:
    """Stand-ins on `device` (the meta device: no memory) for every model
    input of (cfg, shape), with the JAX module's shapes and dtypes but
    the decode index's (module docstring).

    Returns {"kind": ..., "batch": ...} for train/prefill and
    {"kind": "decode", "cache": ..., "tokens": ..., "index": ...} for
    decode shapes; the cache is `init_cache(cfg, b, s, torch.bfloat16)`.
    """
    spec = SHAPES[shape]
    s, b, kind = spec["seq_len"], spec["global_batch"], spec["kind"]
    ok, why = supports(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape}: {why}")
    act_dt = torch_dtype(cfg.dtype)
    empty = lambda shape, dt: torch.empty(shape, dtype=dt, device=device)

    if kind in ("train", "prefill"):
        if cfg.arch_type == "vlm":
            s_text = s - cfg.n_image_tokens
            batch = {"tokens": empty((b, s_text), torch.int32),
                     "img_embeds": empty((b, cfg.n_image_tokens,
                                          cfg.d_model), act_dt)}
            tgt_shape = (b, s_text)
        elif cfg.arch_type == "encdec":
            batch = {"tokens": empty((b, s), torch.int32),
                     "enc_embeds": empty((b, cfg.n_audio_frames,
                                          cfg.d_model), act_dt)}
            tgt_shape = (b, s)
        else:
            batch = {"tokens": empty((b, s), torch.int32)}
            tgt_shape = (b, s)
        if kind == "train":
            batch["targets"] = empty(tgt_shape, torch.int32)
        return {"kind": kind, "batch": batch, "seq_len": s, "global_batch": b}

    # decode: ONE new token against a cache of length s
    return {
        "kind": "decode",
        "cache": init_cache(cfg, b, s, torch.bfloat16, device=device),
        "tokens": empty((b, 1), torch.int32),
        "index": empty((1,), torch.int64),
        "seq_len": s,
        "global_batch": b,
    }
