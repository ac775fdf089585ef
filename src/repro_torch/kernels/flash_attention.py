"""Blocked causal prefill attention: the CUDA kernel
`csrc/flash_attention.cu` (port of the TPU kernel `flash_attention_pallas`)
and its wrapper.

The kernel takes any S (the ragged tail is masked) and head widths
dh in {32, 64, 128}; `ops.flash_attention` keeps the JAX contract that S
is a multiple of 128 (one S for q and k/v), and the model calls this
wrapper directly, with its prompt's own length. Without the causal mask
the keys may number S_kv != S: the cross-attention of an encoder-decoder
(the TPU kernel assumes one S; the JAX model computes cross-attention in
jnp `attend`). bf16 inputs (the serving path's) run on the
tensor cores (`wgmma`, K/V by TMA) and round the softmax weights to bf16
before the second product, as the model's plain attend does; fp32 inputs
run an exact CUDA-core kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (32, 64, 128)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, S, H, dh); k/v: (B, S_kv, Hk, dh), H a multiple of Hk, S_kv
    = S under the causal mask; fp32 or bf16, all one type. `window` > 0
    keeps keys with kpos > qpos - window; `scale` defaults to dh ** -0.5. Returns (B, S, H, dh) in q's type.

    CUDA tensors launch the kernel; CPU tensors take the plain version
    (`ref.flash_attention_ref`)."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention_cuda: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}; all must be on one "
                         "CUDA device")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"flash_attention_cuda: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} are not "
                         "(B,S,H,dh), (B,S_kv,Hk,dh), (B,S_kv,Hk,dh)")
    b, s, h, dh = q.shape
    s_kv, hk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or h % hk != 0:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)} and "
                         f"k/v {tuple(k.shape)} do not match")
    if causal and s_kv != s:
        raise ValueError(f"flash_attention_cuda: {s} queries against "
                         f"{s_kv} keys under the causal mask; a separate "
                         "key length is taken without it only")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head width {dh}; the "
                         f"kernel takes {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention_cuda: q, k, v of types "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    code = _build.dtype_code(q.dtype)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.library("flash_attention")
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
        s_kv, h, hk, dh, code, float(dh ** -0.5 if scale is None else scale),
        int(causal), int(window), _build.stream_handle(q.device))
    _build.check(err, "flash_attention_cuda")
    _build.count_launch("flash_attention")
    return out
