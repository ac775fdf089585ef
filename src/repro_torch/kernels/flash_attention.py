"""Blocked causal prefill attention: the CUDA kernel
`csrc/flash_attention.cu` (port of the TPU kernel `flash_attention_pallas`)
and its wrapper.

The kernel takes any S (the ragged tail is masked) and head widths
dh in {32, 64, 112, 128, 256} (256: gemma3-12b; key tiles of 64 rows on
the tensor cores; 112: zamba2-7b, staged 128 wide with TMA's zero fill),
and one value width apart from the query/key width: (192, 128), the
expanded form of deepseek-v3's MLA prefill (the TPU kernel takes one
width; the JAX model computes MLA in jnp `attend`). `ops.flash_attention`
keeps the JAX contract that S
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

from typing import Dict, Optional

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (32, 64, 112, 128, 256)
#: (query/key width, value width) pairs: every (dh, dh), and MLA's
WIDTHS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)

#: per device index: the bf16 route's two work-item counters (int32, zero
#: between calls: its blocks draw items from the first, and the last
#: block to finish resets both, so calls on one device follow one
#: stream's order; a captured graph keeps reading the same buffer)
_SCHED: Dict[int, torch.Tensor] = {}


def _sched(dev: torch.device) -> torch.Tensor:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SCHED:
        _SCHED[idx] = torch.zeros(2, dtype=torch.int32, device=dev)
    return _SCHED[idx]


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, S, H, dk); k: (B, S_kv, Hk, dk); v: (B, S_kv, Hk, dv), H a
    multiple of Hk, S_kv = S under the causal mask, (dk, dv) one of
    WIDTHS; fp32 or bf16, all one type. `window` > 0 keeps keys with kpos
    > qpos - window; `scale` defaults to dk ** -0.5. Returns (B, S, H, dv)
    in q's type.

    CUDA tensors launch the kernel; CPU tensors take the plain version
    (`ref.flash_attention_ref`). The kernel has no backward: CUDA inputs
    that require grad, under grad mode, raise (the output would carry no
    gradient to q, k or v)."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_cuda: the kernel has no backward, and an "
            "input requires grad; use backend='reference', or call it "
            "under torch.no_grad()")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention_cuda: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}; all must be on one "
                         "CUDA device")
    if q.ndim != 4 or k.ndim != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention_cuda: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} are not "
                         "(B,S,H,dk), (B,S_kv,Hk,dk), (B,S_kv,Hk,dv)")
    b, s, h, dk = q.shape
    s_kv, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != b or k.shape[3] != dk or h % hk != 0:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)} and "
                         f"k {tuple(k.shape)} do not match")
    if causal and s_kv != s:
        raise ValueError(f"flash_attention_cuda: {s} queries against "
                         f"{s_kv} keys under the causal mask; a separate "
                         "key length is taken without it only")
    if (dk, dv) not in WIDTHS:
        raise ValueError(f"flash_attention_cuda: head widths {dk} "
                         f"(query/key) and {dv} (value); the kernel takes "
                         f"{WIDTHS}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention_cuda: q, k, v of types "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    code = _build.dtype_code(q.dtype)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = q.new_empty((b, s, h, dv))
    if out.numel() == 0:
        return out
    lib = _build.library("flash_attention")
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _sched(q.device).data_ptr(), b, s, s_kv, h, hk, dk, dv, code,
        float(dk ** -0.5 if scale is None else scale), int(causal),
        int(window), _build.stream_handle(q.device))
    _build.check(err, "flash_attention_cuda")
    _build.count_launch("flash_attention")
    return out
