"""Single-token decode attention against a KV cache: the CUDA kernel
`csrc/decode_attention.cu` (port of the TPU kernel
`decode_attention_pallas`) and its wrapper.

The kernel reads the cache in its stored type (fp32 or bf16) and rounds
each value to the query's type in registers, so the model's fp32 cache
is never copied. It takes any T; `ops.decode_attention` keeps the JAX
contract that T is a multiple of 256, and the model calls this wrapper
directly over its cache of `max_len` rows.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (32, 64, 128)
MAX_REP = 8     # query heads per KV head that one block computes


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, dh); k/v: (B, T, Hk, dh); kv_len: (B,) valid cache rows
    per sequence. `scale` defaults to dh ** -0.5. Returns (B, H, dh) in
    q's type; a row with kv_len = 0 gives zeros.

    CUDA tensors launch the kernel; CPU tensors take the plain version
    (`ref.decode_attention_ref`) over the cache rounded to q's type, as
    the kernel reads it."""
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k.to(q.dtype), v.to(q.dtype),
                                        kv_len, scale=scale)
    dev = q.device
    if not (q.is_cuda and k.device == dev and v.device == dev
            and kv_len.device == dev):
        raise ValueError("decode_attention_cuda: q, k, v and kv_len must "
                         "all be on one CUDA device")
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention_cuda: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} are not "
                         "(B,H,dh), (B,T,Hk,dh), (B,T,Hk,dh)")
    b, h, dh = q.shape
    t, hk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or kv_len.shape != (b,):
        raise ValueError(f"decode_attention_cuda: q {tuple(q.shape)}, "
                         f"k/v {tuple(k.shape)}, kv_len "
                         f"{tuple(kv_len.shape)} do not match")
    if dh not in HEAD_DIMS:
        raise ValueError(f"decode_attention_cuda: head width {dh}; the "
                         f"kernel takes {HEAD_DIMS}")
    if h % hk != 0 or h // hk > MAX_REP:
        raise ValueError(f"decode_attention_cuda: {h} query heads over {hk} "
                         f"KV heads; the kernel takes up to {MAX_REP} per "
                         "KV head")
    if k.dtype != v.dtype:
        raise ValueError(f"decode_attention_cuda: k of {k.dtype}, v of "
                         f"{v.dtype}")
    if q.dtype == torch.float32 and k.dtype != torch.float32:
        raise ValueError("decode_attention_cuda: a float32 query takes a "
                         f"float32 cache, not {k.dtype}")
    q_code = _build.dtype_code(q.dtype)
    kv_code = _build.dtype_code(k.dtype)
    q = q.contiguous()
    k, v = k.contiguous(), v.contiguous()
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention_cuda: the cache must start on a "
                         "16-byte boundary (the kernel reads 16 bytes at a "
                         "time)")
    lens = kv_len.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0 or t == 0:
        return out.zero_()
    lib = _build.library("decode_attention")
    n_split = -(-t // lib.decode_attention_chunk())
    part_acc = torch.empty((b, h, n_split, dh), dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty((b, h, n_split, 2), dtype=torch.float32,
                          device=dev)
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), b, t, h, hk,
        dh, q_code, kv_code, float(dh ** -0.5 if scale is None else scale),
        _build.stream_handle(dev))
    _build.check(err, "decode_attention_cuda")
    _build.count_launch("decode_attention")
    return out
