"""Single-token decode attention against a KV cache: the CUDA kernel
`csrc/decode_attention.cu` (port of the TPU kernel
`decode_attention_pallas`) and its wrapper.

The kernel reads the cache in its stored type (fp32 or bf16) and rounds
each value to the query's type in registers, so the model's fp32 cache
is never copied. It takes any T; `ops.decode_attention` keeps the JAX
contract that T is a multiple of 256, and the model calls this wrapper
directly over its cache of `max_len` rows.

Head widths 32, 64, 112, 128 and 256; 112 (zamba2-7b) is staged 128
wide in shared memory, the cache read at its own width.

One launch a call: a block per (b, KV head, split) streams its split's
rows through a ring of shared-memory stages, and the last split of each
(b, KV head) to finish merges the splits' partials. `split_plan` chooses
the splits from the card; the merge's arrival counters live in one
zeroed buffer per device that the kernel leaves zeroed. A `window` keeps
the last `window` rows before kv_len (gemma3's local layers over a full
cache); the kernel computes each row's first key on the device, so the
splits and a captured graph do not depend on kv_len.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

#: the H100 SXM's SMs: the plan of the plain version on the CPU
H100_SMS = 132
_SMS: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    if device.type != "cuda":
        return H100_SMS
    idx = torch.cuda.current_device() if device.index is None \
        else device.index
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]

HEAD_DIMS = (32, 64, 112, 128, 256)
MAX_REP = 8     # query heads per KV head that one block computes
#: the kernel's stage: K and V rows of STAGE_BYTES in all
#: (`csrc/decode_attention.cu`: STAGE_BYTES, Tile::ROWS)
STAGE_BYTES = 32768
#: resident blocks an SM (two stages of 32 KB, 128 threads; the card's
#: own count: `decode_attention_occupancy` of the library)
BLOCKS_PER_SM = 3
#: blocks planned for WAVES full waves of the SMs, each split at least
#: MIN_STAGES stages long (chosen on the H100 among 2, 4, 8 waves)
WAVES, MIN_STAGES = 4, 4

#: per device index: the arrival counters (uint32, zero between calls;
#: the kernel counts a (b, KV head)'s splits there and its last split
#: resets them, so calls on one device follow one stream's order). A
#: larger grid takes a new buffer; the old ones stay alive for the graphs
#: captured over them.
_ARRIVALS: Dict[int, List[torch.Tensor]] = {}


def staged_width(dh: int) -> int:
    """The width a cache row is staged at: the next power of two (112 ->
    128; `csrc/decode_attention.cu:staged`)."""
    return 1 << max(dh - 1, 1).bit_length()


def stage_rows(dh: int, itemsize: int) -> int:
    """Cache rows a stage holds, of K and of V."""
    return STAGE_BYTES // (2 * staged_width(dh) * itemsize)


def split_plan(b: int, t: int, hk: int, dh: int, itemsize: int,
               sms: int = H100_SMS) -> Tuple[int, int]:
    """(n_split, split_rows): split s of each (b, KV head) takes cache
    rows [s * split_rows, (s + 1) * split_rows) of T. About WAVES waves
    of BLOCKS_PER_SM blocks on each of `sms` SMs over the B * Hk pairs,
    each split a whole number of stages and at least MIN_STAGES of them
    (one split where T is shorter). It depends on the shapes and the
    card alone, never on kv_len, so a captured graph stays valid."""
    rows = stage_rows(dh, itemsize)
    pairs = max(b * hk, 1)
    want = max(1, (WAVES * BLOCKS_PER_SM * sms + pairs // 2) // pairs)
    most = max(1, -(-t // (MIN_STAGES * rows)))
    split_rows = -(-max(t, 1) // min(want, most))
    split_rows = -(-split_rows // rows) * rows
    return -(-max(t, 1) // split_rows), split_rows


def _arrivals(dev: torch.device, n: int) -> torch.Tensor:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    bufs = _ARRIVALS.setdefault(idx, [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros(max(n, 4096), dtype=torch.int32,
                                device=dev))
    return bufs[-1]


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor, *,
                          scale: Optional[float] = None,
                          window: int = 0) -> torch.Tensor:
    """q: (B, H, dh); k/v: (B, T, Hk, dh); kv_len: (B,) valid cache rows
    per sequence. `scale` defaults to dh ** -0.5; `window` > 0 keeps the
    rows kv_len - window <= r < kv_len. Returns (B, H, dh) in q's type;
    a row with kv_len = 0 gives zeros.

    CUDA tensors launch the kernel; CPU tensors take the plain version
    (`ref.decode_attention_ref`) over the cache rounded to q's type, as
    the kernel reads it. The kernel has no backward: CUDA inputs that
    require grad, under grad mode, raise."""
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k.to(q.dtype), v.to(q.dtype),
                                        kv_len, scale=scale, window=window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "decode_attention_cuda: the kernel has no backward, and an "
            "input requires grad; use backend='reference', or call it "
            "under torch.no_grad()")
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
    if window < 0:
        raise ValueError(f"decode_attention_cuda: window {window}; 0 "
                         "disables it")
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
    rep = h // hk
    n_split, split_rows = split_plan(b, t, hk, dh, k.element_size(),
                                     _sm_count(dev))
    part_acc = torch.empty((b, hk, n_split, rep, dh) if n_split > 1
                           else (1,), dtype=torch.float32, device=dev)
    part_ml = torch.empty((b, hk, n_split, rep, 2) if n_split > 1
                          else (1,), dtype=torch.float32, device=dev)
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        _arrivals(dev, b * hk).data_ptr(), b, t, h, hk, dh, q_code, kv_code,
        n_split, split_rows, int(window),
        float(dh ** -0.5 if scale is None else scale),
        _build.stream_handle(dev))
    _build.check(err, "decode_attention_cuda")
    _build.count_launch("decode_attention")
    return out
