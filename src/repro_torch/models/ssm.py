"""Mamba2 block in the SSD (state-space duality) chunked form.

A port of the JAX package's `models/ssm.py`, op for op: the split input
projections (z, x, B, C, dt), the depthwise causal convolution with its
rolling window, the chunked SSD scan for prefill and the exact one-step
recurrence for decode, the gated RMS norm and the output projection.
The SSD decomposition is

  * intra-chunk: a (Q x Q) masked attention-like product per chunk,
  * chunk states: decay-weighted B^T x contractions per chunk,
  * inter-chunk: a loop over the chunk boundaries (the JAX package's
    `lax.scan`; S / Q steps),
  * output: C projected against the carried states,

all in fp32 einsums. The JAX package computes it in jnp, with no Pallas
kernel, so there is no kernel to port here: on the card these are
PyTorch's own products.

The decode state lives in a cache dict of the JAX package's shapes
(conv_x / conv_B / conv_C: (B, k-1, C) rolling windows; ssm: (B, H, P,
N) fp32), which `apply_mamba2` updates IN PLACE (the JAX function
returns a new cache).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import normal


def init_mamba2(cfg: ModelConfig, gen: torch.Generator, dtype):
    """Random parameters with the JAX package's shapes and scales, in
    `dtype` on the generator's device."""
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    gn = g * n
    k = cfg.ssm_conv
    s = d ** -0.5
    dev = gen.device
    full = lambda shape, v: torch.full(shape, v, dtype=dtype, device=dev)
    return {
        "in_z": normal(gen, (d, di), s, dtype),
        "in_x": normal(gen, (d, di), s, dtype),
        "in_B": normal(gen, (d, gn), s, dtype),
        "in_C": normal(gen, (d, gn), s, dtype),
        "in_dt": normal(gen, (d, h), s, dtype),
        "conv_x_w": normal(gen, (k, di), 0.1, dtype),
        "conv_x_b": full((di,), 0.0),
        "conv_B_w": normal(gen, (k, gn), 0.1, dtype),
        "conv_B_b": full((gn,), 0.0),
        "conv_C_w": normal(gen, (k, gn), 0.1, dtype),
        "conv_C_b": full((gn,), 0.0),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h,
                                          device=dev)).to(dtype),
        "D": full((h,), 1.0),
        "dt_bias": full((h,), -2.0),
        "norm_scale": full((di,), 1.0),
        "out_proj": normal(gen, (di, d), di ** -0.5, dtype),
    }


def _gated_rmsnorm(x, z, scale, eps: float = 1e-6):
    x32 = x.float() * F.silu(z.float())
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _causal_conv(x, w, b, prev=None):
    """Depthwise causal conv, window k. x: (B,S,C); w: (k,C); prev:
    (B,k-1,C) rolling window from the cache (zeros when absent). Returns
    (y, window tail (B,k-1,C))."""
    k = w.shape[0]
    s = x.shape[1]
    if prev is None:
        prev = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    window = torch.cat([prev.to(x.dtype), x], dim=1)
    y = sum(window[:, i:i + s, :] * w[i] for i in range(k))
    return F.silu(y + b), window[:, -(k - 1):, :]


def _ssd_chunked(xh, a_log, bh, ch, chunk: int, h0=None):
    """SSD over the full sequence.

    xh: (B,S,H,P) inputs (already dt-scaled); a_log: (B,S,H) per-step log
    decay (negative); bh/ch: (B,S,H,N). Returns (y: (B,S,H,P) fp32,
    h_final: (B,H,P,N) fp32). S must be a multiple of `chunk`, as in the
    JAX package: the caller pads, never this function."""
    b, s, h, p = xh.shape
    n = bh.shape[-1]
    q = chunk
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    nc = s // q
    r = lambda t: t.reshape(b, nc, q, *t.shape[2:])
    xh, bh, ch = r(xh).float(), r(bh).float(), r(ch).float()
    csum = torch.cumsum(r(a_log).float(), dim=2)            # (B,NC,Q,H)
    # intra-chunk (diagonal block): L[i,j] = exp(csum_i - csum_j), i >= j
    li = csum[:, :, :, None, :] - csum[:, :, None, :, :]    # (B,NC,Q,Q,H)
    upper = ~torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=xh.device))
    l_mat = li.masked_fill_(upper[None, None, :, :, None], -math.inf).exp_()
    scores = torch.einsum("bcqhn,bckhn->bcqkh", ch, bh)
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", scores.mul_(l_mat), xh)
    del l_mat, scores

    # per-chunk input state: sum_j exp(csum_Q - csum_j) B_j x_j^T
    decay_in = torch.exp(csum[:, :, -1:, :] - csum)          # (B,NC,Q,H)
    states = torch.einsum("bcqhn,bcqhp->bchpn", bh * decay_in[..., None],
                          xh)

    # inter-chunk recurrence over the chunk boundaries
    chunk_decay = torch.exp(csum[:, :, -1, :])               # (B,NC,H)
    carry = xh.new_zeros((b, h, p, n)) if h0 is None else h0.float()
    h_prev = []                                   # state entering chunk c
    for c in range(nc):
        h_prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                      # (B,NC,H,P,N)

    # contribution of the carried state to each position
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", ch, h_prev) \
        * torch.exp(csum)[..., None]
    return (y_diag + y_off).reshape(b, s, h, p), carry


def apply_mamba2(cfg: ModelConfig, params, x, *, cache=None):
    """x: (B,S,d). params in x's type (`transformer.cast_params`). cache:
    None, or dict(conv_x, conv_B, conv_C rolling windows, ssm (B,H,P,N))
    of one layer, which this call overwrites IN PLACE with the state
    after its S tokens. Returns (y (B,S,d), cache)."""
    p = params
    b, s, _ = x.shape
    h, pd, n = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
    g = cfg.ssm_ngroups

    z = x @ p["in_z"]
    xs = x @ p["in_x"]
    bb = x @ p["in_B"]
    cc = x @ p["in_C"]
    dt = x @ p["in_dt"]

    pc = cache or {}
    xs_c, w_x = _causal_conv(xs, p["conv_x_w"], p["conv_x_b"],
                             pc.get("conv_x"))
    bb_c, w_b = _causal_conv(bb, p["conv_B_w"], p["conv_B_b"],
                             pc.get("conv_B"))
    cc_c, w_c = _causal_conv(cc, p["conv_C_w"], p["conv_C_b"],
                             pc.get("conv_C"))

    xs_h = xs_c.reshape(b, s, h, pd)
    rep = h // g
    bh = bb_c.reshape(b, s, g, n).repeat_interleave(rep, dim=2)  # (B,S,H,N)
    chh = cc_c.reshape(b, s, g, n).repeat_interleave(rep, dim=2)

    a = -torch.exp(p["A_log"].float())                        # (H,) < 0
    dt_sp = F.softplus(dt.float() + p["dt_bias"].float())
    a_log = dt_sp * a                                         # (B,S,H)
    x_dt = xs_h.float() * dt_sp[..., None]                    # dt-scaled

    if cache is not None and s == 1:
        h0 = cache["ssm"].float()                             # (B,H,P,N)
        dec = torch.exp(a_log[:, 0])                          # (B,H)
        upd = torch.einsum("bhn,bhp->bhpn", bh[:, 0].float(), x_dt[:, 0])
        h_last = h0 * dec[:, :, None, None] + upd
        y = torch.einsum("bhn,bhpn->bhp", chh[:, 0].float(),
                         h_last)[:, None]                     # (B,1,H,P)
    else:
        y, h_last = _ssd_chunked(
            x_dt, a_log, bh, chh, min(cfg.ssm_chunk, s),
            h0=None if cache is None else cache["ssm"])
    if cache is not None:
        cache["conv_x"].copy_(w_x)
        cache["conv_B"].copy_(w_b)
        cache["conv_C"].copy_(w_c)
        cache["ssm"].copy_(h_last)

    y = y + p["D"].float()[None, None, :, None] * xs_h.float()
    y = y.reshape(b, s, cfg.d_inner).to(x.dtype)
    y = _gated_rmsnorm(y, z, p["norm_scale"])
    return y @ p["out_proj"], cache
