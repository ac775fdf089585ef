"""Mixture-of-Experts FFN on one device: phi3.5-moe's routed experts and
deepseek-v3's shared experts.

A port of the JAX package's `models/moe.py`. `apply_moe` is ONE function
equal to both of its single-device paths: `_small_moe` (a one-hot
dispatch, taken up to 8192 tokens) and `_local_moe(..., None, 1, 0)` (a
gather, taken above that without a model mesh). They compute the same
thing:

  1. router logits and softmax in fp32, the router read in fp32;
  2. each token's top-k experts by `ref.stable_topk` (ties to the lowest
     expert, the `jax.lax.top_k` contract; `torch.topk` does not keep
     it), weights top_w / max(sum top_w, 1e-9);
  3. a capacity of C = int(max(k, capacity_factor * k * T / E)) slots an
     expert for the T tokens of the call, padded rows included; each
     (token, choice) pair takes the next slot of its expert in flat
     token-major order, and pairs past C are dropped;
  4. the (E, C, d) slot buffer gathered from the tokens: each kept pair
     writes its token's index into its slot (a dropped one into a trash
     slot, as `_local_moe` does; `dispatch`), empty slots read a zero
     row. The
     one-hot (T*k, E, C) dispatch of `_small_moe` is not built: its
     products add exactly one non-zero term, so they give these values;
  5. the batched expert FFN silu(x W_gate) * (x W_up) W_down in the
     compute type (`torch.bmm` over the experts);
  6. each pair's output times its weight cast to the compute type, summed
     over the k choices in choice order (the JAX scatter-add's order);
  7. the shared experts' gated MLP added after the combine.

and the Switch-style auxiliary loss. Every shape is static (no
`nonzero`, boolean indexing or host read), so a decode step that runs it
is captured whole into a CUDA graph.

The JAX package computes the MoE in jnp einsums with no Pallas kernel,
so there is no kernel to port here: on the card the expert products are
PyTorch's batched matmuls, as mamba2's SSD is (models/ssm.py).

On a fleet mesh (`launch/mesh.py`; `apply_moe(..., mesh=)`) the JAX
function takes its expert-parallel `shard_map` above 8192 tokens when
the mesh's "model" axis has more than one rank: each rank takes its
batch shard's tokens (contiguous token ranges, `P(batch_axes, None)`)
and its E / |model| experts, runs `_local_moe` with the capacity of its
LOCAL token count (so drops differ from the unsharded call: that is
JAX's semantics, kept), psums the combine over "model" and pmeans the
aux loss over the batch axes. The port takes the branch exactly there,
and computes it in SPMD form, one rank a process (`_apply_moe_mesh`): a
pair's slot depends only on the earlier pairs of its own expert, so the
dispatch over all E experts serves a rank's slice unchanged. Where the
JAX function runs its global paths on a mesh (8192 tokens or fewer, or
one model rank), the port gathers the batch shards' tokens first, so
the capacity is the global one, and still splits the experts over
"model" (the same values: the slots do not depend on the split).

The gradients JAX's transposes place, the port places itself:
  * the tokens entering the expert buffers are replicated over "model"
    and their gradient is summed over it (`sharding.sum_grad`); so is the
    gradient of the gates through the top-k weights, while the aux loss,
    computed identically on every model rank from the full gates, sends
    its part once;
  * the combine is all-reduced over "model" forward and passes its
    cotangent straight back (`sharding.sum_over`);
  * a gather of the batch shards' tokens sums its gradient over the
    batch axes and keeps this rank's rows (`sharding.gather_rows`);
  * the expert weights' gradients are this rank's experts' only: the
    train step sums them over "model" (`training/loop.py`).
On a plain tensor with a mesh, x is this rank's batch shard and the aux
loss is its tokens' (the train step's mean over the data ranks is JAX's
pmean); on a DTensor (the dry-run's meshes) x is the global value, the
branch runs on the local shards (`to_local`), and the aux loss is
pmean'd as JAX's. Below the branch a DTensor goes through the
one-device code, with the `constrain` points of the JAX `_small_moe`.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding as SH
from repro_torch.kernels import ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_mlp, normal

Params = Dict[str, Any]

#: above this many tokens (the call's global count) a mesh with a "model"
#: axis takes the expert-parallel branch (the JAX package's `_SMALL_T`)
SMALL_T = 8192


def init_moe(cfg: ModelConfig, gen: torch.Generator, dtype) -> Params:
    """Random parameters with the JAX package's shapes and scales, in
    `dtype` on the generator's device: router (d, E), w_gate / w_up (E,
    d, ff), w_down (E, ff, d), and with shared experts a "shared" gated
    MLP of width ff * n_shared_experts."""
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.expert_ff
    s_in, s_out = d ** -0.5, ff ** -0.5
    p = {"router": normal(gen, (d, e), s_in, dtype),
         "w_gate": normal(gen, (e, d, ff), s_in, dtype),
         "w_up": normal(gen, (e, d, ff), s_in, dtype),
         "w_down": normal(gen, (e, ff, d), s_out, dtype)}
    if cfg.n_shared_experts:
        sff = ff * cfg.n_shared_experts
        p["shared"] = {"w_gate": normal(gen, (d, sff), s_in, dtype),
                       "w_up": normal(gen, (d, sff), s_in, dtype),
                       "w_down": normal(gen, (sff, d), sff ** -0.5, dtype)}
    return p


def capacity(cfg: ModelConfig, t: int) -> int:
    """Slots an expert for a call of t tokens (the JAX formula, in
    Python from the call's static token count)."""
    k = cfg.experts_per_tok
    return int(max(k, cfg.capacity_factor * k * t / cfg.n_experts))


def route(cfg: ModelConfig, router, xt, sum_grad=None):
    """xt: (T, d) -> (top_w (T, k) fp32, top_e (T, k) int64, gates (T, E)
    fp32): the softmax gates in fp32 and each token's top-k experts,
    ties to the lowest, their weights renormalised. `sum_grad` wraps the
    gates on their way to the top-k weights (the expert-parallel
    branch's gradient sum over "model"; the aux loss reads `gates`)."""
    gates = torch.softmax(xt.float() @ router.float(), dim=-1)
    top_w, top_e = ref.stable_topk(
        gates if sum_grad is None else sum_grad(gates), cfg.experts_per_tok)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return top_w, top_e, gates


class Dispatch(NamedTuple):
    """Where a call's (token, choice) pairs go, A = T * k of them in flat
    token-major order: `pair` is each pair's row of the (E * C) slot rows
    (E * C, the trash, where it is dropped), `src` each slot row's token
    (T, a zero row, where the slot is empty)."""
    top_w: Any       # (T, k) fp32
    top_e: Any       # (T, k) int64
    gates: Any       # (T, E) fp32
    keep: Any        # (A,) bool
    pair: Any        # (A,) int64
    src: Any         # (E * C,) int64
    cap: int


def dispatch(cfg: ModelConfig, router, xt, sum_grad=None) -> Dispatch:
    """Route the (T, d) tokens and give each pair the next slot of its
    expert, counted in flat order; the pair is kept if that slot is
    below the capacity."""
    t, e, k = xt.shape[0], cfg.n_experts, cfg.experts_per_tok
    top_w, top_e, gates = route(cfg, router, xt, sum_grad)
    cap = capacity(cfg, t)
    flat_e = top_e.reshape(-1)
    # the (E, A) one-hot, scanned along its inner dim: a scan of the (A,
    # E) one-hot along its outer dim was 25% of a phi prefill on the card
    onehot = (torch.arange(e, device=xt.device)[:, None]
              == flat_e).to(torch.int32)
    slot = (torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1).gather(
        0, flat_e[None])[0].long()
    keep = slot < cap
    pair = torch.where(keep, flat_e * cap + slot, e * cap)
    src = torch.full(((e + 1) * cap,), t, dtype=torch.int64,
                     device=xt.device)
    src.index_copy_(0, pair, torch.arange(t * k, device=xt.device) // k)
    return Dispatch(top_w, top_e, gates, keep, pair, src[:e * cap], cap)


def aux_loss(top_e, gates):
    """E * sum_e (share of the (token, choice) pairs per token on e) *
    (mean gate of e), in fp32 (Switch-style, over the full gates)."""
    e = gates.shape[-1]
    chosen = (top_e[..., None] == torch.arange(
        e, device=top_e.device)).float().sum(1)
    return e * (chosen.mean(0) * gates.mean(0)).sum()


def _experts(cfg: ModelConfig, router, xt, w_gate, w_up, w_down, *,
             e_lo: int = 0, sum_grad=None, constrain=SH.no_constrain):
    """(y (T, d), aux) of the experts [e_lo, e_lo + E_local) whose weights
    are given (E_local = w_gate's dim 0; all E: the one-device call) over
    the (T, d) tokens, the capacity of T tokens. y sums only these
    experts' pairs; `sum_grad` as in `route`, and on the tokens entering
    the slot buffer."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.experts_per_tok
    e_local = w_gate.shape[0]
    whole = None
    if SH.is_dtensor(xt):
        # GSPMD's small-T plan: the tokens and the routing whole on every
        # rank, the expert buffers split by `constrain`
        from torch.distributed.tensor import DTensor, Replicate
        mesh = xt.device_mesh
        whole = [Replicate()] * mesh.ndim
        xt, router = (SH.local_shard(a, mesh, whole) for a in (xt, router))
    dp = dispatch(cfg, router, xt, sum_grad)
    xb = xt if sum_grad is None else sum_grad(xt)
    lo = e_lo * dp.cap
    # the slot buffer by gather: empty slots read the zero row t
    buf = torch.cat([xb, xb.new_zeros((1, d))])[
        dp.src[lo:lo + e_local * dp.cap]].view(e_local, dp.cap, d)
    if whole is not None:
        buf = DTensor.from_local(buf, mesh, whole)
    axes = ("experts", None, None)
    buf = constrain(buf, axes)
    h = constrain(F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up),
                  axes)
    y_buf = constrain(torch.bmm(h, w_down), axes).view(e_local * dp.cap, d)
    if whole is not None:           # the combine on every rank, whole
        y_buf = y_buf.redistribute(mesh, whole).to_local()
    # each pair's output, weighted in the compute type, zero if dropped or
    # another rank's
    if e_local == e:
        mine, idx = dp.keep, torch.where(dp.keep, dp.pair, 0)
    else:
        flat_e = dp.top_e.reshape(-1)
        mine = dp.keep & (flat_e >= e_lo) & (flat_e < e_lo + e_local)
        idx = torch.where(mine, dp.pair - lo, 0)
    y_pair = y_buf[idx] * dp.top_w.reshape(-1, 1).to(xt.dtype)
    y_pair = torch.where(mine[:, None], y_pair, 0).view(t, k, d)
    y = y_pair[:, 0]
    for j in range(1, k):
        y = y + y_pair[:, j]
    if whole is not None:
        y = DTensor.from_local(y, mesh, whole)
    return y, aux_loss(dp.top_e, dp.gates)


def apply_moe(cfg: ModelConfig, params: Params, x, mesh=None,
              constrain=None) -> Tuple[Any, Any]:
    """x: (B, S, d) in the compute type -> (y (B, S, d), aux fp32 scalar).
    params: init_moe's dict, its expert weights in x's type (the router
    in any type: it is read in fp32). `mesh`: a fleet mesh (module
    docstring; None: one device); `constrain`: the JAX constraint
    points' callback (`sharding.make_constrainer`)."""
    constrain = constrain or SH.no_constrain
    if mesh is None:
        y = None
    elif SH.is_dtensor(x):
        y, aux = _apply_moe_dtensor(cfg, params, x, mesh)
    else:
        y, aux = _apply_moe_mesh(cfg, params, x, mesh)
    if y is None:
        b, s, d = x.shape
        y, aux = _experts(cfg, params["router"], x.reshape(b * s, d),
                          params["w_gate"], params["w_up"],
                          params["w_down"], constrain=constrain)
        y = y.reshape(b, s, d)
    if cfg.n_shared_experts:
        y = y + apply_mlp(cfg, params["shared"], x)
    return y, aux


# ---------------------------------------------------------------------------
# The expert-parallel branch and the global paths on a mesh
# ---------------------------------------------------------------------------

def _local_experts(cfg: ModelConfig, msz: int) -> int:
    if cfg.n_experts % msz:
        raise ValueError(f"{cfg.name}: {cfg.n_experts} experts do not "
                         f"split over a model axis of {msz}")
    return cfg.n_experts // msz


def _expert_slices(params: Params, lo: int, n: int) -> Sequence:
    return [params[w][lo:lo + n] for w in ("w_gate", "w_up", "w_down")]


def _apply_moe_mesh(cfg: ModelConfig, params: Params, x, mesh):
    """The SPMD form on plain tensors: x is this rank's batch shard, the
    parameters whole. Returns (y, this rank's aux)."""
    msz = SH.axis_sizes(mesh).get("model", 1)
    index, nb, batch_groups = SH.batch_shard(mesh)
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    # JAX's expert-parallel branch: the local tokens; else its global
    # paths: every batch shard's tokens
    gather = not (t * nb > SMALL_T and msz > 1) and nb > 1
    if gather:
        xt = SH.gather_rows(xt, batch_groups, index)
    if msz > 1:
        groups = [mesh.get_group("model")]
        n = _local_experts(cfg, msz)
        lo = mesh.get_local_rank("model") * n
        y, aux = _experts(cfg, params["router"], xt,
                          *_expert_slices(params, lo, n), e_lo=lo,
                          sum_grad=lambda z: SH.sum_grad(z, groups))
        y = SH.sum_over(y, groups)
    else:
        y, aux = _experts(cfg, params["router"], xt, params["w_gate"],
                          params["w_up"], params["w_down"])
    if gather:
        y = y[index * t:(index + 1) * t]
    return y.reshape(b, s, d), aux


def _apply_moe_dtensor(cfg: ModelConfig, params: Params, x, mesh):
    """The expert-parallel branch on DTensors (GSPMD's global values), on
    their local shards; None for the global paths, which the one-device
    code runs on the DTensors."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    sizes = SH.axis_sizes(mesh)
    msz = sizes.get("model", 1)
    batch = tuple(a for a in sizes if a != "model")
    _, nb, batch_groups = SH.batch_shard(mesh)
    b, s, d = x.shape
    if b * s <= SMALL_T or msz <= 1:
        return None, None
    tok = SH.placements(mesh, (batch, None))
    xt = x.reshape(b * s, d)
    whole = [Replicate()] * len(sizes)
    # gradients: partial over the batch axes (each rank's tokens), whole
    # over "model" (the branch sums them there), the experts sliced
    part = [Replicate() if a == "model" else Partial() for a in sizes]
    experts = SH.placements(mesh, ("model", None, None))
    router = SH.local_shard(params["router"], mesh, whole, part)
    ws = [SH.local_shard(params[w], mesh, experts,
                         [Shard(0) if a == "model" else Partial()
                          for a in sizes])
          for w in ("w_gate", "w_up", "w_down")]
    groups = [mesh.get_group("model")]
    lo = mesh.get_local_rank("model") * _local_experts(cfg, msz)
    y, aux = _experts(cfg, router, SH.local_shard(xt, mesh, tok), *ws,
                      e_lo=lo, sum_grad=lambda z: SH.sum_grad(z, groups))
    y = SH.sum_over(y, groups)
    aux = SH.mean_over(aux, batch_groups, nb)
    return (DTensor.from_local(y, mesh, tok).reshape(b, s, d),
            DTensor.from_local(aux, mesh, whole))
