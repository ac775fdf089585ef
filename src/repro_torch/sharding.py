"""Sharding rules: logical parameter / activation / cache axes -> mesh axes,
and the router DB's capacity axis (DESIGN.md §5, §12).

A port of the JAX package's `sharding.py`. Its rules are name-based
(MaxText-style), written for the TRAILING dims of each leaf and
right-aligned:

  * weights: tensor-parallel over "model" (heads / d_ff / experts /
    vocab); kv projections replicate when kv_heads doesn't divide the
    model axis; with `fsdp` every matrix also shards one replicated
    weight dim over "data"; with `experts_2d` the experts shard over
    ("model", "data");
  * activations: batch over ("pod", "data"); embed replicated; the vocab
    dim over "model";
  * KV caches: batch over "data", SEQUENCE over "model";
  * SSM caches: head / channel dims over "model".

A spec is a tuple with one entry per dim of the leaf: None (the dim is
whole on every device), a mesh axis name, or a tuple of names (split
over those axes, the first major) -- the value of JAX's PartitionSpec.
A mesh is a `torch.distributed.device_mesh.DeviceMesh` with
`mesh_dim_names` (`launch/mesh.py`), or for the rules alone anything that
names its axes' sizes: a mapping {axis: size}, or an object with
`axis_names` and a `shape` mapping (`axis_sizes`).

Where the layouts part. The port's layer stacks are lists of per-layer
dicts (`models/transformer.py`): its leaves have no stack dims, and its
attention projections are 2-D where JAX's are (d, H, hd) / (H, hd, d).
`param_specs` therefore applies JAX's rule to the JAX leaf each port leaf
is a slice of (`jax_leaf`: its path, e.g. "moe_blocks/ffn/w_gate", and
its shape with the stack dims in front), so `fsdp`'s choice of dim --
the largest replicated dim divisible by "data", skipping dim 0 of every
leaf of three dims or more -- is made on JAX's shape (a norm scale (d,)
is (L, d) there, and takes "data"); then moves the stack dims' entries
to the spec's `stack` (a `LayerSpec`) and merges the (H, hd) pair of a
flattened projection into the port's one dim (H's axes first, then
hd's). A stack entry is not None only where fsdp picks the layer dim
itself: mamba2's per-head and per-channel vectors (L, H) whose other
dim is on "model". Each device then holds L / |data| of those layers;
`local_bytes` counts that share, and a DTensor of one layer
(`placements`) holds it whole on the stack axis.

`placements` turns a spec into DTensor placements; `local_shape` /
`local_bytes` give each device's shard, the spec arithmetic the dry-run's
argument bytes are held to. An entry over two axes is split by DTensor
in the mesh's dim order, so `experts_2d`'s ("model", "data") splits
data-major on a (data, model) mesh where JAX splits model-major: the
same shard sizes, another device-to-expert map (ROADMAP §4).

The DB part: a mesh there is a `launch.mesh.DbMesh`, the axis name
DB_AXIS over a tuple of devices.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.models.config import ModelConfig

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]
Tree = Any


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh (`mesh_dim_names`), of a mapping,
    or of an object with `axis_names` and a `shape` mapping (JAX's Mesh
    has both), in the mesh's dim order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return {a: mesh.shape[a] for a in mesh.axis_names}


def _names(ax: Axis) -> Tuple[str, ...]:
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def _map_with_path(fn, tree: Tree, path: tuple = ()) -> Tree:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in
                tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (i,)) for i, v in
                enumerate(tree)]
    return fn(path, tree)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def batch_axes(mesh, global_batch: int) -> Optional[Tuple[str, ...]]:
    """Largest prefix of (pod, data) that divides global_batch."""
    sizes = axis_sizes(mesh)
    chosen, size = [], 1
    for a in ("pod", "data"):
        if a in sizes and global_batch % (size * sizes[a]) == 0:
            chosen.append(a)
            size *= sizes[a]
    return tuple(chosen) or None


def _right_align(spec: Sequence, ndim: int) -> Spec:
    # a 1-tuple of mesh axes is the bare name: ("data",) and "data" place
    # alike
    spec = [s[0] if isinstance(s, tuple) and len(s) == 1 else s
            for s in spec]
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} for a leaf of {ndim} dims")
    return tuple([None] * (ndim - len(spec)) + spec)


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

def param_rules(cfg: ModelConfig, mesh, experts_2d: bool = False):
    """Ordered (regex, trailing-spec) rules over JAX's leaf paths; the
    first match wins. Every sharded dim is divisibility-guarded (whisper's
    20 heads or its 51866 vocab replicate on a 16-wide model axis while
    its d_ff = 5120 still shards)."""
    sizes = axis_sizes(mesh)
    msz = sizes["model"]

    def ax(n):  # "model" iff divisible, else replicate
        return "model" if (n and n % msz == 0) else None

    m_h = ax(cfg.n_heads)
    m_kv = ax(cfg.n_kv_heads)
    m_ff = ax(cfg.d_ff)
    m_eff = ax(cfg.expert_ff * max(cfg.n_shared_experts, 1))
    m_v = ax(cfg.vocab)
    m_e = ax(cfg.n_experts)
    if experts_2d and cfg.n_experts and \
            cfg.n_experts % (msz * sizes.get("data", 1)) == 0:
        m_e = ("model", "data")     # one expert shard per device
    m_di = ax(cfg.d_inner) if cfg.ssm_state else None
    m_sh = ax(cfg.ssm_nheads) if cfg.ssm_state else None

    rules = [
        # MoE (expert-stacked 3D) -- before the dense ffn rules
        (r"ffn/shared/w_(gate|up)$", [None, m_eff]),
        (r"ffn/shared/w_down$", [m_eff, None]),
        (r"ffn/router$", [None, None]),
        (r"moe_blocks/ffn/w_(gate|up)$", [m_e, None, None]),
        (r"moe_blocks/ffn/w_down$", [m_e, None, None]),
        # attention (GQA) + cross
        (r"(attn|cross)/wq$", [None, m_h, None]),
        (r"(attn|cross)/w[kv]$", [None, m_kv, None]),
        (r"(attn|cross)/wo$", [m_h, None, None]),
        # MLA
        (r"attn/w_uq$", [None, m_h, None]),
        (r"attn/w_(uk|uv)$", [None, m_h, None]),
        (r"attn/w_(dq|dkv|kr)$", [None, None]),
        # dense ffn
        (r"ffn/w_(gate|up)$", [None, m_ff]),
        (r"ffn/w_down$", [m_ff, None]),
        # mamba2: head-structured streams sharded, ngroups streams whole
        (r"mamba/in_(z|x)$", [None, m_di]),
        (r"mamba/in_dt$", [None, m_sh]),
        (r"mamba/in_[BC]$", [None, None]),
        (r"mamba/conv_x_w$", [None, m_di]),
        (r"mamba/conv_x_b$", [m_di]),
        (r"mamba/(A_log|D|dt_bias)$", [m_sh]),
        (r"mamba/norm_scale$", [m_di]),
        (r"mamba/out_proj$", [m_di, None]),
        # embeddings / head
        (r"^embed$", [m_v, None]),
        (r"^lm_head$", [None, m_v]),
        (r"^mtp/proj$", [None, None]),
    ]
    return [(re.compile(rx), spec) for rx, spec in rules]


def jax_leaf(cfg: ModelConfig, path: tuple, shape) -> Tuple[
        str, Tuple[int, ...], int, Optional[int]]:
    """The JAX leaf that the port's leaf at `path` (keys and list indices
    of `transformer.init_params`' tree) is a slice of: (its path string,
    its shape, the number of stack dims in front, and the dim `m` of the
    per-layer JAX shape whose pair (m, m + 1) the port flattens into one,
    or None). Stacks: blocks and enc_blocks (L), the moe family's
    dense_blocks / moe_blocks (its one list split at first_k_dense),
    groups (G, per), tail (n); shared_attn and mtp are unstacked."""
    head, shape = path[0], tuple(shape)
    if head in ("blocks", "enc_blocks", "tail"):
        rest = path[2:]
        if head == "blocks" and cfg.arch_type == "moe":
            k = cfg.first_k_dense
            moe = cfg.layer_kinds()[path[1]] == "moe"
            name = "moe_blocks" if moe else "dense_blocks"
            stack = (cfg.n_layers - k,) if moe else (k,)
        elif head == "tail":
            period = cfg.hybrid_period
            name, stack = head, (cfg.n_layers
                                 - cfg.n_layers // period * period,)
        else:
            name = head
            stack = (cfg.n_enc_layers if head == "enc_blocks"
                     else cfg.n_layers,)
    elif head == "groups":
        rest, name = path[3:], head
        stack = (cfg.n_layers // cfg.hybrid_period, cfg.hybrid_period - 1)
    else:
        rest, name, stack = path[1:], head, ()
    leaf = rest[-1] if rest else ""
    parent = rest[-2] if len(rest) > 1 else ""
    merge = None
    if parent in ("attn", "cross") and leaf in ("wq", "wk", "wv"):
        heads = cfg.n_heads if leaf == "wq" else cfg.n_kv_heads
        shape, merge = (shape[0], heads, shape[1] // heads), 1
    elif parent in ("attn", "cross") and leaf == "wo":
        shape, merge = (cfg.n_heads, shape[0] // cfg.n_heads, shape[1]), 0
    return (_path_str((name,) + tuple(rest)), stack + shape, len(stack),
            merge)


def _spec_of(rules, dsz: int, fsdp: bool, path: str, shape) -> Spec:
    """JAX's `param_specs.spec_of` on a leaf of JAX's layout."""
    ndim = len(shape)
    spec = None
    for rx, sp in rules:
        if rx.search(path):
            spec = _right_align(sp, ndim)
            break
    if spec is None:
        spec = (None,) * ndim
    if fsdp and ndim >= 2 and dsz > 1:
        # the largest replicated dim divisible by data, skipping dim 0 of
        # leaves of three dims or more (the stack dim of stacked ones)
        best, best_size = None, 0
        for i in range(1 if ndim >= 3 else 0, ndim):
            if spec[i] is None and shape[i] % dsz == 0 \
                    and shape[i] > best_size:
                best, best_size = i, shape[i]
        if best is not None and best_size >= dsz:
            spec = spec[:best] + ("data",) + spec[best + 1:]
    return spec


class LayerSpec(tuple):
    """A spec of one layer's leaf (a tuple over its dims, equal to the
    plain tuple) that also says how JAX splits the layer stack it belongs
    to: `stack`, one entry per stack dim (() for an unstacked leaf)."""
    stack: Spec = ()

    def __new__(cls, spec: Spec, stack: Spec = ()):
        out = super().__new__(cls, spec)
        out.stack = tuple(stack)
        return out

    def __reduce__(self):
        return LayerSpec, (tuple(self), self.stack)


def _merge(a: Axis, b: Axis) -> Axis:
    names = _names(a) + _names(b)
    return None if not names else names[0] if len(names) == 1 else names


def param_specs(cfg: ModelConfig, mesh, params: Tree, fsdp: bool = False,
                experts_2d: bool = False) -> Tree:
    """Per-leaf spec of the port's parameter tree (module docstring):
    JAX's rule on the JAX leaf, its stack dims dropped and a flattened
    projection's (H, hd) pair merged. With `fsdp=True` every matrix also
    shards one replicated weight dim over "data" (ZeRO-3 storage)."""
    rules = param_rules(cfg, mesh, experts_2d=experts_2d)
    dsz = axis_sizes(mesh).get("data", 1)

    def spec_of(path, leaf):
        jpath, jshape, n_stack, merge = jax_leaf(cfg, path, leaf.shape)
        spec = _spec_of(rules, dsz, fsdp, jpath, jshape)
        stack, spec = spec[:n_stack], spec[n_stack:]
        if merge is not None:
            spec = spec[:merge] + (_merge(spec[merge], spec[merge + 1]),) \
                + spec[merge + 2:]
        return LayerSpec(spec, stack)

    return _map_with_path(spec_of, params)


def opt_state_specs(param_spec_tree: Tree) -> Dict[str, Any]:
    """AdamW's state ({"m", "v", "step"}) laid out as the parameters."""
    return {"m": param_spec_tree, "v": param_spec_tree, "step": ()}


# ---------------------------------------------------------------------------
# cache / batch specs
# ---------------------------------------------------------------------------

def make_cache_specs(cfg: ModelConfig, mesh, cache: Tree, global_batch: int,
                     seq_axis: str = "model") -> Tree:
    """Per-leaf spec of the port's decode cache (`transformer.init_cache`).
    JAX's rules read its trailing dims, which the two layouts share (the
    port stacks every cache leaf on one leading dim where JAX stacks one
    or two): batch over the batch axes, a KV cache's sequence over
    `seq_axis` where it divides, whisper's cross K/V by batch only, the
    ring's positions by batch, mamba2's channels / heads over "model"."""
    sizes = axis_sizes(mesh)
    b = batch_axes(mesh, global_batch)
    msz = sizes["model"]
    sa = seq_axis if sizes.get(seq_axis, 1) > 1 else None
    m_di = "model" if (cfg.ssm_state and cfg.d_inner % msz == 0) else None
    m_sh = "model" if (cfg.ssm_state and cfg.ssm_nheads % msz == 0) \
        else None

    def spec_of(path, leaf):
        s, nd = _path_str(path), leaf.ndim

        def seq_ax(n):
            return sa if (sa and n % msz == 0) else None

        if re.search(r"cross", s):
            return _right_align([b, None, None, None], nd)
        if re.search(r"(^|/)[kv]$", s):
            return _right_align([b, seq_ax(leaf.shape[-3]), None, None], nd)
        if re.search(r"(c_kv|k_rope)$", s):
            return _right_align([b, seq_ax(leaf.shape[-2]), None], nd)
        if re.search(r"(^|/)pos$", s):
            return _right_align([b, None], nd)
        if re.search(r"conv_x$", s):
            return _right_align([b, None, m_di], nd)
        if re.search(r"conv_[BC]$", s):
            return _right_align([b, None, None], nd)
        if re.search(r"(^|/)ssm$", s):
            return _right_align([b, m_sh, None, None], nd)
        return _right_align([b], nd) if nd else ()

    return _map_with_path(spec_of, cache)


def batch_specs(cfg: ModelConfig, mesh, batch: Tree,
                global_batch: int) -> Tree:
    """Every batch leaf split on dim 0 over the batch axes."""
    b = batch_axes(mesh, global_batch)
    return _map_with_path(
        lambda path, leaf: _right_align([b] + [None] * (leaf.ndim - 1),
                                        leaf.ndim), batch)


# ---------------------------------------------------------------------------
# activation constrainer
# ---------------------------------------------------------------------------

class Constrainer:
    """constrain(x, logical_axes): JAX's `with_sharding_constraint` point.
    `resolve(shape, axes)` is the spec JAX places there; a DTensor is
    redistributed to it, any other tensor passes through unchanged (one
    device, or a rank's plain shard)."""

    def __init__(self, mesh, table: Dict[str, Axis]):
        self.mesh, self.table = mesh, table
        self.sizes = axis_sizes(mesh)

    def resolve(self, shape, axes: Sequence[Optional[str]]) -> Spec:
        spec = [self.table.get(a) for a in axes]
        dims = tuple(shape)[-len(axes):]
        # guard divisibility and resolve duplicate mesh-axis claims:
        # "seq" has the LOWEST priority (a seq-sharded residual stream
        # yields to heads / vocab sharding inside blocks)
        used = set()
        for i in sorted(range(len(axes)), key=lambda i: axes[i] == "seq"):
            names = _names(spec[i])
            if not names:
                continue
            sz = 1
            for a in names:
                sz *= self.sizes[a]
            if dims[i] % sz != 0 or any(a in used for a in names):
                spec[i] = None
            else:
                used.update(names)
        return _right_align(spec, len(shape))

    def __call__(self, x, axes):
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(x.device_mesh, placements(
            self.mesh, self.resolve(x.shape, axes)))


def make_constrainer(mesh, global_batch: int, seq_axis=None,
                     vocab: int = 0, n_experts: int = 0,
                     experts_2d: bool = False) -> Constrainer:
    """The JAX `make_constrainer`'s table: batch over the batch axes, seq
    over `seq_axis`, vocab and heads over "model", experts over "model"
    (or ("model", "data") with `experts_2d`)."""
    sizes = axis_sizes(mesh)
    b = batch_axes(mesh, global_batch)
    msz, dsz = sizes.get("model", 1), sizes.get("data", 1)
    if experts_2d and n_experts and n_experts % (msz * dsz) == 0:
        e_ax = ("model", "data")
    elif n_experts and msz > 1 and n_experts % msz == 0:
        e_ax = "model"
    else:
        e_ax = None
    return Constrainer(mesh, {
        "batch": b, "seq": seq_axis, "embed": None,
        "vocab": "model" if (msz > 1 and vocab % msz == 0) else None,
        "heads": "model" if msz > 1 else None, "experts": e_ax})


def no_constrain(x, axes):
    """The identity constrainer (one device)."""
    return x


# ---------------------------------------------------------------------------
# placements and per-device shards
# ---------------------------------------------------------------------------

def placements(mesh, spec: Spec):
    """DTensor placements of a spec: Shard(dim) on each mesh dim a tensor
    dim names, Replicate elsewhere (mesh dim order)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in axis_sizes(mesh):
        dims = [i for i, ax in enumerate(spec) if name in _names(ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def local_shape(mesh, spec: Spec, shape) -> Tuple[int, ...]:
    """Each device's shard of a leaf of `shape` under `spec`; every
    sharded dim must divide (JAX's argument shardings take no padding)."""
    sizes = axis_sizes(mesh)
    out = []
    for n, ax in zip(tuple(shape), spec):
        k = 1
        for a in _names(ax):
            k *= sizes[a]
        if n % k:
            raise ValueError(f"dim {n} does not divide over {ax} ({k})")
        out.append(n // k)
    return tuple(out)


def stack_shards(mesh, spec: Spec) -> int:
    """Over how many devices a `LayerSpec`'s layer stack is split (1 for
    any other spec)."""
    sizes, n = axis_sizes(mesh), 1
    for ax in getattr(spec, "stack", ()):
        for a in _names(ax):
            n *= sizes[a]
    return n


def local_bytes(mesh, tree: Tree, spec_tree: Tree) -> int:
    """The bytes of each device's shards of a tree's tensors (the
    dry-run's per-device argument bytes); a layer whose stack is split
    counts its share (`stack_shards`), exact summed over the stack."""
    from fractions import Fraction

    from repro_torch import tree as TR
    total = Fraction(0)
    for leaf, spec in zip(TR.leaves(tree), _spec_leaves(spec_tree)):
        n = 1
        for d in local_shape(mesh, spec, leaf.shape):
            n *= d
        total += Fraction(n * leaf.element_size(), stack_shards(mesh, spec))
    if total.denominator != 1:
        raise ValueError(f"per-device bytes {total}: a split layer stack "
                         "does not divide")
    return int(total)


def _spec_leaves(spec_tree: Tree):
    """The specs of a spec tree in `tree.leaves` order (a spec is a tuple,
    not a list: it is a leaf)."""
    if isinstance(spec_tree, dict):
        return [x for k in sorted(spec_tree)
                for x in _spec_leaves(spec_tree[k])]
    if isinstance(spec_tree, list):
        return [x for item in spec_tree for x in _spec_leaves(item)]
    return [spec_tree]


def mesh_coord(mesh, dims: Sequence[int]) -> Tuple[int, int]:
    """(this rank's index over the mesh dims `dims`, the first major; how
    many ranks they hold)."""
    index, n = 0, 1
    for i in dims:
        index = index * mesh.size(i) + mesh.get_local_rank(i)
        n *= mesh.size(i)
    return index, n


def batch_shard(mesh) -> Tuple[int, int, list]:
    """(this rank's batch-rank index, their count, each batch axis's
    process group): the batch axes are every axis but "model", JAX's
    `P(batch_axes)`, split in their order (pod-major)."""
    dims = [i for i, a in enumerate(mesh.mesh_dim_names) if a != "model"]
    index, n = mesh_coord(mesh, dims)
    return index, n, [mesh.get_group(i) for i in dims]


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_shard(x, mesh, placements, grad_placements=None):
    """A DTensor's local shard after redistributing it to `placements`;
    its gradient, made contiguous on the way back, re-enters DTensor as
    `grad_placements` (the same by default). DTensor reads a gradient's
    global strides off the forward's, so a permuted local gradient (an
    einsum's) would fail the next view of it."""
    return _ContiguousGrad.apply(x.redistribute(mesh, placements).to_local(
        grad_placements=grad_placements))


def reduced(x):
    """x with a DTensor's pending (Partial) sums reduced, the rest of its
    placement kept; any other tensor as it is. The model calls it on a
    row-split product before its residual add: there GSPMD all-reduces
    the product, where DTensor would carry the sum on into the add and
    the backward (whose gradients then hold whole batches)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(x, DTensor) or not any(
            isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in x.placements])


def run_sharded(fn, args: Sequence, dims: Sequence, out_dims: Sequence,
                heads: int):
    """fn(*args) on each rank's shards of DTensor args, split only over
    the batch and the heads: the mesh dims that split the first DTensor
    arg's batch dim split every arg's batch dim alike, "model" splits
    every head dim where `heads` divides it (else the heads are whole on
    every rank), every other dim is whole. dims: (batch dim, head dim) of
    each arg (None where it has none); a plain tensor arg (whole on every
    rank) is cut to the rank's rows and heads, a None passes through.
    Returns fn's output(s) as DTensors placed by out_dims (a pair, or a
    tuple of pairs for a tuple of outputs). The attention core and the
    SSD scan run so on the dry-run's meshes: each is independent over
    batch and heads, and DTensor's own propagation of their batched
    products over a 3-D mesh's split dims is slow to plan."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    first, fdims = next((a, d) for a, d in zip(args, dims)
                        if isinstance(a, DTensor))
    mesh = first.device_mesh
    bmesh = [i for i, p in enumerate(first.placements)
             if isinstance(p, Shard) and p.dim == fdims[0]]
    names = mesh.mesh_dim_names
    mi = names.index("model") if "model" in names else None
    if mi in bmesh or (mi is not None and heads % mesh.size(mi)):
        mi = None
    bi, nb = mesh_coord(mesh, bmesh)

    def place(bd, hd):
        return [Shard(bd) if bd is not None and i in bmesh else
                Shard(hd) if hd is not None and i == mi else Replicate()
                for i in range(mesh.ndim)]

    def local(a, bd, hd):
        if a is None:
            return None
        if isinstance(a, DTensor):
            return local_shard(a, mesh, place(bd, hd))
        if bd is not None:
            n = a.shape[bd] // nb
            a = a.narrow(bd, bi * n, n)
        if hd is not None and mi is not None:
            n = a.shape[hd] // mesh.size(mi)
            a = a.narrow(hd, mesh.get_local_rank(mi) * n, n)
        return a

    out = fn(*[local(a, *d) for a, d in zip(args, dims)])
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o, mesh, place(*d))
                     for o, d in zip(out, out_dims))
    return DTensor.from_local(out, mesh, place(*out_dims))


# ---------------------------------------------------------------------------
# collectives with their gradients, for code that runs on each rank's
# shards (the expert-parallel MoE, the SPMD train step, the dry-run's
# sharded loss): JAX's transposes place these for it
# ---------------------------------------------------------------------------

class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        y = x.clone(memory_format=torch.contiguous_format)
        for g in groups:
            dist.all_reduce(y, group=g)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        for grp in ctx.groups:
            dist.all_reduce(g, group=grp)
        return g, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, n):
        ctx.n = n
        return _SumOver.forward(ctx, x, groups) / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, index):
        ctx.groups, ctx.rows, ctx.index = groups, x.shape[0], index
        t = x.contiguous()
        for g in reversed(groups):
            parts = [torch.empty_like(t) for _ in range(
                dist.get_world_size(g))]
            dist.all_gather(parts, t, group=g)
            t = torch.cat(parts)
        return t

    @staticmethod
    def backward(ctx, g):
        g = _SumGrad.backward(ctx, g)[0]
        lo = ctx.index * ctx.rows
        return g[lo:lo + ctx.rows], None, None


def sum_over(x, groups):
    """All-reduce (sum) over the process groups forward; the cotangent,
    the same on every rank of the groups, passes back unchanged."""
    return _SumOver.apply(x, groups)


def sum_grad(x, groups):
    """The identity forward; the gradient all-reduced (sum) over the
    groups (a value replicated over them, each rank's use partial)."""
    return _SumGrad.apply(x, groups)


def mean_over(x, groups, n: int):
    """The mean over the groups' n ranks forward (JAX's pmean); the
    cotangent, the same on every rank, scaled by 1 / n."""
    return _MeanOver.apply(x, groups, n)


def gather_rows(x, groups, index: int):
    """Dim 0 gathered over the groups (innermost axis first, so the rows
    come in batch-rank order); the gradient summed over them, and this
    rank's rows kept (`index`: its batch-rank index)."""
    return _GatherRows.apply(x, groups, index)


def distribute_tree(mesh, tree: Tree, spec_tree: Tree) -> Tree:
    """The tree's tensors as DTensors on `mesh`, each placed by its spec
    (the JAX dry-run's in_shardings)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import tree as TR
    return TR.unflatten(tree, [
        distribute_tensor(leaf, mesh, placements(mesh, spec))
        for leaf, spec in zip(TR.leaves(tree), _spec_leaves(spec_tree))])


# ---------------------------------------------------------------------------
# router-DB capacity-axis sharding (DESIGN.md §12)
# ---------------------------------------------------------------------------

#: mesh axis the RouterState DB panels partition over. Not the fleet's
#: "data"/"model": the routing DB scales on its own 1-D mesh.
DB_AXIS = "db"

#: the (C, ...) DB panels: split on dim 0 into CONTIGUOUS row ranges
DB_SHARDED = ("emb", "model_a", "model_b", "outcome", "valid")
#: the (M,) ratings and the () live-row count: one copy per device
DB_PER_DEVICE = ("global_ratings", "size")


def db_state_specs() -> Dict[str, Optional[str]]:
    """The mesh axis each RouterState field splits dim 0 over (None: held
    whole on every device). Shard s owns global rows [s*C/S, (s+1)*C/S).
    Contiguity is load-bearing: the cross-shard top-k merge orders its
    candidate pool (shard, local rank), which is ascending global row
    among equal scores only under a contiguous split — that keeps
    tie-breaking bit-identical to the single-device route."""
    specs: Dict[str, Optional[str]] = {f: None for f in DB_PER_DEVICE}
    specs.update({f: DB_AXIS for f in DB_SHARDED})
    return specs


def db_shard_count(mesh) -> int:
    return mesh.shape[DB_AXIS]


def check_db_mesh(mesh, capacity: int) -> int:
    """Validate a DB mesh against a state capacity; returns the shard
    count. The capacity must divide exactly (VectorDB's doubling grow
    keeps a power-of-two capacity divisible)."""
    if DB_AXIS not in mesh.axis_names:
        raise ValueError(
            f"DB mesh must carry a {DB_AXIS!r} axis, got {mesh.axis_names}")
    shards = db_shard_count(mesh)
    if capacity % shards != 0:
        raise ValueError(
            f"capacity {capacity} does not divide over {shards} DB shards")
    return shards
