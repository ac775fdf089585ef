"""The port's sharding rules (`repro_torch/sharding.py`) against the JAX
package's, leaf by leaf, on stub meshes: parameter specs (plain, fsdp,
experts_2d) for every architecture, the cache, batch and optimiser
specs, batch_axes, and the constrainer's resolved spec at each kind of
constraint point. The JAX rules read only the mesh's axis sizes; its
constrainer's spec is captured by patching `with_sharding_constraint`."""
import dataclasses
import functools
import types

import jax
import pytest

from repro import sharding as JS
from repro.configs import ARCH_IDS, get_config as j_config
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch import sharding as TS
from repro_torch.configs import get_config as t_config
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

jax.config.update("jax_platform_name", "cpu")

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2},
          "1x4": {"data": 1, "model": 4}}
VARIANTS = {"plain": {}, "fsdp": {"fsdp": True},
            "experts_2d": {"experts_2d": True}}


def jax_mesh(name):
    shape = MESHES[name]
    return types.SimpleNamespace(shape=dict(shape),
                                 axis_names=tuple(shape))


def spec(p):
    """A JAX PartitionSpec as the port's tuple."""
    return tuple(p)


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    cfg = j_config(arch)
    return cfg, jax.eval_shape(lambda: JT.init_params(cfg,
                                                      jax.random.key(0)))


@functools.lru_cache(maxsize=None)
def port_params(arch):
    cfg = t_config(arch)
    return cfg, TT.init_params(cfg, TL.MetaGenerator(), train=True)


def port_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from port_leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from port_leaves(v, path + (i,))
    else:
        yield path, tree


def jax_counterpart(cfg, jspecs, path):
    """(JAX's spec of the stacked leaf the port's leaf at `path` is a
    slice of, the number of stack dims, the flattened pair's first dim or
    None), by the converter's layout: a list of blocks is one stacked
    leaf (the moe family's split at first_k_dense), the hybrid's groups
    two stack dims, and the attention projections 3-D."""
    head = path[0]
    if head in ("blocks", "enc_blocks", "tail"):
        rest, n_stack = path[2:], 1
        if head == "blocks" and cfg.arch_type == "moe":
            head = "moe_blocks" if path[1] >= cfg.first_k_dense \
                else "dense_blocks"
    elif head == "groups":
        rest, n_stack = path[3:], 2
    else:
        rest, n_stack = path[1:], 0
    node = jspecs[head]
    for k in rest:
        node = node[k]
    flat = None
    if len(rest) >= 2 and rest[-2] in ("attn", "cross") \
            and rest[-1] in convert._FLATTEN:
        flat = 0 if rest[-1] == "wo" else 1
    return spec(node), n_stack, flat, (head,) + tuple(rest)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax(arch, mesh, variant):
    kw = VARIANTS[variant]
    cfg_j, shapes = jax_params(arch)
    cfg_t, params = port_params(arch)
    jspecs = JS.param_specs(cfg_j, jax_mesh(mesh), shapes, **kw)
    tspecs = TS.param_specs(cfg_t, MESHES[mesh], params, **kw)
    seen = set()
    for path, leaf in port_leaves(params):
        got = tspecs
        for k in path:
            got = got[k]
        want, n_stack, flat, key = jax_counterpart(cfg_t, jspecs, path)
        seen.add(key)
        assert got.stack == want[:n_stack], (path, got.stack, want)
        want = want[n_stack:]
        if flat is not None:
            a, b = want[flat], want[flat + 1]
            merged = tuple(x for ax in (a, b) if ax is not None
                           for x in ((ax,) if isinstance(ax, str) else ax))
            want = want[:flat] + (merged[0] if len(merged) == 1 else
                                  merged or None,) + want[flat + 2:]
        assert got == want, (path, got, want)
        assert len(got) == leaf.ndim
    assert len(seen) == len(jax.tree.leaves(shapes))
    # every shard divides: the per-device arithmetic is defined
    assert TS.local_bytes(MESHES[mesh], params, tspecs) > 0


def test_fsdp_reads_the_stacked_shape():
    """fsdp's choice of dim is made on JAX's stacked leaf: a norm scale,
    1-D here, is (L, d) there and takes "data" on d; mamba2's A_log, (L,
    H) there with H on "model", takes "data" on the layer dim itself,
    which the port keeps as the spec's stack entry; its per-device bytes
    are the layers' share."""
    m = MESHES["16x16"]
    cfg, params = port_params("qwen3-8b")
    specs = TS.param_specs(cfg, m, params, fsdp=True)
    assert params["blocks"][0]["attn_norm"]["scale"].ndim == 1
    assert specs["blocks"][0]["attn_norm"]["scale"] == ("data",)
    assert TS.param_specs(cfg, m, params)["blocks"][0]["attn_norm"][
        "scale"] == (None,)
    cfg, params = port_params("mamba2-780m")
    specs = TS.param_specs(cfg, m, params, fsdp=True)
    a_log = specs["blocks"][0]["mamba"]["A_log"]
    assert a_log == ("model",) and a_log.stack == ("data",)
    assert TS.stack_shards(m, a_log) == 16
    leaf = params["blocks"][0]["mamba"]["A_log"]
    one = {"A_log": [leaf] * cfg.n_layers}
    got = TS.local_bytes(m, one, {"A_log": [a_log] * cfg.n_layers})
    assert got == cfg.n_layers // 16 * leaf.numel() // 16 \
        * leaf.element_size()


def test_opt_state_specs_follow_the_params():
    cfg, params = port_params("phi3.5-moe-42b-a6.6b")
    ps = TS.param_specs(cfg, MESHES["16x16"], params, fsdp=True)
    os_ = TS.opt_state_specs(ps)
    cfg_j, shapes = jax_params("phi3.5-moe-42b-a6.6b")
    jo = JS.opt_state_specs(JS.param_specs(cfg_j, jax_mesh("16x16"),
                                           shapes, fsdp=True))
    assert os_["m"] is ps and os_["v"] is ps
    assert os_["step"] == spec(jo["step"]) == ()


# ---------------------------------------------------------------------------
# caches, batches, batch axes
# ---------------------------------------------------------------------------

CACHE_ARCHS = ARCH_IDS + ["gemma3-12b+ring"]


def _cfgs(arch):
    if arch.endswith("+ring"):
        base = arch[:-len("+ring")]
        return (dataclasses.replace(j_config(base), window_cache=True),
                dataclasses.replace(t_config(base), window_cache=True))
    return j_config(arch), t_config(arch)


def jax_cache_counterpart(cfg, jcache, path):
    """The JAX cache leaf(s) the port's leaf at `path` stands for (the
    moe family's kv_dense / kv_moe and the hybrid's groups / tail
    states are one port leaf each)."""
    at = cfg.arch_type
    if TT.ring_cache(cfg):
        keys = [path]
    elif at in ("dense", "vlm"):
        keys = [("kv",) + path]
    elif at == "moe":
        keys = [(k,) + path for k in ("kv_dense", "kv_moe") if k in jcache]
    elif at == "ssm":
        keys = [("ssm",) + path]
    elif at == "hybrid":
        keys = [path] if path[0] == "attn" else [
            (k,) + path[1:] for k in ("groups_ssm", "tail_ssm")
            if k in jcache]
    else:   # encdec
        keys = [path] if path[0] == "cross" else [("kv",) + path]
    out = []
    for key in keys:
        node = jcache
        for k in key:
            node = node[k]
        out.append(node)
    return out


@pytest.mark.parametrize("seq_axis", ["model", None])
@pytest.mark.parametrize("gb", [1, 2, 128])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_specs_equal_jax(arch, mesh, gb, seq_axis):
    cfg_j, cfg_t = _cfgs(arch)
    max_len = 4096
    jshape = jax.eval_shape(lambda: JT.init_cache(cfg_j, gb, max_len))
    tcache = TT.init_cache(cfg_t, gb, max_len, device="meta")
    jspecs = JS.make_cache_specs(cfg_j, jax_mesh(mesh), jshape, gb,
                                 seq_axis=seq_axis)
    tspecs = TS.make_cache_specs(cfg_t, MESHES[mesh], tcache, gb,
                                 seq_axis=seq_axis)
    for path, leaf in port_leaves(tcache):
        got = tspecs
        for k in path:
            got = got[k]
        assert len(got) == leaf.ndim
        for want in jax_cache_counterpart(cfg_t, jspecs, path):
            want = spec(want)
            n_stack = len(want) - (leaf.ndim - 1)
            assert not any(want[:n_stack]) and got[0] is None
            assert got[1:] == want[n_stack:], (path, got, want)
    TS.local_bytes(MESHES[mesh], tcache, tspecs)


@pytest.mark.parametrize("gb", [1, 2, 128, 256])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_and_axes_equal_jax(arch, mesh, gb):
    cfg_j, cfg_t = j_config(arch), t_config(arch)
    assert TS.batch_axes(MESHES[mesh], gb) == JS.batch_axes(jax_mesh(mesh),
                                                           gb)
    import numpy as np
    import torch
    batch = {"tokens": torch.empty((gb, 64), dtype=torch.int32,
                                   device="meta"),
             "enc_embeds": torch.empty((gb, 8, cfg_t.d_model),
                                       device="meta")}
    jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
              for k, v in batch.items()}
    jspecs = JS.batch_specs(cfg_j, jax_mesh(mesh), jbatch, gb)
    tspecs = TS.batch_specs(cfg_t, MESHES[mesh], batch, gb)
    assert {k: spec(v) for k, v in jspecs.items()} == tspecs


# ---------------------------------------------------------------------------
# the constrainer
# ---------------------------------------------------------------------------

#: (shape, logical axes) of the model's constraint points: the residual
#: stream, logits, attention heads, the attend's query chunks, the small
#: MoE's expert buffers; the shapes pick divisible and indivisible dims
POINTS = [
    ((256, 4096, 4096), ("batch", "seq", "embed")),
    ((3, 100, 64), ("batch", "seq", "embed")),
    ((256, 4096, 151936), ("batch", "seq", "vocab")),
    ((8, 16, 51866), ("batch", "seq", "vocab")),
    ((32, 4096, 32, 128), ("batch", "seq", "heads", "head_dim")),
    ((32, 4096, 20, 64), ("batch", "seq", "heads", "head_dim")),
    ((32, 8, 512, 32, 128), ("batch", "seq", "seq", "heads", "head_dim")),
    ((256, 4, 4096), ("experts", None, None)),
    ((16, 2, 4096), ("experts", None, None)),
]
CONSTRAIN_OPTS = {
    "plain": dict(seq_axis=None, experts_2d=False),
    "seq": dict(seq_axis="model", experts_2d=False),
    "experts_2d": dict(seq_axis=None, experts_2d=True),
}


@pytest.mark.parametrize("opts", list(CONSTRAIN_OPTS))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("point", range(len(POINTS)))
def test_constrainer_resolves_as_jax(point, mesh, opts, monkeypatch):
    shape, axes = POINTS[point]
    kw = dict(vocab=shape[-1] if "vocab" in axes else 151936,
              n_experts=shape[0] if axes[0] == "experts" else 0,
              **CONSTRAIN_OPTS[opts])
    seen = []
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, p: p)
    monkeypatch.setattr(JS.jax.lax, "with_sharding_constraint",
                        lambda x, p: seen.append(spec(p)) or x)
    gb = shape[0]
    JS.make_constrainer(jax_mesh(mesh), gb, **kw)(
        jax.ShapeDtypeStruct(shape, "float32"), axes)
    got = TS.make_constrainer(MESHES[mesh], gb, **kw).resolve(shape, axes)
    assert [got] == seen


def test_constrainer_passes_plain_tensors_through():
    import torch
    x = torch.ones(4, 8, 16)
    c = TS.make_constrainer(MESHES["2x2"], 4, vocab=16)
    assert c(x, ("batch", "seq", "vocab")) is x
    assert TS.no_constrain(x, ("batch",)) is x


def test_placements_and_local_shapes():
    from torch.distributed.tensor import Replicate, Shard
    m = MESHES["2x16x16"]
    assert TS.placements(m, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert TS.placements(m, (None,)) == (Replicate(),) * 3
    assert TS.local_shape(m, (("pod", "data"), None, "model"),
                          (64, 3, 32)) == (2, 3, 2)
    with pytest.raises(ValueError, match="does not divide"):
        TS.local_shape(m, ("model",), (20,))
