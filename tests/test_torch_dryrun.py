"""The port's dry-run analogue against the JAX package's, on the CPU:
`configs/shapes.py` (SHAPES, supports, input_specs), the analytic cost
model (`analysis/roofline_model.py`, pure Python: equal to the last
bit), and `launch/dryrun.py` on the meta device.

The JAX dry-run itself needs 512 forced host devices
(`tests/test_dryrun.py`); here only its pure-Python pieces run
(`model_flops`, `input_specs` under `jax.eval_shape`).

Bar for the counted FLOPs: a decode step's FLOPs, counted on the meta
device by `torch.utils.flop_counter`'s formulas (`dryrun.StepCounter`),
within 1% of `analytic_costs` (olmo-1b x decode_32k: the matmuls, the
attention's two products over every cache row and the logits, which
both count the same way).

The JAX meshes (`--mesh single|multi`, `--fsdp`, `--experts-2d`,
`--seq-shard`) run on the "fake" backend in this process; each record's
per-device argument bytes are held, integer-equal, to the arithmetic of
JAX's own specs (`repro.sharding` on a stub mesh of the same shape)
over the port's arguments.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import roofline_model as JR
from repro.configs import ARCH_IDS as J_IDS
from repro.configs import get_config as j_config
from repro.configs import shapes as JS
from repro_torch.analysis import roofline_model as TRM
from repro_torch.configs import ARCH_IDS, get_config, get_reduced_config
from repro_torch.configs import shapes as TS
from repro_torch.launch import dryrun as D
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import count_params

jax.config.update("jax_platform_name", "cpu")

PAIRS = [(a, s) for a in ARCH_IDS for s in TS.SHAPES]
FLOPS_BAR = 0.01
_DT = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.float32):
       torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _with_ring(arch, ring):
    import dataclasses
    jc, tc = j_config(arch), get_config(arch)
    if ring:
        jc = dataclasses.replace(jc, window_cache=True)
        tc = dataclasses.replace(tc, window_cache=True)
    return jc, tc


def _jax_cache_in_port_layout(cfg, jcache):
    """JAX's decode cache as {path: (shape, dtype)} in the port's layout
    (transformer.py's docstring): stacked layer axes flattened into one,
    moe's two stacks and hybrid's groups and tail joined."""
    dt = lambda a: _DT[jnp.dtype(a.dtype)]
    sd = lambda a: (tuple(a.shape), dt(a))
    flat = lambda a: ((int(np.prod(a.shape[:2])),) + tuple(a.shape[2:]),
                      dt(a))
    at = cfg.arch_type
    if "kv_local" in jcache:
        out = {f"kv_local/{k}": flat(v)
               for k, v in jcache["kv_local"].items()}
        out.update({f"kv_global/{k}": sd(v)
                    for k, v in jcache["kv_global"].items()})
        return out
    if at in ("dense", "vlm"):
        return {k: sd(v) for k, v in jcache["kv"].items()}
    if at == "moe":
        stacks = [jcache[n] for n in ("kv_dense", "kv_moe") if n in jcache]
        return {k: ((sum(s[k].shape[0] for s in stacks),)
                    + tuple(stacks[0][k].shape[1:]), dt(stacks[0][k]))
                for k in stacks[0]}
    if at == "ssm":
        return {k: sd(v) for k, v in jcache["ssm"].items()}
    if at == "hybrid":
        out = {f"attn/{k}": sd(v) for k, v in jcache["attn"].items()}
        for k, v in jcache["groups_ssm"].items():
            n = v.shape[0] * v.shape[1]
            if "tail_ssm" in jcache:
                n += jcache["tail_ssm"][k].shape[0]
            out[f"ssm/{k}"] = ((n,) + tuple(v.shape[2:]), dt(v))
        return out
    if at == "encdec":
        out = {k: sd(v) for k, v in jcache["kv"].items()}
        out.update({f"cross/{k}": sd(v)
                    for k, v in jcache["cross"].items()})
        return out
    raise ValueError(at)


def _port_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = (tuple(v.shape), v.dtype)
    return out


def test_shapes_and_long_archs_are_the_jax_modules():
    assert TS.SHAPES == JS.SHAPES
    assert TS._LONG_OK == JS._LONG_OK
    assert ARCH_IDS == J_IDS


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_supports_matches_jax(arch, shape):
    assert TS.supports(get_config(arch), shape) == \
        JS.supports(j_config(arch), shape)


@pytest.mark.parametrize("arch,shape,ring", [
    (a, s, False) for a, s in PAIRS
    if TS.supports(get_config(a), s)[0]] + [
    ("gemma3-12b", s, True) for s in ("decode_32k", "long_500k")])
def test_input_specs_match_jax(arch, shape, ring):
    """The 33 supported pairs (and gemma3's ring cache): every batch leaf
    and the decode tokens with JAX's shapes and dtypes, the decode cache
    JAX's in the port's layout, all on the meta device. The decode index
    is the port's (1,) int64 device index, where JAX's is a () int32."""
    jc, tc = _with_ring(arch, ring)
    want = JS.input_specs(jc, shape)
    got = TS.input_specs(tc, shape)
    assert {k: v for k, v in got.items() if not isinstance(v, (dict,
            torch.Tensor))} == {k: v for k, v in want.items()
                                if not isinstance(v, dict)
                                and k not in ("tokens", "index")}
    leaves = [x for x in _leaves(got) if isinstance(x, torch.Tensor)]
    assert leaves and all(x.device.type == "meta" for x in leaves)
    if got["kind"] in ("train", "prefill"):
        assert got["batch"].keys() == want["batch"].keys()
        for k, v in want["batch"].items():
            assert tuple(got["batch"][k].shape) == v.shape, k
            assert got["batch"][k].dtype == _DT[jnp.dtype(v.dtype)], k
        return
    assert tuple(got["tokens"].shape) == want["tokens"].shape
    assert got["tokens"].dtype == torch.int32
    assert want["index"].shape == () and tuple(got["index"].shape) == (1,)
    assert got["index"].dtype == torch.int64
    assert _port_tree(got["cache"]) == _jax_cache_in_port_layout(
        jc, want["cache"])


@pytest.mark.parametrize("arch,shape", [
    (a, s) for a, s in PAIRS if not TS.supports(get_config(a), s)[0]])
def test_unsupported_pairs_raise_as_jax(arch, shape):
    with pytest.raises(ValueError) as jerr:
        JS.input_specs(j_config(arch), shape)
    with pytest.raises(ValueError) as terr:
        TS.input_specs(get_config(arch), shape)
    assert str(terr.value) == str(jerr.value)


def test_seven_pairs_are_unsupported():
    assert sum(not TS.supports(get_config(a), s)[0] for a, s in PAIRS) == 7
    assert len(PAIRS) == 40


def _jax_model_flops():
    """The JAX dry-run's `model_flops`. Its module sets XLA_FLAGS to 512
    host devices when imported; the variable is put back at once, so
    this process's JAX backend keeps its devices."""
    import os
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import model_flops
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return model_flops


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_cost_model_equals_jax(arch, shape):
    """analytic_costs, fwd_flops_per_token, _cache_bytes (full and
    windowed) and model_flops equal JAX's exactly on every pair."""
    j_model_flops = _jax_model_flops()
    jc, tc = j_config(arch), get_config(arch)
    spec = TS.SHAPES[shape]
    kind, b, s = spec["kind"], spec["global_batch"], spec["seq_len"]
    assert TRM.analytic_costs(tc, kind, b, s) == \
        JR.analytic_costs(jc, kind, b, s)
    for decode in (False, True):
        assert TRM.fwd_flops_per_token(tc, s / 2.0, decode) == \
            JR.fwd_flops_per_token(jc, s / 2.0, decode)
    for windowed in (False, True):
        assert TRM._cache_bytes(tc, b, s, windowed) == \
            JR._cache_bytes(jc, b, s, windowed)
    assert D.model_flops(tc, kind, b, s) == j_model_flops(jc, kind, b, s)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_generator_builds_the_same_tree(arch):
    """init_params on MetaGenerator (the dry-run's eval_shape) gives the
    tree a real generator gives: the same keys, shapes and dtypes, every
    leaf on the meta device (reduced configs; train=True draws the mtp
    head too)."""
    cfg = get_reduced_config(arch)
    real = T.init_params(cfg, torch.Generator().manual_seed(0), train=True)
    meta = T.init_params(cfg, L.MetaGenerator(), train=True)
    assert _port_tree_any(meta) == _port_tree_any(real)
    assert all(x.device.type == "meta" for x in _leaves(meta))


def _leaves(tree):
    from repro_torch import tree as TR
    return TR.leaves(tree)


def _port_tree_any(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_tree_any(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_tree_any(v, f"{prefix}{i}/"))
        return out
    return {prefix: (tuple(tree.shape), tree.dtype)}


def test_deepseek_at_full_depth_costs_nothing():
    """671 B parameters on the meta device: built in seconds, no storage;
    the count is the config's."""
    cfg = get_config("deepseek-v3-671b")
    params = T.init_params(cfg, L.MetaGenerator())
    n = sum(x.numel() for x in _leaves(params))
    assert 6.0e11 < n < 7.0e11
    # count_params counts the matmul weights: the norms' scales on top
    assert 0 <= n - count_params(cfg) < 1e-3 * n


def _argument_bytes(arch, shape, **kw):
    """The bytes of the decode step's argument trees, counted apart from
    the dry-run: the served (cast) parameters, the cache, tokens and
    index."""
    import dataclasses
    cfg = get_config(arch)
    if kw.get("window_cache"):
        cfg = dataclasses.replace(cfg, window_cache=True)
    if kw.get("bf16_params"):
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    spec = TS.input_specs(cfg, shape)
    params = T.cast_params(cfg, T.init_params(cfg, L.MetaGenerator()))
    nbytes = lambda tree: sum(x.numel() * x.element_size()
                              for x in _leaves(tree))
    return (nbytes(params) + nbytes(spec["cache"]) + 4 * spec["tokens"].numel()
            + 8, spec)


def test_one_combo_end_to_end(tmp_path, capsys):
    """olmo-1b x decode_32k on one card, through the CLI: the record's
    fields, the counted FLOPs within FLOPS_BAR of the analytic model,
    the arguments equal to the trees' bytes, the decode cache aliased,
    and the op table of --keep-trace."""
    assert D.main(["--arch", "olmo-1b", "--shape", "decode_32k",
                   "--out", str(tmp_path), "--force", "--keep-trace"]) == 0
    rec = json.loads((tmp_path / "olmo-1b__decode_32k__card.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 1
    assert rec["mesh"] == "card" and rec["kind"] == "decode"
    assert rec["collectives"] == {"total_bytes": 0}
    assert rec["attention"] == "plain attend (meta)"
    assert "unfused" in rec["bytes_note"]
    ana = rec["analytic"]["flops_global"]
    assert abs(rec["flops_per_device"] / ana - 1.0) <= FLOPS_BAR
    mem = rec["memory"]
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "alias_size_in_bytes", "temp_size_in_bytes",
                        "peak_size_in_bytes"}
    args, spec = _argument_bytes("olmo-1b", "decode_32k")
    assert mem["argument_size_in_bytes"] == args
    cache = sum(x.numel() * x.element_size()
                for x in _leaves(spec["cache"]))
    assert mem["alias_size_in_bytes"] == cache
    cfg = get_config("olmo-1b")
    logits = 128 * cfg.vocab * 2          # (B, V) bf16
    assert mem["output_size_in_bytes"] == cache + logits
    assert mem["peak_size_in_bytes"] == (mem["argument_size_in_bytes"]
                                         + mem["temp_size_in_bytes"]
                                         + mem["output_size_in_bytes"]
                                         - mem["alias_size_in_bytes"])
    assert mem["temp_size_in_bytes"] > 0
    assert rec["bytes_per_device"] >= cache
    assert rec["model_flops_global"] == D.model_flops(cfg, "decode", 128, 1)
    table = json.loads((tmp_path / "olmo-1b__decode_32k__card.trace.json")
                       .read_text())
    assert {"op", "count", "flops", "bytes"} <= set(table[0])
    assert sum(r["flops"] for r in table) == rec["flops_per_device"]
    assert sum(r["bytes"] for r in table) == rec["bytes_per_device"]
    assert "[ok] olmo-1b x decode_32k x card" in capsys.readouterr().out


def test_ring_combo_counts_the_rings(tmp_path):
    """gemma3-12b x long_500k with --window-cache --bf16-params: its
    argument bytes are the bf16 weights and the ring cache, whose K/V
    bytes equal the JAX cost model's windowed `_cache_bytes` (the rings'
    positions on top), and far below the full caches."""
    rec = D.run_combo("gemma3-12b", "long_500k", "card", tmp_path,
                      force=True, bf16_params=True, window_cache=True,
                      tag="__ring")
    assert rec["status"] == "ok" and rec["options"]["window_cache"]
    assert (tmp_path / "gemma3-12b__long_500k__card__ring.json").exists()
    args, spec = _argument_bytes("gemma3-12b", "long_500k",
                                 window_cache=True, bf16_params=True)
    assert rec["memory"]["argument_size_in_bytes"] == args
    cfg = get_config("gemma3-12b")
    kv = sum(x.numel() * x.element_size() for k, x in
             _port_tree_leaves(spec["cache"]) if not k.endswith("pos"))
    assert kv == JR._cache_bytes(j_config("gemma3-12b"), 1, 524_288, True)
    assert kv < 0.2 * JR._cache_bytes(j_config("gemma3-12b"), 1, 524_288)
    assert rec["memory"]["alias_size_in_bytes"] == sum(
        x.numel() * x.element_size() for x in _leaves(spec["cache"]))
    # the local layers read their W = 1,024 slots, as the analytic model
    # counts min(window, S) keys
    assert cfg.sliding_window == 1024
    assert abs(rec["flops_per_device"] / rec["analytic"]["flops_global"]
               - 1.0) <= FLOPS_BAR


def _port_tree_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _port_tree_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _jax_spec_bytes(arch, shape, mesh_shape, fsdp=False, experts_2d=False):
    """A decode step's per-device argument bytes under JAX's specs: every
    leaf of JAX's parameter tree and cache (the port's dtypes: its cast
    parameters, its bf16 cache), the tokens P(batch_axes, None) and the
    index P(), each divided as JAX's spec on a stub mesh divides it."""
    import types

    from repro import sharding as JSH
    from repro.models import transformer as JT
    from test_torch_sharding_rules import jax_cache_counterpart, \
        jax_counterpart, port_leaves
    mesh = types.SimpleNamespace(shape=dict(mesh_shape),
                                 axis_names=tuple(mesh_shape))
    jc, tc = j_config(arch), get_config(arch)
    spec = TS.input_specs(tc, shape)
    gb, max_len = spec["global_batch"], spec["seq_len"]

    def local(shape, pspec):
        n = 1
        for d, ax in zip(shape, tuple(pspec)):
            k = 1
            for a in ((ax,) if isinstance(ax, str) else ax or ()):
                k *= mesh_shape[a]
            assert d % k == 0
            n *= d // k
        return n

    jp = jax.eval_shape(lambda: JT.init_params(jc, jax.random.key(0)))
    jps = JSH.param_specs(jc, mesh, jp, fsdp=fsdp, experts_2d=experts_2d)
    params = T.cast_params(tc, T.init_params(tc, L.MetaGenerator()))
    size = {}          # the JAX leaf's path -> the port's element size
    for path, leaf in port_leaves(params):
        size[jax_counterpart(tc, jps, path)[3]] = leaf.element_size()
    total = 0
    for kp, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        key = tuple(k.key for k in kp)
        if key in size:                 # deepseek's mtp: training only
            node = jps
            for k in key:
                node = node[k]
            total += local(leaf.shape, node) * size[key]
    jcache = jax.eval_shape(lambda: JT.init_cache(jc, gb, max_len))
    jcs = JSH.make_cache_specs(jc, mesh, jcache, gb)
    cache_bytes = 0
    for path, leaf in port_leaves(spec["cache"]):
        for want, shp in zip(jax_cache_counterpart(tc, jcs, path),
                             jax_cache_counterpart(tc, jcache, path)):
            cache_bytes += local(shp.shape, want) * leaf.element_size()
    b_ax = JSH.batch_axes(mesh, gb)
    tokens = local((gb, 1), (b_ax, None)) * 4
    return total + cache_bytes + tokens + 8


@pytest.mark.parametrize("argv", [
    ["--mesh", "single"], ["--mesh", "multi"], ["--fsdp"], ["--experts-2d"],
    ["--seq-shard"]])
def test_mesh_flags_run_on_the_fake_backend(tmp_path, argv):
    """olmo-1b x decode_32k on JAX's meshes through the CLI (a sharding
    option alone takes JAX's default mesh, single): a record per device
    whose argument bytes equal JAX's spec arithmetic, with the port's
    collectives counted (all-gather / all-reduce, result bytes, and
    their counts) and the options recorded."""
    assert D.main(["--arch", "olmo-1b", "--shape", "decode_32k",
                   "--out", str(tmp_path), "--force"] + argv) == 0
    mesh = "multi" if argv == ["--mesh", "multi"] else "single"
    rec = json.loads((tmp_path / f"olmo-1b__decode_32k__{mesh}.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["mesh"] == mesh
    assert rec["n_devices"] == (512 if mesh == "multi" else 256)
    shape = {"pod": 2, "data": 16, "model": 16} if mesh == "multi" else \
        {"data": 16, "model": 16}
    opts = {k: argv == [f"--{k.replace('_', '-')}"]
            for k in ("fsdp", "experts_2d", "seq_shard")}
    assert {k: rec["options"][k] for k in opts} == opts
    assert rec["memory"]["argument_size_in_bytes"] == _jax_spec_bytes(
        "olmo-1b", "decode_32k", shape, fsdp=opts["fsdp"],
        experts_2d=opts["experts_2d"])
    coll = rec["collectives"]
    assert coll["total_bytes"] > 0 and coll["all-reduce_count"] > 0
    assert coll["total_bytes"] == sum(v for k, v in coll.items()
                                      if not k.endswith("_count")
                                      and k != "total_bytes")
    assert "not XLA's" in rec["collectives_note"]
    # one card's step on a 256th of the batch and 16ths of the weights
    card = D.run_combo("olmo-1b", "decode_32k", "card", tmp_path,
                       force=True)
    assert rec["flops_per_device"] < card["flops_per_device"] / 16


def test_card_mesh_refuses_sharding_options(tmp_path):
    with pytest.raises(ValueError, match="--mesh single or multi"):
        D.run_combo("olmo-1b", "decode_32k", "card", tmp_path, fsdp=True)
    assert not list(tmp_path.glob("*.json"))


def test_toy_collectives_are_hand_counted():
    """Two layers of a toy dense model, a forward over 2 x 8 tokens on a
    (data=2, model=2) fake mesh, by hand: the batch splits over "data"
    (1 sequence a device); heads, d_ff and the vocab over "model". Per
    layer the attention's and the MLP's row-split products each leave a
    partial (1, 8, 64) fp32 sum, all-reduced over "model" before the
    residual add; the lookup in the vocab-split embedding table, each
    rank its rows, leaves one more: 5 all-reduces of 8 x 64 x 4 = 2,048
    bytes. The logits stay split over the vocab, and nothing else
    moves."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch import sharding as SH
    cfg = dataclasses.replace(
        get_reduced_config("olmo-1b", dtype="float32"), n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        params = T.init_params(cfg, L.MetaGenerator())
        params = SH.distribute_tree(mesh, params, SH.param_specs(
            cfg, mesh, params))
        tokens = SH.distribute_tree(
            mesh, {"t": torch.empty((2, 8), dtype=torch.int64,
                                    device="meta")},
            {"t": ("data", None)})["t"]
        constrain = SH.make_constrainer(mesh, 2, vocab=cfg.vocab)
        counter = D.StepCounter()
        with counter, implicit_replication():
            logits, _ = T.forward(cfg, params, tokens, backend="reference",
                                  mesh=mesh, constrain=constrain)
    finally:
        dist.destroy_process_group()
    assert counter.collectives == {"all-reduce": 5 * 8 * 64 * 4,
                                   "all-reduce_count": 5}
    assert tuple(logits.to_local().shape) == (1, 8, 128)


def test_split_kv_combine_equals_one_softmax():
    """The dry-run's attention over keys split along their rows
    (`layers._split_kv`'s partials and combine) on plain tensors: two
    halves of the keys combined equal one softmax over all of them."""
    torch.manual_seed(0)
    q, k, v = (torch.randn(2, 3, 4, 8), torch.randn(2, 10, 2, 8),
               torch.randn(2, 10, 2, 8))
    qp = torch.tensor([[7, 8, 9]] * 2)
    kp = torch.arange(10).expand(2, 10)
    want = L._attend_block(q, k, v, qp, kp, L.NO_WINDOW, 0.0, True)
    part = L._attend_partial(L.NO_WINDOW, 0.0, True)
    outs = [part(q, k[:, i:i + 5], v[:, i:i + 5], qp, kp[:, i:i + 5])
            for i in (0, 5)]
    top = torch.maximum(outs[0][1], outs[1][1])
    sc = [torch.exp(o[1] - top) for o in outs]
    den = sum(o[2] * c for o, c in zip(outs, sc))
    got = sum(o[0] * c[..., None] for o, c in zip(outs, sc)) / den[..., None]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_all_sweeps_every_shape_and_resumes(tmp_path, monkeypatch, capfd):
    """--all over one architecture, its combos in spawned processes: a
    record per shape (long_500k skipped by design for olmo-1b), then a
    second run skips what exists."""
    monkeypatch.setattr(D, "ARCH_IDS", ["olmo-1b"])
    assert D.main(["--all", "--out", str(tmp_path)]) == 0
    recs = [json.loads(f.read_text()) for f in sorted(tmp_path.glob("*.json"))]
    assert sorted(r["status"] for r in recs) == ["ok"] * 3 + ["skipped"]
    train = next(r for r in recs if r["shape"] == "train_4k")
    assert train["kind"] == "train"
    # the fp32 masters and the two fp32 moments are the arguments; the
    # step updates all three in place
    n = sum(x.numel() for x in _leaves(T.init_params(
        get_config("olmo-1b"), L.MetaGenerator(), train=True)))
    mem = train["memory"]
    assert mem["alias_size_in_bytes"] == 12 * n + 4   # + the step count
    assert mem["argument_size_in_bytes"] == 12 * n + 4 + 2 * 256 * 4096 * 4
    assert train["flops_per_device"] > train["analytic"]["flops_global"] / 2
    capfd.readouterr()
    assert D.main(["--all", "--out", str(tmp_path)]) == 0
    assert capfd.readouterr().out.count("[skip]") == 4


def test_step_counter_counts_a_storage_once():
    """The live-storage count: a view adds nothing, a new result adds its
    storage, a released one leaves the count, the peak stays."""
    import gc
    counter = D.StepCounter()
    a = torch.empty(1000, device="meta")
    counter.hold(a)
    with counter:
        b = a.view(10, 100)
        c = b * 2
        assert counter.live == 8000
        del c
        gc.collect()
        assert counter.live == 4000
        d = a[:10] + 1
    assert counter.peak == 8000 and counter.live == 4040
    assert counter.bytes == (4000 + 4000) + (40 + 40)
    assert counter.ops["mul"]["count"] == 1 and counter.ops["view"]["bytes"] \
        == 0
    del d
