"""The port's dry-run analogue against the JAX package's, on the CPU:
`configs/shapes.py` (SHAPES, supports, input_specs), the analytic cost
model (`analysis/roofline_model.py`, pure Python: equal to the last
bit), and `launch/dryrun.py` on the meta device.

The JAX dry-run itself needs 512 forced host devices
(`tests/test_dryrun.py`); here only its pure-Python pieces run
(`model_flops`, `input_specs` under `jax.eval_shape`).

Bar for the counted FLOPs: a decode step's FLOPs, counted on the meta
device by `FlopCounterMode`, within 1% of `analytic_costs` (olmo-1b x
decode_32k: the matmuls, the attention's two products over every cache
row and the logits, which both count the same way).
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


@pytest.mark.parametrize("argv", [
    ["--mesh", "single"], ["--mesh", "multi"], ["--fsdp"], ["--experts-2d"],
    ["--seq-shard"]])
def test_flags_that_need_a_mesh_raise(tmp_path, argv):
    with pytest.raises(NotImplementedError, match="ROADMAP §2.10"):
        D.main(["--arch", "olmo-1b", "--shape", "decode_32k",
                "--out", str(tmp_path)] + argv)
    with pytest.raises(NotImplementedError, match="ROADMAP §2.10"):
        D.run_combo("olmo-1b", "decode_32k", argv[1] if argv[0] == "--mesh"
                    else "card", tmp_path, fsdp=argv == ["--fsdp"],
                    experts_2d=argv == ["--experts-2d"],
                    seq_shard=argv == ["--seq-shard"])
    assert not list(tmp_path.glob("*.json"))


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
