"""AdamW over the model's tree against the JAX package's, on the CPU: one
step from zero gradients with weight decay on, every family (JAX decays
every leaf of its stacked layers, whatever its rank here), the decay
flags of the unstacked leaves, the global norm's leaf order, and the
baselines' flat-dict API.

Bar: the zero-gradient step within 1e-6 relative (it moves a decayed
leaf by lr * wd = 1e-3 of itself, so the bar tells a decayed leaf from a
kept one 1000 times over).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_training_common import (assert_trees_close, configs, init_jax,
                                    port_tree)
from repro.models import transformer as JT
from repro.training.optim import AdamW as JAdamW
from repro_torch import tree as TR
from repro_torch.configs import ARCH_IDS, get_reduced_config
from repro_torch.models import transformer as TT
from repro_torch.training.optim import AdamW

jax.config.update("jax_platform_name", "cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_zero_gradient_step_decays_as_jax(arch):
    """One AdamW step with zero gradients moves exactly the decayed
    leaves, by lr * wd of themselves: JAX decays every leaf of its
    stacked layers (norm scales, qk-norms, mamba2's A_log / D / dt_bias
    among them, 1-D here) and the unstacked leaves of two or more
    dimensions; the port's `decay_flags` says the same leaf by leaf."""
    cfg_j, cfg_t = configs(arch)
    pj = init_jax(cfg_j)
    pt = port_tree(cfg_t, pj)
    before = TR.map_tree(torch.clone, pt)
    jopt, topt = JAdamW(lr=1e-2), AdamW(lr=1e-2)
    zj = jax.tree.map(jnp.zeros_like, pj)
    new_j, _ = jax.jit(jopt.update)(zj, jopt.init(pj), pj)
    new_t, _ = topt.update(TR.map_tree(torch.zeros_like, pt),
                           topt.init(pt), pt, decay=TT.decay_flags(pt))
    want = port_tree(cfg_t, new_j)
    moved_t = [not torch.equal(a, b) for a, b in
               zip(TR.leaves(new_t), TR.leaves(before))]
    moved_j = [not torch.equal(a, b) for a, b in
               zip(TR.leaves(want), TR.leaves(before))]
    assert moved_t == moved_j
    flags = TR.leaves(TT.decay_flags(pt))
    assert moved_t == [f and bool(p.any()) for f, p in
                       zip(flags, TR.leaves(before))]
    assert_trees_close(new_t, want, 1e-6, 0.0, f"{arch} decayed params")


def test_decay_flags_follow_the_jax_layout():
    """Stacked leaves are decayed whatever their rank here; the unstacked
    ones by rank (zamba2's shared block, deepseek's mtp head)."""
    for arch, probe in (("zamba2-7b", "shared_attn"),
                        ("deepseek-v3-671b", "mtp")):
        cfg = get_reduced_config(arch)
        p = TT.init_params(cfg, torch.Generator().manual_seed(0),
                           train=True)
        flags = TT.decay_flags(p)
        stack = p["groups"][0][0] if arch == "zamba2-7b" else p["blocks"][0]
        stack_flags = flags["groups"][0][0] if arch == "zamba2-7b" \
            else flags["blocks"][0]
        assert all(TR.leaves(stack_flags))
        assert any(x.ndim == 1 for x in TR.leaves(stack))
        for f, x in zip(TR.leaves(flags[probe]), TR.leaves(p[probe])):
            assert f == (x.ndim >= 2)
        assert flags["final_norm"]["scale"] is False
        assert flags["embed"] is True


@pytest.mark.parametrize("arch", ["olmo-1b", "whisper-large-v3",
                                  "zamba2-7b", "llava-next-mistral-7b"])
def test_global_norm_takes_the_jax_leaf_order(arch):
    """`tree.stacked_order` of the port's tree lists the entries of JAX's
    stacked leaves in JAX's flatten order: each JAX leaf filled with its
    own running index, carried across, reads back 0, 1, 2, ... (the moe
    family's one list of blocks is JAX's two stacks: not mapped)."""
    cfg_j, cfg_t = configs(arch)
    shapes = jax.eval_shape(lambda k: JT.init_params(cfg_j, k),
                            jax.random.key(0))
    leaves, treedef = jax.tree.flatten(shapes)
    filled = []
    for s in leaves:
        filled.append(np.full(s.shape, float(len(filled)), np.float32))
    pt = port_tree(cfg_t, jax.tree.unflatten(treedef, filled))
    order = [float(x.reshape(-1)[0]) for x in TR.stacked_order(pt)]
    assert order == sorted(order)
    assert sorted(set(order)) == [float(i) for i in range(len(leaves))]


def test_adamw_keeps_the_flat_dict_api():
    """The baselines' flat dict of tensors: the tree API with no decay
    flags decays the matrices, as before."""
    p = {"w": torch.ones(2, 3), "b": torch.ones(3)}
    opt = AdamW(lr=0.1)
    st = opt.init(p)
    assert set(st["m"]) == {"w", "b"}
    opt.update({"w": torch.zeros(2, 3), "b": torch.zeros(3)}, st, p)
    assert torch.allclose(p["w"], torch.full((2, 3), 1 - 0.1 * 0.1))
    assert torch.equal(p["b"], torch.ones(3))
    assert int(st["step"]) == 1
