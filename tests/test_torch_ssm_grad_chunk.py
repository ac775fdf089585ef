"""A defect of the reference, pinned: the JAX package's mamba2 gradient is
non-finite once a sequence fills an SSD chunk (reduced mamba2-780m:
ssm_chunk = 32), while the port's stays finite and equals JAX's on every
leaf JAX gets finite (ROADMAP §4).

The cause (`src/repro/models/ssm.py:99-102`): the intra-chunk decay
L[i, j] = exp(csum_i - csum_j) is taken on the full (Q, Q) panel and the
upper triangle masked afterwards by `jnp.where`. There csum_i - csum_j >
0 (a_log < 0), and over a chunk of 32 steps it passes fp32's exp range:
exp gives inf, the forward's `where` drops it, but the backward's
cotangent of the dropped branch is 0, and 0 * inf is NaN. At S = 16 the
chunk is 16 steps and stays in range. The port masks before the
exponential (`masked_fill(-inf)` then `exp`: `repro_torch/models/ssm.py`),
whose backward sees exp(-inf) = 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_training_common import (GRAD_ATOL, METRIC_RTOL, batch_np,
                                    configs, init_jax, port_grads,
                                    port_tree, to_jax, to_torch)
from repro.models import transformer as JT
from repro_torch import tree as TR

jax.config.update("jax_platform_name", "cpu")


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, item in enumerate(tree):
            yield from _paths(item, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def test_where_over_an_overflowing_exp_has_a_nan_gradient():
    """The mechanism in isolation: the masked branch overflows, and its
    zero cotangent times exp's inf is NaN."""
    g = jax.grad(lambda x: jnp.where(False, jnp.exp(x), 0.0))(100.0)
    assert np.isnan(float(g))
    t = torch.tensor(100.0, requires_grad=True)
    torch.exp(t.masked_fill(torch.tensor(True), -float("inf"))).backward()
    assert float(t.grad) == 0.0


@pytest.mark.parametrize("s", [16, 32, 64])
def test_mamba2_gradient_across_an_ssd_chunk(s):
    cfg_j, cfg_t = configs("mamba2-780m")
    assert cfg_j.ssm_chunk == 32
    pj = init_jax(cfg_j)
    pt = port_tree(cfg_t, pj)
    bn = batch_np(cfg_j, b=2, s=s)
    (_, mj), gj = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(cfg_j, p, b), has_aux=True))(pj, to_jax(bn))
    mt, gt = port_grads(cfg_t, pt, to_torch(bn))
    for k in mj:
        np.testing.assert_allclose(mt[k], float(mj[k]), rtol=METRIC_RTOL)
    want = port_tree(cfg_t, gj)
    assert all(bool(torch.isfinite(g).all()) for g in TR.leaves(gt))
    bad = {path for path, g in _paths(want)
           if not bool(torch.isfinite(g).all())}
    if s == 16:
        assert not bad
    else:
        # both layers' per-head decay parameters and the B / C conv
        # streams, among others
        names = {p.split("/", 2)[-1] for p in bad}
        assert {"mamba/A_log", "mamba/D", "mamba/conv_B_w",
                "mamba/conv_C_w"} <= names, sorted(names)
    got = dict(_paths(gt))
    finite = [(p, w) for p, w in _paths(want) if p not in bad]
    assert len(finite) + len(bad) == len(got)
    for path, w in finite:
        torch.testing.assert_close(
            got[path].float(), w.float(), rtol=0,
            atol=GRAD_ATOL * float(w.abs().max()), msg=path)
