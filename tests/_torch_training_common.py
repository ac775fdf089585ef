"""Shared pieces of the training parity tests (`test_torch_training_*.py`):
the ten reduced configs of both packages in fp32, the JAX initial weights
carried across by `convert`, batches of one seed for both (encdec and vlm
with their frame / image embeddings, as `test_smoke_archs._batch_for`
builds them), and the two checks each file runs over its archs."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_reduced_config as j_reduced
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch import tree as TR
from repro_torch.configs import get_reduced_config as t_reduced

jax.config.update("jax_platform_name", "cpu")


def configs(arch, **kw):
    """(JAX config, port config), reduced, fp32 compute."""
    kw = {"dtype": "float32", **kw}
    return j_reduced(arch, **kw), t_reduced(arch, **kw)


def batch_np(cfg, b=2, s=16, seed=0):
    """A batch of host arrays: tokens, targets, and encdec's enc_embeds /
    vlm's img_embeds (its text s - n_image_tokens long)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.arch_type == "vlm":
        s_text = s - cfg.n_image_tokens
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s_text))
        out["img_embeds"] = rng.normal(
            size=(b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
        out["targets"] = rng.integers(0, cfg.vocab, (b, s_text))
    elif cfg.arch_type == "encdec":
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s))
        out["enc_embeds"] = rng.normal(
            size=(b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
        out["targets"] = rng.integers(0, cfg.vocab, (b, s))
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s))
        out["targets"] = rng.integers(0, cfg.vocab, (b, s))
    return out


def to_jax(batch):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i"
                           else jnp.float32) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.tensor(v, dtype=torch.int64 if v.dtype.kind == "i"
                            else torch.float32) for k, v in batch.items()}


def with_embeds(cfg, tokens_batch, seed):
    """A synthetic text batch (host arrays) with the frame / image
    embeddings its family's forward needs, drawn from `seed`."""
    out = dict(tokens_batch)
    rng = np.random.default_rng(seed)
    if cfg.arch_type == "encdec":
        out["enc_embeds"] = rng.normal(
            size=(out["tokens"].shape[0], cfg.n_audio_frames,
                  cfg.d_model)).astype(np.float32)
    if cfg.arch_type == "vlm":
        out["img_embeds"] = rng.normal(
            size=(out["tokens"].shape[0], cfg.n_image_tokens,
                  cfg.d_model)).astype(np.float32)
    return out


def port_tree(cfg_t, jax_tree):
    """A JAX tree of the model's layout (parameters, gradients) in the
    port's layout, as fp32 CPU tensors."""
    return convert.model_params_from_numpy(cfg_t, jax_tree, device="cpu")


def assert_trees_close(got, want, rtol, atol_scale, what):
    """Every leaf of `got` within rtol of `want`'s, and within atol_scale
    times the largest |value| of that leaf of `want` (a gradient leaf's
    scale varies by orders of magnitude across leaves)."""
    gl, wl = TR.leaves(got), TR.leaves(want)
    assert TR.describe(got) == TR.describe(want), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        scale = float(w.abs().max()) if w.numel() else 0.0
        torch.testing.assert_close(
            g.float(), w.float(), rtol=rtol, atol=atol_scale * scale,
            msg=lambda m: f"{what}, leaf {i}: {m}")


# ---------------------------------------------------------------------------
# The parity checks, each over one arch (the test files split the ten
# archs between them: the suite's workers take whole files)
# ---------------------------------------------------------------------------

#: loss metrics: fp32 over the same weights and batch; the worst family
#: reads 6e-7 relative (zamba2's ce), a few ulp of the summed log-probs
METRIC_RTOL = 2e-6
#: gradients: every leaf within this fraction of its own largest |value|
#: (leaf scales span orders of magnitude); the worst family reads 6.6e-6
#: (zamba2: the SSD's fp32 cumsum and exp panels, summed in another
#: order than XLA's)
GRAD_ATOL = 2e-5
#: 5 AdamW steps (lr 1e-3): the ce history as the metrics (worst 6.1e-7,
#: deepseek); the parameters within this fraction of each leaf's largest
#: |value|: Adam normalises near-zero gradient entries (ROADMAP §4.9), so
#: an entry whose gradient rounds to the other sign moves lr the other
#: way; the worst family reads 2.1e-4 (zamba2), against the 5e-3 that 5
#: steps of lr 1e-3 move an entry
STEP_ATOL = 5e-4
LR = 1e-3
STEPS = 5


def init_jax(cfg_j, seed=0):
    """JAX's initial weights, jitted (the eager init of the reduced
    deepseek takes 12 s here; the jitted draw differs in the last bits,
    and is JAX's own all the same)."""
    return jax.jit(JT.init_params, static_argnums=0)(cfg_j,
                                                     jax.random.key(seed))


def port_grads(cfg_t, params, batch):
    """(metrics as floats, gradient tree) of the port's loss_fn."""
    from repro_torch.models import transformer as TT
    masters = TR.leaves(params)
    for p in masters:
        p.requires_grad_(True)
    total, metrics = TT.loss_fn(cfg_t, params, batch)
    grads = torch.autograd.grad(total, masters)
    for p in masters:
        p.requires_grad_(False)
    return ({k: float(v.detach()) for k, v in metrics.items()},
            TR.unflatten(params, grads))


def check_loss_and_grads(arch):
    """loss_fn's metrics and every gradient leaf against jax.grad of the
    JAX loss_fn, from the same weights and batch."""
    cfg_j, cfg_t = configs(arch)
    pj = init_jax(cfg_j)
    pt = port_tree(cfg_t, pj)
    bn = batch_np(cfg_j)
    (_, mj), gj = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(cfg_j, p, b), has_aux=True))(pj, to_jax(bn))
    mt, gt = port_grads(cfg_t, pt, to_torch(bn))
    assert sorted(mt) == sorted(mj)
    if cfg_t.arch_type == "moe":
        assert mt["aux"] > 0
    for k in mj:
        np.testing.assert_allclose(mt[k], float(mj[k]), rtol=METRIC_RTOL,
                                   err_msg=f"{arch} {k}")
    assert_trees_close(gt, port_tree(cfg_t, gj), 0.0, GRAD_ATOL,
                       f"{arch} gradients")


def check_train_steps(arch):
    """STEPS steps of both packages' make_train_step from the same
    weights on the same synthetic batches (their integers equal): the
    metric histories and the final parameters."""
    from repro.training import loop as JL
    from repro.training.optim import AdamW as JAdamW
    from repro_torch.training import loop as TL
    from repro_torch.training.optim import AdamW as TAdamW
    cfg_j, cfg_t = configs(arch)
    pj = init_jax(cfg_j)
    pt = port_tree(cfg_t, pj)
    jopt, topt = JAdamW(lr=LR), TAdamW(lr=LR)
    js, ts = jopt.init(pj), topt.init(pt)
    jstep = jax.jit(JL.make_train_step(cfg_j, jopt))
    tstep = TL.make_train_step(cfg_t, topt)
    jdata = JL.synthetic_lm_batches(cfg_j, 2, 16, seed=3)
    tdata = TL.synthetic_lm_batches(cfg_t, 2, 16, seed=3, device="cpu")
    for i in range(STEPS):
        bj, bt = next(jdata), next(tdata)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]))
        bn = with_embeds(cfg_j, {k: np.asarray(v) for k, v in bj.items()},
                         seed=i)
        pj, js, mj = jstep(pj, js, to_jax(bn))
        pt, ts, mt = tstep(pt, ts, to_torch(bn))
        assert sorted(mt) == sorted(mj)
        for k in mj:
            np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                       rtol=METRIC_RTOL,
                                       err_msg=f"{arch} step {i} {k}")
    assert int(ts["step"]) == int(js["step"]) == STEPS
    assert_trees_close(TR.map_tree(torch.Tensor.detach, pt),
                       port_tree(cfg_t, pj), 0.0, STEP_ATOL,
                       f"{arch} parameters after {STEPS} steps")
