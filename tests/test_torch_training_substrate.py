"""The training substrate of the port against the JAX package, on the
CPU: the masked loss, remat, the synthetic corpus, checkpoints (the JAX
layout, bf16 and int32 leaves, both packages reading each other's
files), `init_params`' mtp head, `compute_tree` and `launch/train.py`.
AdamW over the model tree is `test_torch_training_optim.py`.

Bars: the masked loss and its gradients as
`test_torch_training_grads.py`; remat, the corpus and checkpoints exact.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_training_common import (GRAD_ATOL, METRIC_RTOL,
                                    assert_trees_close, batch_np, configs,
                                    init_jax, port_grads, port_tree,
                                    to_jax, to_torch)
from repro.models import transformer as JT
from repro.training import checkpoint as JCKPT
from repro.training import loop as JL
from repro_torch import tree as TR
from repro_torch.configs import ARCH_IDS, get_reduced_config
from repro_torch.launch import train as TLAUNCH
from repro_torch.models import transformer as TT
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import loop as TL
from repro_torch.training.optim import AdamW

jax.config.update("jax_platform_name", "cpu")


def test_masked_targets_match_jax():
    """targets < 0 are left out of the cross entropy, in the metrics and
    the gradients, as the JAX loss_fn masks them."""
    cfg_j, cfg_t = configs("qwen3-8b")
    pj = init_jax(cfg_j)
    bn = batch_np(cfg_j, seed=5)
    bn["targets"][0, :5] = -1
    bn["targets"][1, -3:] = -7
    (_, mj), gj = jax.value_and_grad(
        lambda p: JT.loss_fn(cfg_j, p, to_jax(bn)), has_aux=True)(pj)
    mt, gt = port_grads(cfg_t, port_tree(cfg_t, pj), to_torch(bn))
    for k in mj:
        np.testing.assert_allclose(mt[k], float(mj[k]), rtol=METRIC_RTOL)
    assert_trees_close(gt, port_tree(cfg_t, gj), 0.0, GRAD_ATOL, "masked")


def _remat_count(cfg):
    """Block calls a training forward rematerialises: each attention
    layer, encoder block, mamba2 block and hybrid group."""
    if cfg.arch_type == "hybrid":
        g, per, tail = TT.hybrid_shape(cfg)
        return g + g * per + tail
    return cfg.n_layers + (cfg.n_enc_layers if cfg.arch_type == "encdec"
                           else 0)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_gives_the_same_gradients(arch, monkeypatch):
    """cfg.remat wraps every block call of a training forward in
    `torch.utils.checkpoint` (counted), and the gradients are equal bit
    for bit to those without it; the serving forward never remats."""
    calls = []
    real = TT.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)
    monkeypatch.setattr(TT, "checkpoint", counting)
    grads = []
    for remat in (False, True):
        cfg = get_reduced_config(arch, dtype="float32", remat=remat)
        p = TT.init_params(cfg, torch.Generator().manual_seed(0),
                           train=True)
        masters = TR.leaves(p)
        for x in masters:
            x.requires_grad_(True)
        total, _ = TT.loss_fn(cfg, p, to_torch(batch_np(cfg)))
        # the forward's calls (the backward recomputes a hybrid group's
        # inner ones again)
        assert len(calls) == (_remat_count(cfg) if remat else 0)
        grads.append(torch.autograd.grad(total, masters))
        for x in masters:
            x.requires_grad_(False)
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    calls.clear()
    TT.forward(cfg, p, to_torch(batch_np(cfg))["tokens"],
               **{k: v for k, v in to_torch(batch_np(cfg)).items()
                  if k in ("enc_embeds", "img_embeds")})
    assert calls == []


def test_synthetic_batches_equal_jax():
    cfg_j, cfg_t = configs("olmo-1b")
    jb = JL.synthetic_lm_batches(cfg_j, 3, 20, seed=11)
    tb = TL.synthetic_lm_batches(cfg_t, 3, 20, seed=11, device="cpu")
    for _ in range(4):
        bj, bt = next(jb), next(tb)
        assert bt["tokens"].shape == (3, 20)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]))


def _mixed_tree():
    """fp32, bf16 and int32 leaves in a nested dict and list."""
    g = torch.Generator().manual_seed(4)
    return {"params": {"w": torch.randn(3, 5, generator=g),
                       "blocks": [{"s": torch.randn(4, generator=g)
                                   .to(torch.bfloat16)},
                                  {"s": torch.randn(4, generator=g)
                                   .to(torch.bfloat16)}]},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "m": torch.randn(2, 2, generator=g)
                    .to(torch.bfloat16)}}


def test_checkpoint_round_trip_and_latest_step(tmp_path):
    tree = _mixed_tree()
    CKPT.save(tmp_path / "step_3.npz", tree, step=3)
    CKPT.save(tmp_path / "step_12.npz", tree, step=12)
    (tmp_path / "step_x.npz").write_bytes(b"")
    assert CKPT.latest_step(tmp_path) == 12
    assert CKPT.latest_step(tmp_path / "none") is None
    like = TR.map_tree(torch.zeros_like, tree)
    got = CKPT.restore(tmp_path / "step_12.npz", like)
    assert TR.describe(got) == TR.describe(tree)
    for a, b in zip(TR.leaves(got), TR.leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with np.load(tmp_path / "step_3.npz") as z:
        meta = json.loads(str(z["__meta__"]))
        assert meta["step"] == 3 and meta["n_leaves"] == 5
        assert sorted(meta["dtypes"]) == ["bfloat16"] * 3 + ["float32",
                                                              "int32"]
        assert z["leaf_0"].dtype == np.uint16
    wrong = {"params": like["params"]}
    with pytest.raises(ValueError):
        CKPT.restore(tmp_path / "step_3.npz", wrong)


def test_checkpoints_read_across_the_packages(tmp_path):
    """A flat tree's file written by either package is read by the other
    (the same .npz layout, the bf16 bits as uint16)."""
    g = torch.Generator().manual_seed(2)
    tree = {"a": torch.randn(2, 3, generator=g),
            "b": torch.randn(5, generator=g).to(torch.bfloat16),
            "step": torch.tensor(4, dtype=torch.int32)}
    CKPT.save(tmp_path / "port.npz", tree, step=4)
    like_j = {"a": jnp.zeros((2, 3)), "b": jnp.zeros(5, jnp.bfloat16),
              "step": jnp.zeros((), jnp.int32)}
    got_j = JCKPT.restore(tmp_path / "port.npz", like_j)
    for k in tree:
        np.testing.assert_array_equal(
            np.asarray(got_j[k], np.float32), tree[k].float().numpy())
    JCKPT.save(tmp_path / "jax.npz", got_j, step=4)
    got_t = CKPT.restore(tmp_path / "jax.npz",
                         TR.map_tree(torch.zeros_like, tree))
    for k in tree:
        assert torch.equal(got_t[k], tree[k])


def test_init_params_draws_the_mtp_head_only_to_train():
    """deepseek's serving init holds no mtp head (its memory does not
    grow); the training init draws it last, the rest unchanged."""
    cfg = get_reduced_config("deepseek-v3-671b")
    served = TT.init_params(cfg, torch.Generator().manual_seed(1))
    trained = TT.init_params(cfg, torch.Generator().manual_seed(1),
                             train=True)
    assert "mtp" not in served and "mtp" in trained
    d = cfg.d_model
    assert trained["mtp"]["proj"].shape == (2 * d, d)
    for a, b in zip(TR.leaves(served),
                    TR.leaves({k: v for k, v in trained.items()
                               if k != "mtp"})):
        assert torch.equal(a, b)
    cast = TT.cast_params(cfg, trained)
    assert cast["mtp"]["proj"].dtype == torch.bfloat16
    assert cast["mtp"]["block"]["attn"]["w_dq"].dtype == torch.bfloat16
    assert cast["mtp"]["norm_h"]["scale"].dtype == torch.float32


def test_compute_tree_casts_a_copy_and_passes_gradients():
    cfg = get_reduced_config("phi3.5-moe-42b-a6.6b")     # bf16 compute
    p = TT.init_params(cfg, torch.Generator().manual_seed(0))
    c = TT.compute_tree(cfg, p)
    assert p["embed"].dtype == torch.float32
    assert c["embed"].dtype == torch.bfloat16
    assert c["blocks"][1]["ffn"]["router"].dtype == torch.float32
    assert c["blocks"][0]["attn_norm"]["scale"] is \
        p["blocks"][0]["attn_norm"]["scale"]
    _, grads = port_grads(cfg, p, to_torch(batch_np(cfg)))
    for g, x in zip(TR.leaves(grads), TR.leaves(p)):
        assert g.dtype == x.dtype == torch.float32
        assert torch.isfinite(g).all()


def test_train_step_hands_back_parameters_that_need_no_grad():
    """make_train_step turns on requires_grad for the masters only for its
    backward: the parameters it returns (and the ones it took) serve as
    they are, under grad mode, through forward and prefill."""
    cfg = get_reduced_config("olmo-1b")
    p = TT.init_params(cfg, torch.Generator().manual_seed(0), train=True)
    opt = AdamW(lr=1e-3)
    step = TL.make_train_step(cfg, opt)
    batch = next(TL.synthetic_lm_batches(cfg, 2, 16, seed=0, device="cpu"))
    new, _, _ = step(p, opt.init(p), batch)
    assert not any(x.requires_grad for x in TR.leaves(p) + TR.leaves(new))
    served = TT.cast_params(cfg, TR.map_tree(lambda x: x.clone(), new))
    logits, _ = TT.forward(cfg, served, batch["tokens"])
    assert logits.grad_fn is None and torch.isfinite(logits).all()


def test_launcher_trains_reduced_on_the_cpu(capsys, tmp_path):
    out = TLAUNCH.main(["--arch", "olmo-1b", "--reduced", "--steps", "20",
                        "--batch", "4", "--seq", "32", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path), "--ckpt-every", "10"])
    text = capsys.readouterr().out
    assert "training olmo-1b (dense)" in text
    assert "(improved)" in text, text
    assert [s for s, _ in out["history"]] == [0, 10, 19]
    assert CKPT.latest_step(tmp_path) == 20
    like = {"params": out["params"], "opt": out["opt_state"]}
    got = CKPT.restore(tmp_path / "step_20.npz", like)
    for a, b in zip(TR.leaves(got), TR.leaves(like)):
        assert torch.equal(a, b.detach())


def test_launcher_refuses_what_one_card_or_the_corpus_lacks():
    # the pod mesh needs a world of 256 ranks (torchrun): none here
    with pytest.raises(RuntimeError, match="needs 256 ranks.*torchrun"):
        TLAUNCH.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu",
                      "--production-mesh"])
    with pytest.raises(ValueError, match="enc_embeds"):
        TLAUNCH.main(["--arch", "whisper-large-v3", "--reduced",
                      "--device", "cpu"])
