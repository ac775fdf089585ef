"""Subprocess worker for tests/test_torch_mesh_parity.py: the port's fleet
meshes, expert-parallel MoE and SPMD train step against the JAX package's
on a (data=2, model=2) mesh, on the CPU.

  python tests/_torch_mesh_worker.py jax OUT     (under XLA_FLAGS=
      --xla_force_host_platform_device_count=4) the JAX half: its mesh
      built with Auto axes in this file (the package's make_test_mesh
      gives Explicit axes, on which the sharded train step fails:
      ROADMAP §4), `apply_moe` at 8,320 tokens with its gradients, the
      unsharded call, 3 `make_train_step(mesh=)` steps a model;
  python tests/_torch_mesh_worker.py ranks OUT   the port's half: 4 gloo
      ranks (one torch thread each) on `make_test_mesh(2, 2, "cpu")`;
  python tests/_torch_mesh_worker.py fake OUT    the production meshes
      on the "fake" backend, and a world of 1 refused.

Each writes OUT/<half>.npz (arrays) and OUT/<half>.json (a report). The
MoE weights, tokens and cotangents come from one numpy seed on both
halves; the train steps start from JAX's jitted init
(`_torch_training_common.init_jax`: the JAX half draws it, and the port's
rank 0, which broadcasts it) on the batches of
`synthetic_lm_batches(seed=3)`.
"""
import json
import os
import sys
from pathlib import Path

import numpy as np

MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "deepseek-v3-671b")
#: 4 x 2080 = 8,320 tokens: above the expert-parallel threshold (8192)
MOE_SHAPE = (4, 2080)
#: the train steps' (arch, batch, seq)
TRAIN = (("olmo-1b", 4, 64), ("phi3.5-moe-42b-a6.6b", 4, 2080),
         ("deepseek-v3-671b", 4, 2080))
STEPS = 3
LR = 1e-3
#: the aux loss's weight in the MoE check's scalar
AUX_W = 0.5


def moe_inputs(cfg, seed=7):
    """One MoE layer's weights (with deepseek's shared experts), tokens
    and a cotangent for y, fp32, from numpy."""
    rng = np.random.default_rng(seed)
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.expert_ff
    f = lambda shape, s: (rng.normal(size=shape) * s).astype(np.float32)
    p = {"router": f((d, e), d ** -0.5), "w_gate": f((e, d, ff), d ** -0.5),
         "w_up": f((e, d, ff), d ** -0.5), "w_down": f((e, ff, d), ff ** -0.5)}
    if cfg.n_shared_experts:
        sff = ff * cfg.n_shared_experts
        p["shared"] = {"w_gate": f((d, sff), d ** -0.5),
                       "w_up": f((d, sff), d ** -0.5),
                       "w_down": f((sff, d), sff ** -0.5)}
    # a shared offset along expert 0's router column puts expert 0 in
    # most tokens' top k, past a batch shard's capacity
    r0 = p["router"][:, 0]
    x = f(MOE_SHAPE + (d,), 1.0) + 2.0 * r0 / np.linalg.norm(r0) ** 2
    cot = f(MOE_SHAPE + (d,), 1.0)
    return p, x, cot


def flat(tree, prefix=""):
    """{"a/b/c": array} of a nested dict of arrays; an empty dict and a
    None leaf (a norm without parameters, an empty layer stack) keep a
    marker key, so that `nest` rebuilds them."""
    out = {}
    for k, v in tree.items():
        if v is None:
            out[f"{prefix}{k}/{NONE}"] = np.zeros(0, np.float32)
        elif isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/") if v else
                       {f"{prefix}{k}/{EMPTY}": np.zeros(0, np.float32)})
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


NONE, EMPTY = "__none__", "__empty__"


def nest(arrays, prefix):
    """The nested dict of the arrays under `prefix` ("x/" -> tree)."""
    out = {}
    for k, v in arrays.items():
        if not k.startswith(prefix):
            continue
        parts = k[len(prefix):].split("/")
        node = out
        for i, p in enumerate(parts[:-1]):
            if parts[i + 1] == NONE:
                node[p] = None
                break
            node = node.setdefault(p, {})
        else:
            if parts[-1] != EMPTY:
                node[parts[-1]] = v
    return out


# ---------------------------------------------------------------------------
# the JAX half
# ---------------------------------------------------------------------------

def jax_half(out: Path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from _torch_training_common import init_jax
    from repro import sharding as SH
    from repro.configs import get_reduced_config
    from repro.launch.mesh import make_test_mesh
    from repro.models import moe as MOE
    from repro.training import loop as JL
    from repro.training.optim import AdamW

    jax.config.update("jax_platform_name", "cpu")
    report = {"n_devices": len(jax.devices()),
              "test_mesh_axis_types": [
                  t.name for t in make_test_mesh(2, 2).axis_types]}
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    arrays = {}
    for arch in MOE_ARCHS:
        cfg = get_reduced_config(arch, dtype="float32")
        p, x, cot = moe_inputs(cfg)

        def loss(x, p):
            y, aux = MOE.apply_moe(cfg, p, x, mesh)
            return jnp.sum(y * cot) + AUX_W * aux, (y, aux)

        (_, (y, aux)), (gx, gp) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(x, p)
        y0, aux0 = jax.jit(lambda x, p: MOE.apply_moe(cfg, p, x))(x, p)
        arrays.update({f"moe/{arch}/y": np.asarray(y),
                       f"moe/{arch}/aux": np.asarray(aux),
                       f"moe/{arch}/y_unsharded": np.asarray(y0),
                       f"moe/{arch}/aux_unsharded": np.asarray(aux0),
                       f"moe/{arch}/gx": np.asarray(gx)})
        arrays.update({f"moe/{arch}/gp/{k}": v for k, v in flat(gp).items()})

    report["metrics"] = {}
    for arch, b, s in TRAIN:
        cfg = get_reduced_config(arch, dtype="float32")
        params = init_jax(cfg)
        opt = AdamW(lr=LR)
        specs = SH.param_specs(cfg, mesh, params)
        params = jax.device_put(params, SH.tree_shardings(mesh, specs))
        state = opt.init(params)
        step = jax.jit(JL.make_train_step(cfg, opt, mesh=mesh))
        data = JL.synthetic_lm_batches(cfg, b, s, seed=3)
        hist = []
        for _ in range(STEPS):
            params, state, m = step(params, state, next(data))
            hist.append({k: float(v) for k, v in m.items()})
        report["metrics"][arch] = hist
        arrays.update({f"train/{arch}/{k}": v
                       for k, v in flat(jax.device_get(params)).items()})
    np.savez(out / "jax.npz", **arrays)
    (out / "jax.json").write_text(json.dumps(report))


# ---------------------------------------------------------------------------
# the port's half: 4 gloo ranks
# ---------------------------------------------------------------------------

def _rank(rank: int, world: int, init: str, out: str):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        _rank_body(rank, Path(out))
    finally:
        dist.destroy_process_group()


def _rank_body(rank: int, out: Path):
    import torch
    import torch.distributed as dist

    from _torch_training_common import configs, init_jax, port_tree
    from repro_torch import tree as TR
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.training import loop as TL
    from repro_torch.training.optim import AdamW

    mesh = make_test_mesh(model=2, data=2, device="cpu")
    data_g, model_g = mesh.get_group("data"), mesh.get_group("model")
    di, nb = mesh.get_local_rank("data"), 2
    arrays, report = {}, {"mesh": [list(mesh.mesh_dim_names),
                                   list(mesh.shape)],
                          "metrics": {}}

    def gather_rows(t):
        parts = [torch.empty_like(t) for _ in range(nb)]
        dist.all_gather(parts, t.contiguous(), group=data_g)
        return torch.cat(parts)

    for arch in MOE_ARCHS:
        cfg = get_reduced_config(arch, dtype="float32")
        p_np, x_np, cot_np = moe_inputs(cfg)
        tree = lambda: {k: (torch.tensor(v).requires_grad_(True)
                            if not isinstance(v, dict) else
                            {kk: torch.tensor(vv).requires_grad_(True)
                             for kk, vv in v.items()})
                        for k, v in p_np.items()}
        p = tree()
        k = MOE_SHAPE[0] // nb
        x = torch.tensor(x_np[di * k:(di + 1) * k]).requires_grad_(True)
        cot = torch.tensor(cot_np[di * k:(di + 1) * k])
        y, aux = MOE.apply_moe(cfg, p, x, mesh)
        # each rank's share of JAX's scalar: its rows, the aux's mean
        total = (y * cot).sum() + AUX_W * aux / nb
        leaves = TR.leaves(p)
        grads = torch.autograd.grad(total, [x] + leaves)
        experts = TR.leaves({k: TR.map_tree(lambda _: False, v)
                             if isinstance(v, dict) else k != "router"
                             for k, v in p.items()})
        gp = []
        for g, e in zip(grads[1:], experts):
            g = g.contiguous()
            if e:
                dist.all_reduce(g, group=model_g)
            dist.all_reduce(g, group=data_g)
            gp.append(g)
        aux_all = aux.detach().clone()
        dist.all_reduce(aux_all, group=data_g)
        with torch.no_grad():
            y0, aux0 = MOE.apply_moe(cfg, tree(), torch.tensor(x_np))
        arrays.update({f"moe/{arch}/y": gather_rows(y.detach()).numpy(),
                       f"moe/{arch}/aux": (aux_all / nb).numpy(),
                       f"moe/{arch}/gx": gather_rows(grads[0]).numpy(),
                       f"moe/{arch}/y_unsharded": y0.numpy(),
                       f"moe/{arch}/aux_unsharded": aux0.numpy()})
        arrays.update({f"moe/{arch}/gp/{k}": v for k, v in
                       flat(TR.unflatten(p, gp)).items()})

    from repro_torch.models import transformer as TT
    for arch, b, s in TRAIN:
        cfg_j, cfg_t = configs(arch)
        # JAX's initial weights, drawn on rank 0 and broadcast (each
        # rank's own draw would cost a JAX compile a rank)
        params = port_tree(cfg_t, init_jax(cfg_j)) if rank == 0 else \
            TT.init_params(cfg_t, torch.Generator(), train=True)
        for leaf in TR.leaves(params):
            dist.broadcast(leaf, src=0)
        opt = AdamW(lr=LR)
        state = opt.init(params)
        step = TL.make_train_step(cfg_t, opt, mesh=mesh)
        data = TL.synthetic_lm_batches(cfg_t, b, s, seed=3, device="cpu")
        hist = []
        for _ in range(STEPS):
            params, state, m = step(params, state, next(data))
            hist.append({k: float(v) for k, v in m.items()})
        report["metrics"][arch] = hist
        arrays.update({f"train/{arch}/{i}": leaf.numpy()
                       for i, leaf in enumerate(TR.leaves(params))})
    if rank == 0:
        np.savez(out / "ranks.npz", **arrays)
        (out / "ranks.json").write_text(json.dumps(report))


def ranks_half(out: Path):
    import socket

    import torch.multiprocessing as mp
    # JAX (rank 0 draws the initial weights) on one thread as well
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_cpu_multi_thread_eigen=false "
                               "intra_op_parallelism_threads=1").strip()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank, args=(4, f"tcp://localhost:{port}", str(out)),
             nprocs=4, join=True)


# ---------------------------------------------------------------------------
# the production meshes on the fake backend
# ---------------------------------------------------------------------------

def fake_half(out: Path):
    import socket

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh
    report = {}
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        make_production_mesh(device="cpu")
        report["world_1"] = "no error"
    except RuntimeError as e:
        report["world_1"] = str(e)
    dist.destroy_process_group()
    for multi, n in ((False, 256), (True, 512)):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
        m = make_production_mesh(multi_pod=multi, device="cpu")
        report["multi" if multi else "single"] = {
            "shape": list(m.shape), "names": list(m.mesh_dim_names),
            "model_group": dist.get_world_size(m.get_group("model"))}
        dist.destroy_process_group()
    (out / "fake.json").write_text(json.dumps(report))


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    half, out = sys.argv[1], Path(sys.argv[2])
    {"jax": jax_half, "ranks": ranks_half, "fake": fake_half}[half](out)
