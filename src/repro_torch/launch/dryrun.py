"""The dry-run: build every (arch x shape) step at full size on the meta
device, and count what it would cost on one card, or on each device of
the JAX package's meshes.

The counterpart of the JAX package's `launch/dryrun.py`, which lowers and
compiles each (arch x shape x mesh) on 512 forced host devices and reads
XLA's memory and cost analyses and the collective bytes of the HLO. The
port builds the same step the JAX dry-run lowers, on meta tensors
(shapes and dtypes, no storage: deepseek-v3's 671 B parameters cost
nothing), and runs it once under a dispatch mode that sees every aten op
(`StepCounter`):

  train_4k     -> `training.loop.make_train_step`: `transformer.loss_fn`
                  under autograd, then `AdamW.update` in place
  prefill_32k  -> `transformer.prefill`, into a fresh bf16 cache
  decode_32k,  -> `transformer.decode_step` on `configs.shapes.
  long_500k       input_specs`' bf16 cache, written in place

and records, per (arch x shape x mesh), per device:

  * flops_per_device: `torch.utils.flop_counter`'s formulas over the ops
    (matmuls, convolutions and attention products; the backward's
    included);
  * bytes_per_device: each op's operand and result bytes, summed over the
    ops that are not views or collectives. This is UNFUSED: every
    intermediate is written and read again, where XLA's count is over
    its fused HLO;
  * memory: argument_size_in_bytes (the step's input trees), the outputs
    (output_size_in_bytes) and those of them that are arguments updated
    in place (alias_size_in_bytes: the parameters and optimiser state,
    or the decode cache), peak_size_in_bytes (the most bytes of live
    storages during the step, the arguments included; a storage counts
    once across its views, each tracked from its creation to its
    release) and temp_size_in_bytes = peak - arguments - (outputs -
    aliases), as XLA's temp excludes the new outputs (so arguments +
    temp + outputs - aliases is the peak, as the JAX roofline reads it);
  * collectives: each kind's result bytes and count, and total_bytes;
  * model_flops_global (JAX's `model_flops`) and `analytic`
    (`analysis.roofline_model.analytic_costs`);
  * status ok / skipped / error, as the JAX `run_combo`.

The attention on the meta device is the plain `layers.attend` (the CUDA
kernels take no meta tensors): it computes the full S x S panel of each
query chunk under a mask, where the analytic model counts S/2 keys a
query at train and prefill. The served parameters are the cast tree
(`transformer.cast_params`: bf16 matrices, fp32 norms and router), as
FleetModel holds them; the train step's arguments are the fp32 masters.
`--bf16-params` makes every parameter bf16, `--opt-state-bf16` AdamW's
moments, and `--window-cache` gives a local:global stack ring caches for
its local layers (`transformer.ring_cache`).

`--mesh card` (the default) is one card: no collectives. `--mesh single`
((16, 16) data x model) and `--mesh multi` ((2, 16, 16) pod x data x
model) run the step over a "fake" process group of 256 or 512 ranks in
this process (`fake_mesh`; collectives are recorded, not run), every
argument a DTensor placed by the JAX rules (`sharding.py`, as the JAX
`build_step` places it; `mesh_arguments`), with `--fsdp`, `--experts-2d`
and `--seq-shard` as the JAX flags set them (alone they take JAX's
default mesh, single); JAX's `mesh=` and constrainer reach the model.
The counter sees each rank's local ops, so every number is one device's.
The collectives are the port's program's, not XLA's: DTensor's
redistributions (a row-split product reduced before its residual add,
`sharding.reduced`), the expert-parallel MoE's c10d calls, the
dry-run's attention over a cache whose rows are split over "model"
(flash-decoding style: `layers._split_kv`), and the cross entropy over a
split vocab (`transformer._cross_entropy_sharded`). The attention core
and the SSD scan run on each rank's batch rows and heads
(`sharding.run_sharded`): DTensor's own plan for their batched products
takes minutes to make on a 3-D mesh.

Results land in results/dryrun_torch/<arch>__<shape>__<mesh><tag>.json;
the roofline report (benchmarks_torch/roofline.py) reads them.
`--keep-trace` writes the table of ops (name, count, FLOPs, bytes)
beside each record.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape train_4k [--mesh single|multi] [--fsdp] [--experts-2d]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # resumable

`--all` counts its combos in parallel processes, one a core up to
MAX_WORKERS.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
import weakref
from concurrent.futures import ProcessPoolExecutor
from functools import partial
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import sharding as SH
from repro_torch.analysis.roofline_model import analytic_costs
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, input_specs, supports
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.training.loop import make_train_step
from repro_torch.training.optim import AdamW

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
MESHES = ("card", "single", "multi")
#: --all's processes at most (each a spawned interpreter of ~0.5 GB)
MAX_WORKERS = 8
ATTENTION = "plain attend (meta)"
BYTES_NOTE = ("unfused: the operand and result bytes of every aten op that "
              "is not a view or a collective (XLA counts its fused HLO)")
COLLECTIVES_NOTE = (
    "the port's program's collectives, not XLA's: DTensor's "
    "redistributions and the expert-parallel MoE's c10d calls, each "
    "one's result bytes on one device; on this cpu-typed mesh DTensor "
    "moves a shard between dims by an all-gather and a chunk where a "
    "CUDA mesh takes an all-to-all")


def model_flops(cfg, kind: str, global_batch: int, seq_len: int) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (inference fwd), N = active
    non-embedding params, D = tokens processed this step (the JAX
    dry-run's)."""
    n = cfg.active_params() - cfg.vocab * cfg.d_model
    if kind == "train":
        return 6.0 * n * global_batch * seq_len
    if kind == "prefill":
        return 2.0 * n * global_batch * seq_len
    return 2.0 * n * global_batch * 1  # decode: one token per sequence


def tree_bytes(tree) -> int:
    """Bytes of a tree's tensors (a DTensor's local shard), each storage
    once."""
    seen, total = set(), 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            st = _local(t).untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
    return total


#: c10d and functional-collective ops -> the XLA collective kind
COLLECTIVES = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "allgather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter", "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all", "broadcast_": "broadcast",
}


def _local(t):
    """A DTensor's local shard; any other tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


class StepCounter(TorchDispatchMode):
    """Counts, over the ops run inside it on plain tensors (a DTensor op
    is left to DTensor, whose local ops on each rank's shards it then
    sees; the ops DTensor runs on fake tensors to propagate shapes are
    not counted): the FLOPs of each op by `torch.utils.flop_counter`'s
    formulas, the bytes each op that is not a view or a collective reads
    and writes (its tensor operands and results), the ops by name
    (count, FLOPs, bytes), the collectives' result bytes by kind (as the
    JAX dry-run sums its HLO's), and the live storages' bytes (each
    storage once across its views, from the op that made it until its
    release, by a weakref finalizer) with their peak. `hold(tree)` counts
    a tree made outside as live (the step's arguments)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.flops = 0
        self.ops: Dict[str, Dict[str, int]] = {}
        self.collectives: Dict[str, int] = {}
        self.live = self.peak = 0
        self._held: Dict[int, int] = {}

    def _free(self, key: int, n: int) -> None:
        self._held.pop(key, None)
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key not in self._held:
            n = st.nbytes()
            self._held[key] = n
            self.live += n
            weakref.finalize(st, self._free, key, n)

    def hold(self, tree) -> None:
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                self._track(_local(t))
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out
        for t in outs:
            self._track(t)
        self.peak = max(self.peak, self.live)
        packet = func.overloadpacket
        name = packet.__name__
        row = self.ops.setdefault(name, {"count": 0, "flops": 0,
                                         "bytes": 0})
        row["count"] += 1
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            row["flops"] += n
        kind = COLLECTIVES.get(name)
        if kind:
            # the result's bytes: a functional op's output, an in-place
            # c10d op's first argument (its output tensors)
            res = outs if func.namespace == "_c10d_functional" else [
                t for t in tree_flatten(args[0])[0]
                if isinstance(t, torch.Tensor)]
            n = sum(t.numel() * t.element_size() for t in res)
            self.collectives[kind] = self.collectives.get(kind, 0) + n
            self.collectives[kind + "_count"] = \
                self.collectives.get(kind + "_count", 0) + 1
        elif not func.is_view:
            moved = sum(t.numel() * t.element_size() for t in ins + outs)
            self.bytes += moved
            row["bytes"] += moved
        return out


def build_step(cfg, spec, *, bf16_params: bool = False,
               opt_state_bf16: bool = False):
    """(step, args, donated) for the combo on the meta device, `spec`
    being `input_specs(cfg, shape)`: step(*args) runs the JAX-equivalent
    step once; `donated` are the argument trees the step updates in place
    (the JAX dry-run's donated arguments)."""
    if bf16_params:
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    kind = spec["kind"]
    gen = L.MetaGenerator()

    if kind == "train":
        params = T.init_params(cfg, gen, train=True)
        opt = AdamW(state_dtype=torch.bfloat16 if opt_state_bf16
                    else torch.float32)
        opt_state = opt.init(params)
        train_step = make_train_step(cfg, opt)

        def step(params, opt_state, batch):
            params, opt_state, metrics = train_step(params, opt_state, batch)
            return params, opt_state, metrics["total"]
        return step, (params, opt_state, spec["batch"]), (params, opt_state)

    params = T.cast_params(cfg, T.init_params(cfg, gen))
    if kind == "prefill":
        batch = spec["batch"]

        @torch.no_grad()
        def step(params, batch):
            return T.prefill(cfg, params, batch["tokens"], spec["seq_len"],
                             enc_embeds=batch.get("enc_embeds"),
                             img_embeds=batch.get("img_embeds"))
        return step, (params, batch), ()

    cache = spec["cache"]

    @torch.no_grad()
    def step(params, cache, tokens, index):
        return T.decode_step(cfg, params, cache, tokens, index)
    return step, (params, cache, spec["tokens"], spec["index"]), (cache,)


def count_step(step, args, donated, mesh=None, arg_specs=None):
    """Run step(*args) once under the counter. Returns (StepCounter,
    memory dict, op table); on DTensors every number is one device's
    (its local shards), and with `arg_specs` (the arguments' spec trees)
    a layer whose stack JAX splits counts its share of its shard
    (`sharding.local_bytes`)."""
    counter = StepCounter()
    counter.hold(args)
    arg_bytes = tree_bytes(args)
    if arg_specs is not None:
        arg_bytes = _shared_bytes(mesh, args, arg_specs)
    with counter:
        out = step(*args)
    out_bytes = tree_bytes(out)
    donated_ids = {id(_local(t).untyped_storage())
                   for t in tree_flatten(donated)[0]
                   if isinstance(t, torch.Tensor)}
    alias = tree_bytes([t for t in tree_flatten(out)[0]
                        if isinstance(t, torch.Tensor)
                        and id(_local(t).untyped_storage()) in donated_ids])
    peak = counter.peak
    memory = {"argument_size_in_bytes": arg_bytes,
              "output_size_in_bytes": out_bytes,
              "alias_size_in_bytes": alias,
              "temp_size_in_bytes": max(
                  0, peak - arg_bytes - (out_bytes - alias)),
              "peak_size_in_bytes": peak}
    table = sorted(({"op": name, **row} for name, row in counter.ops.items()),
                   key=lambda r: (-r["flops"], -r["bytes"], r["op"]))
    return counter, memory, table


def _shared_bytes(mesh, args, arg_specs) -> int:
    """The arguments' local-shard bytes, a split layer stack's leaf at its
    share; each shard is checked against the spec arithmetic."""
    from fractions import Fraction

    from repro_torch import tree as TR
    total = Fraction(0)
    for tree, specs in zip(args, arg_specs):
        for leaf, spec in zip(TR.leaves(tree), SH._spec_leaves(specs)):
            local = _local(leaf)
            if tuple(local.shape) != SH.local_shape(mesh, spec, leaf.shape):
                raise AssertionError(f"a shard of {tuple(local.shape)} for "
                                     f"{tuple(leaf.shape)} under {spec}")
            total += Fraction(local.numel() * local.element_size(),
                              SH.stack_shards(mesh, spec))
    return int(total)


@contextlib.contextmanager
def fake_mesh(mesh_name: str):
    """The JAX dry-run's mesh ("single": (16, 16), "multi": (2, 16, 16))
    over a "fake" world of its size in this process: collectives are
    recorded, not run. A process holds one default process group, so
    this one must have none."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run's fake world needs a process with "
                           "no process group; run the combo in its own")
    multi = mesh_name == "multi"
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi else 256)
    try:
        yield make_production_mesh(multi_pod=multi, device="cpu")
    finally:
        dist.destroy_process_group()


def mesh_arguments(cfg, mesh, spec, *, fsdp: bool = False,
                   bf16_params: bool = False, opt_state_bf16: bool = False,
                   experts_2d: bool = False):
    """The combo's argument trees on the meta device and their spec trees,
    as the JAX `build_step` places them: the parameters by `param_specs`
    (fsdp / experts_2d; the train step's fp32 masters, the served cast
    tree otherwise), AdamW's state by `opt_state_specs`, the batch by
    `batch_specs`, the decode cache by `make_cache_specs` and its tokens
    over the batch axes. `mesh` may be a DeviceMesh or a mapping {axis:
    size}: the per-device bytes are `sharding.local_bytes` of each pair
    (the spec arithmetic). Returns (cfg, trees, spec trees), cfg with
    bf16_params applied."""
    if bf16_params:
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    kind, gb = spec["kind"], spec["global_batch"]
    gen = L.MetaGenerator()
    params = T.init_params(cfg, gen, train=kind == "train")
    if kind != "train":
        params = T.cast_params(cfg, params)
    pspec = SH.param_specs(cfg, mesh, params, fsdp=fsdp,
                           experts_2d=experts_2d)
    if kind == "train":
        opt = AdamW(state_dtype=torch.bfloat16 if opt_state_bf16
                    else torch.float32)
        batch = spec["batch"]
        return cfg, (params, opt.init(params), batch), (
            pspec, SH.opt_state_specs(pspec),
            SH.batch_specs(cfg, mesh, batch, gb))
    if kind == "prefill":
        batch = spec["batch"]
        return cfg, (params, batch), (pspec, SH.batch_specs(cfg, mesh,
                                                            batch, gb))
    return cfg, (params, spec["cache"], spec["tokens"], spec["index"]), (
        pspec, SH.make_cache_specs(cfg, mesh, spec["cache"], gb),
        (SH.batch_axes(mesh, gb), None), (None,))


def build_mesh_step(cfg, mesh, spec, *, fsdp: bool = False,
                    bf16_params: bool = False, opt_state_bf16: bool = False,
                    experts_2d: bool = False, seq_shard: bool = False):
    """(step, args, donated, arg_specs) for the combo on `mesh`: the
    arguments of `mesh_arguments`, each a DTensor of meta shards. The
    step runs with JAX's `mesh=` and its constrainer (seq over "model"
    with seq_shard where the sequence divides); prefill's cache is made,
    placed, inside the step, as the JAX prefill makes its own."""
    cfg, trees, specs = mesh_arguments(
        cfg, mesh, spec, fsdp=fsdp, bf16_params=bf16_params,
        opt_state_bf16=opt_state_bf16, experts_2d=experts_2d)
    args = tuple(SH.distribute_tree(mesh, t, s)
                 for t, s in zip(trees, specs))
    kind, gb = spec["kind"], spec["global_batch"]
    msz = SH.axis_sizes(mesh)["model"]
    seq_ax = "model" if (seq_shard and spec["seq_len"] % msz == 0) else None
    constrain = SH.make_constrainer(mesh, gb, seq_axis=seq_ax,
                                    vocab=cfg.vocab, n_experts=cfg.n_experts,
                                    experts_2d=experts_2d)

    if kind == "train":
        train_step = make_train_step(cfg, AdamW(
            state_dtype=torch.bfloat16 if opt_state_bf16 else torch.float32),
            mesh=mesh, constrain=constrain)

        def step(params, opt_state, batch):
            params, opt_state, metrics = train_step(params, opt_state, batch)
            return params, opt_state, metrics["total"]
        return step, args, args[:2], specs

    if kind == "prefill":
        max_len = spec["seq_len"]

        @torch.no_grad()
        def step(params, batch):
            cache = T.init_cache(cfg, gb, max_len, torch.bfloat16,
                                 device="meta")
            cache = SH.distribute_tree(
                mesh, cache, SH.make_cache_specs(cfg, mesh, cache, gb))
            return T.prefill(cfg, params, batch["tokens"], max_len,
                             cache=cache, enc_embeds=batch.get("enc_embeds"),
                             img_embeds=batch.get("img_embeds"), mesh=mesh,
                             constrain=constrain)
        return step, args, (), specs

    @torch.no_grad()
    def step(params, cache, tokens, index):
        return T.decode_step(cfg, params, cache, tokens, index, mesh=mesh,
                             constrain=constrain)
    return step, args, (args[1],), specs


def run_combo(arch: str, shape: str, mesh_name: str = "card",
              out_dir: Path = RESULTS, force: bool = False,
              keep_trace: bool = False, fsdp: bool = False,
              bf16_params: bool = False, opt_state_bf16: bool = False,
              experts_2d: bool = False, seq_shard: bool = False,
              window_cache: bool = False, tag: str = "") -> Dict[str, Any]:
    """Count one (arch x shape) on `mesh_name` (one card, or the JAX
    meshes "single" / "multi" on the fake backend, `fake_mesh`; the
    sharding options need one of those) and write its record to
    out_dir. An existing record is returned as it is unless `force`."""
    if mesh_name not in MESHES:
        raise ValueError(f"mesh {mesh_name!r}: one of {MESHES}")
    if mesh_name == "card" and (fsdp or experts_2d or seq_shard):
        raise ValueError("fsdp, experts_2d and seq_shard shard over a "
                         "mesh: --mesh single or multi")
    out_dir = Path(out_dir)
    out = out_dir / f"{arch}__{shape}__{mesh_name}{tag}.json"
    if out.exists() and not force:
        print(f"[skip] {out.name} exists")
        return json.loads(out.read_text())
    cfg = get_config(arch)
    ok, why = supports(cfg, shape)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
           "timestamp": time.time()}
    out_dir.mkdir(parents=True, exist_ok=True)
    if not ok:
        rec.update(status="skipped", reason=why)
        out.write_text(json.dumps(rec, indent=1))
        print(f"[skip-by-design] {arch} x {shape}: {why}")
        return rec

    t0 = time.time()
    try:
        if window_cache:
            cfg = dataclasses.replace(cfg, window_cache=True)
        spec = input_specs(cfg, shape)
        with contextlib.ExitStack() as stack:
            if mesh_name == "card":
                mesh, n_dev = None, 1
                step, args, donated = build_step(
                    cfg, spec, bf16_params=bf16_params,
                    opt_state_bf16=opt_state_bf16)
                arg_specs = None
            else:
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                mesh = stack.enter_context(fake_mesh(mesh_name))
                n_dev = mesh.size()
                step, args, donated, arg_specs = build_mesh_step(
                    cfg, mesh, spec, fsdp=fsdp, bf16_params=bf16_params,
                    opt_state_bf16=opt_state_bf16, experts_2d=experts_2d,
                    seq_shard=seq_shard)
                # tensors made inside the step (positions, masks, rope
                # tables) are the same on every device
                stack.enter_context(implicit_replication())
            t_build = time.time() - t0
            counter, memory, table = count_step(step, args, donated, mesh,
                                                arg_specs)
        flops = float(counter.flops)
        coll = dict(counter.collectives)
        coll["total_bytes"] = sum(v for k, v in coll.items()
                                  if not k.endswith("_count"))
        rec.update(
            status="ok",
            n_devices=n_dev,
            kind=spec["kind"],
            build_s=round(t_build, 2),
            trace_s=round(time.time() - t0 - t_build, 2),
            memory=memory,
            flops_per_device=flops,
            bytes_per_device=float(counter.bytes),
            bytes_note=BYTES_NOTE,
            collectives=coll,
            collectives_note=("one card: no collectives" if mesh is None
                              else COLLECTIVES_NOTE),
            model_flops_global=model_flops(cfg, spec["kind"],
                                           spec["global_batch"],
                                           spec["seq_len"]),
            analytic=analytic_costs(cfg, spec["kind"],
                                    spec["global_batch"], spec["seq_len"]),
            attention=ATTENTION,
            attention_note=("the plain attend computes the full S x S "
                            "panel of each query chunk under a mask; the "
                            "analytic model counts S/2 keys a query at "
                            "train and prefill"),
            options=dict(bf16_params=bf16_params,
                         opt_state_bf16=opt_state_bf16,
                         window_cache=window_cache, fsdp=fsdp,
                         experts_2d=experts_2d, seq_shard=seq_shard),
        )
        if keep_trace:
            (out_dir / f"{arch}__{shape}__{mesh_name}{tag}.trace.json"
             ).write_text(json.dumps(table, indent=1))
        print(f"[ok] {arch} x {shape} x {mesh_name}: traced in "
              f"{rec['trace_s']:.1f}s, {flops / 1e12:.1f} TFLOP, "
              f"args {memory['argument_size_in_bytes'] / 2**30:.2f} GiB, "
              f"temp {memory['temp_size_in_bytes'] / 2**30:.2f} GiB, "
              f"coll {coll['total_bytes'] / 2**20:.1f} MiB (per device)")
    except Exception as e:  # a failure here is a fault of the port's step
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[FAIL] {arch} x {shape} x {mesh_name}: {e}")
    rec["elapsed_s"] = round(time.time() - t0, 2)
    out.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=MESHES, default=None,
                    help="card: one H100 (the default); single / multi: "
                         "the JAX meshes on the fake backend (single, "
                         "JAX's default, where a sharding option is "
                         "given without --mesh)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--keep-trace", action="store_true",
                    help="write the table of ops beside each record")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--bf16-params", action="store_true")
    ap.add_argument("--opt-state-bf16", action="store_true")
    ap.add_argument("--experts-2d", action="store_true")
    ap.add_argument("--window-cache", action="store_true",
                    help="ring-buffer local-layer KV caches (gemma3-style)")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args(argv)
    if args.mesh is None:
        args.mesh = "single" if (args.fsdp or args.experts_2d
                                 or args.seq_shard) else "card"
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all:
        combos = [(a, s) for a in ARCH_IDS for s in SHAPES]
        run = partial(run_combo, mesh_name=args.mesh, out_dir=out_dir,
                      force=args.force, keep_trace=args.keep_trace)
        workers = min(MAX_WORKERS, os.cpu_count() or 1, len(combos))
        if workers > 1:
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
                recs = list(pool.map(run, *zip(*combos)))
        else:
            recs = [run(a, s) for a, s in combos]
        n_err = sum(r.get("status") == "error" for r in recs)
        print(f"sweep done; {n_err} errors")
        return 1 if n_err else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    rec = run_combo(args.arch, args.shape, args.mesh, out_dir,
                    force=args.force, keep_trace=args.keep_trace,
                    bf16_params=args.bf16_params,
                    opt_state_bf16=args.opt_state_bf16,
                    window_cache=args.window_cache, fsdp=args.fsdp,
                    experts_2d=args.experts_2d, seq_shard=args.seq_shard,
                    tag=args.tag)
    return 0 if rec.get("status") in ("ok", "skipped") else 1


if __name__ == "__main__":
    raise SystemExit(main())
