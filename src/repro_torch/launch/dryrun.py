"""The dry-run: build every (arch x shape) step at full size on the meta
device, and count what it would cost on one card.

The counterpart of the JAX package's `launch/dryrun.py`, which lowers and
compiles each (arch x shape x mesh) on 512 forced host devices and reads
XLA's memory and cost analyses and the collective bytes of the HLO. The
port builds the same step the JAX dry-run lowers, on meta tensors
(shapes and dtypes, no storage: deepseek-v3's 671 B parameters cost
nothing), and runs it once under two dispatch modes that see every aten
op:

  train_4k     -> `training.loop.make_train_step`: `transformer.loss_fn`
                  under autograd, then `AdamW.update` in place
  prefill_32k  -> `transformer.prefill`, into a fresh bf16 cache
  decode_32k,  -> `transformer.decode_step` on `configs.shapes.
  long_500k       input_specs`' bf16 cache, written in place

and records, per (arch x shape) on one card (`--mesh card`):

  * flops_per_device: `torch.utils.flop_counter.FlopCounterMode`'s count
    (matmuls, convolutions and attention products; the backward's
    included);
  * bytes_per_device: each op's operand and result bytes, summed over the
    ops that are not views. This is UNFUSED: every intermediate is
    written and read again, where XLA's count is over its fused HLO;
  * memory: argument_size_in_bytes (the step's input trees), the outputs
    (output_size_in_bytes) and those of them that are arguments updated
    in place (alias_size_in_bytes: the parameters and optimiser state,
    or the decode cache), peak_size_in_bytes (the most bytes of live
    storages during the step, the arguments included; a storage counts
    once across its views, each tracked from its creation to its
    release) and temp_size_in_bytes = peak - arguments - (outputs -
    aliases), as XLA's temp excludes the new outputs (so arguments +
    temp + outputs - aliases is the peak, as the JAX roofline reads it);
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

One card has no collectives: `collectives` is {"total_bytes": 0}. The
JAX meshes (`--mesh single|multi`) and their sharding options (`--fsdp`,
`--experts-2d`, `--seq-shard`) raise NotImplementedError: the fleet
meshes and the model's sharding rules are not ported (ROADMAP §2.10),
and no mesh is faked.

Results land in results/dryrun_torch/<arch>__<shape>__card<tag>.json;
the roofline report (benchmarks_torch/roofline.py) reads them.
`--keep-trace` writes the table of ops (name, count, FLOPs, bytes)
beside each record.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # resumable

`--all` counts its combos in parallel processes, one a core up to
MAX_WORKERS.
"""
from __future__ import annotations

import argparse
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
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.roofline_model import analytic_costs
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, input_specs, supports
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
              "is not a view (XLA counts its fused HLO)")


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
    """Bytes of a tree's tensors, each storage once."""
    seen, total = set(), 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
    return total


class StepCounter(TorchDispatchMode):
    """Counts, over the ops run inside it: the bytes each op that is not
    a view reads and writes (its tensor operands and results), the ops
    by name (count, bytes), and the
    live storages' bytes (each storage once across its views, from the
    op that made it until its release, by a weakref finalizer) with
    their peak. `hold(tree)` counts a tree made outside as live (the
    step's arguments)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops: Dict[str, Dict[str, int]] = {}
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
                self._track(t)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        self.peak = max(self.peak, self.live)
        name = func.overloadpacket.__name__
        row = self.ops.setdefault(name, {"count": 0, "bytes": 0})
        row["count"] += 1
        if not func.is_view:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
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


def count_step(step, args, donated):
    """Run step(*args) once under the counters. Returns (flops,
    StepCounter, memory dict, op table)."""
    counter = StepCounter()
    flops = FlopCounterMode(display=False)
    counter.hold(args)
    arg_bytes = tree_bytes(args)
    with flops, counter:
        out = step(*args)
    out_bytes = tree_bytes(out)
    donated_ids = {id(t.untyped_storage()) for t in tree_flatten(donated)[0]
                   if isinstance(t, torch.Tensor)}
    alias = tree_bytes([t for t in tree_flatten(out)[0]
                        if isinstance(t, torch.Tensor)
                        and id(t.untyped_storage()) in donated_ids])
    peak = counter.peak
    memory = {"argument_size_in_bytes": arg_bytes,
              "output_size_in_bytes": out_bytes,
              "alias_size_in_bytes": alias,
              "temp_size_in_bytes": max(
                  0, peak - arg_bytes - (out_bytes - alias)),
              "peak_size_in_bytes": peak}
    per_op = {}
    for op, n in flops.get_flop_counts().get("Global", {}).items():
        per_op[getattr(op, "__name__", str(op))] = int(n)
    table = sorted(({"op": name, "count": row["count"],
                     "flops": per_op.get(name, 0), "bytes": row["bytes"]}
                    for name, row in counter.ops.items()),
                   key=lambda r: (-r["flops"], -r["bytes"], r["op"]))
    return float(flops.get_total_flops()), counter, memory, table


def _refuse_mesh(mesh: str, **sharding) -> None:
    asked = [f"--{k.replace('_', '-')}" for k, v in sharding.items() if v]
    if mesh != "card" or asked:
        what = f"--mesh {mesh}" if mesh != "card" else ", ".join(asked)
        raise NotImplementedError(
            f"{what}: the fleet meshes and the model's sharding rules are "
            "not ported (ROADMAP §2.10); one card has no mesh, and the "
            "dry-run fakes none (use --mesh card)")


def run_combo(arch: str, shape: str, mesh_name: str = "card",
              out_dir: Path = RESULTS, force: bool = False,
              keep_trace: bool = False, fsdp: bool = False,
              bf16_params: bool = False, opt_state_bf16: bool = False,
              experts_2d: bool = False, seq_shard: bool = False,
              window_cache: bool = False, tag: str = "") -> Dict[str, Any]:
    """Count one (arch x shape) on `mesh_name` ("card"; the JAX meshes and
    sharding options raise) and write its record to out_dir. An existing
    record is returned as it is unless `force`."""
    _refuse_mesh(mesh_name, fsdp=fsdp, experts_2d=experts_2d,
                 seq_shard=seq_shard)
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
        step, args, donated = build_step(
            cfg, spec, bf16_params=bf16_params,
            opt_state_bf16=opt_state_bf16)
        t_build = time.time() - t0
        flops, counter, memory, table = count_step(step, args, donated)
        rec.update(
            status="ok",
            n_devices=1,
            kind=spec["kind"],
            build_s=round(t_build, 2),
            trace_s=round(time.time() - t0 - t_build, 2),
            memory=memory,
            flops_per_device=flops,
            bytes_per_device=float(counter.bytes),
            bytes_note=BYTES_NOTE,
            collectives={"total_bytes": 0},
            collectives_note="one card: no collectives",
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
                         window_cache=window_cache),
        )
        if keep_trace:
            (out_dir / f"{arch}__{shape}__{mesh_name}{tag}.trace.json"
             ).write_text(json.dumps(table, indent=1))
        print(f"[ok] {arch} x {shape} x {mesh_name}: traced in "
              f"{rec['trace_s']:.1f}s, {flops / 1e12:.1f} TFLOP, "
              f"args {memory['argument_size_in_bytes'] / 2**30:.2f} GiB, "
              f"temp {memory['temp_size_in_bytes'] / 2**30:.2f} GiB")
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
    ap.add_argument("--mesh", choices=MESHES, default="card",
                    help="card: one H100; the JAX meshes single/multi "
                         "raise (ROADMAP §2.10)")
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
    _refuse_mesh(args.mesh, fsdp=args.fsdp, experts_2d=args.experts_2d,
                 seq_shard=args.seq_shard)
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
                    window_cache=args.window_cache, tag=args.tag)
    return 0 if rec.get("status") in ("ok", "skipped") else 1


if __name__ == "__main__":
    raise SystemExit(main())
