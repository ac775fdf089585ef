"""Training launcher: the JAX package's `launch/train.py` with the same
flags, plus `--device`. It trains on the card unless `--device cpu` is
given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      --reduced --steps 50 --batch 4 --seq 64 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      --steps 20 --batch 8 --seq 1024          # full width, on the card

`--production-mesh` trains on the JAX launcher's (16, 16) pod mesh
("data", "model"): one process a card, 256 of them, launched by torchrun
(which gives each its rank, the world size and the rendezvous address),
e.g. on 32 hosts of 8 cards:

  torchrun --nnodes 32 --nproc-per-node 8 --rdzv-backend c10d \
      --rdzv-endpoint HOST:PORT -m repro_torch.launch.train \
      --arch olmo-1b --production-mesh

Each rank joins the NCCL world (gloo with `--device cpu`), builds the
mesh (`launch/mesh.py:make_production_mesh`) and trains SPMD
(`training/loop.py`); a smaller world raises, naming the 256 ranks it
needs, as the JAX launcher's assertion names its devices. The synthetic
corpus is text only, so an encoder-decoder (whisper) raises as the JAX
launcher does: its forward needs frame embeddings (`enc_embeds`) that
the corpus does not hold.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import os

import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config, get_reduced_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.training.loop import train


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Parse `argv` (the command line when None), train, print the loss's
    first and last values; returns `loop.train`'s result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the (16,16) pod mesh: 256 ranks under torchrun")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    mesh = None
    if args.production_mesh:
        if "WORLD_SIZE" in os.environ and not dist.is_initialized():
            dist.init_process_group("gloo" if args.device == "cpu"
                                    else "nccl")   # torchrun's env
        mesh = make_production_mesh(device=args.device)
    if cfg.arch_type == "encdec":
        raise ValueError(
            f"{cfg.name}: the encoder needs frame embeddings (enc_embeds), "
            "which the synthetic text corpus does not hold")
    print(f"training {cfg.name} ({cfg.arch_type}), "
          f"{cfg.total_params() / 1e6:.1f}M params, "
          f"device={args.device or 'cuda'}")
    out = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr, seed=args.seed,
                ckpt_dir=args.ckpt_dir or None, ckpt_every=args.ckpt_every,
                mesh=mesh, device=args.device)
    first, last = out["history"][0][1], out["history"][-1][1]
    print(f"ce {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return out


if __name__ == "__main__":
    main()
