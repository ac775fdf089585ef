"""End-to-end training example: train a ~100M-parameter dense model for a
few hundred steps and check that the loss descends (the JAX package's
`examples/train_small.py`, on the card unless `--device cpu`).

  PYTHONPATH=src python examples_torch/train_small.py --steps 300
  PYTHONPATH=src python examples_torch/train_small.py --steps 5 \
      --device cpu
"""
import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.models.config import ModelConfig
from repro_torch.training.loop import train


def small_100m() -> ModelConfig:
    """~100M-param member of the olmo family (non-parametric LN)."""
    base = get_config("olmo-1b")
    return dataclasses.replace(
        base, name="olmo-100m", n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=8, d_ff=2048, vocab=8192, remat=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = small_100m()
    print(f"{cfg.name}: {cfg.total_params()/1e6:.1f}M params")
    out = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr, log_every=20, device=args.device)
    first, last = out["history"][0][1], out["history"][-1][1]
    drop = 100 * (1 - last / first)
    print(f"\nce {first:.3f} -> {last:.3f}  ({drop:.1f}% drop)")
    if not last < first:
        raise AssertionError("loss did not descend!")
    return out


if __name__ == "__main__":
    main()
