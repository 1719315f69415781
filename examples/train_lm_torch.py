"""Train a ported --arch (reduced config) with the PyTorch port's trainer:
data pipeline -> train step -> async checkpoints -> resume.

  PYTHONPATH=src python examples/train_lm_torch.py --arch qwen3-1.7b --steps 60
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu

The same flags as ``examples/train_lm.py``, plus ``--device`` (the card
by default).
"""

import argparse

import torch

from repro_torch import configs
from repro_torch.configs.base import ShapeCell
from repro_torch.launch.train import train_loop
from repro_torch.optim import AdamWConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=configs.ARCHS)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = configs.get_config(args.arch, smoke=True)
    shape = ShapeCell("example", "train", args.seq, args.batch)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps)
    _, _, losses = train_loop(cfg, shape, steps=args.steps, opt_cfg=opt,
                              ckpt_dir=args.ckpt_dir,
                              param_dtype=torch.float32, device=args.device)
    print(f"[{args.arch}] loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
          f"{args.steps} steps")
    assert losses[-1] < losses[0], "loss should decrease"


if __name__ == "__main__":
    main()
