"""Train a deformable-conv classifier (reduced VGG19-3) with the PyTorch
port for a few hundred steps on synthetic blob images, with checkpoints.

  PYTHONPATH=src python examples/train_dcn_torch.py --steps 300
  PYTHONPATH=src python examples/train_dcn_torch.py --device cpu

The same flags as ``examples/train_dcn.py``, plus ``--device`` (the card
by default). The deformable layers run through the checkpointed
``fused_deformable_conv2d`` and train their own offsets from the regular
grid. Loss should fall well below ln(4) = 1.386, chance level.
"""

import argparse
import math
import os
import tempfile

from repro_torch.launch.train import dcn_train_loop
from repro_torch.models.dcn_models import DcnNetConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--variant", default="dcn2", choices=["dcn1", "dcn2"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_dcn_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = DcnNetConfig(name="vgg19", n_deform=3, variant=args.variant,
                       img_size=32, width_mult=0.25,
                       num_classes=args.classes)
    _, _, losses = dcn_train_loop(cfg, steps=args.steps, batch=args.batch,
                                  lr=args.lr, ckpt_dir=args.ckpt_dir,
                                  device=args.device)
    print(f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(chance={math.log(args.classes):.3f}); "
          f"checkpoints in {args.ckpt_dir}")


if __name__ == "__main__":
    main()
