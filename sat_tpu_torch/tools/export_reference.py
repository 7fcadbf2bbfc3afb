"""Export a checkpoint into the reference's flat TF1 npy layout.

The port of ``scripts/export_reference.py``: migration in the reverse
direction of ``--load`` + reference import.  The output file is a
``{var.name: value}`` dict exactly as the reference's own ``save()``
writes it, so the reference's ``load()`` ingests a model trained here.
Optimizer slots are not exported.

Usage: python -m sat_tpu_torch.tools.export_reference <checkpoint.npz> <out.npy>
       [--config config.json]

The config sidecar (written next to every checkpoint) supplies the model
architecture; pass --config explicitly if the checkpoint was moved away
from its sidecar.  The state is built on the card unless
``SAT_TORCH_DEVICE=cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sat_tpu_torch.tools.export_reference")
    ap.add_argument("checkpoint", help=".npz checkpoint")
    ap.add_argument("out", help="output .npy in reference layout")
    ap.add_argument(
        "--config", default=None,
        help="config.json (default: sidecar next to the checkpoint)",
    )
    args = ap.parse_args(argv)

    from ..device import resolve_device

    dev = resolve_device()

    import torch

    from ..config import Config
    from ..train.checkpoint import export_reference_checkpoint, restore_checkpoint
    from ..train.step import create_train_state

    config_path = args.config or os.path.join(
        os.path.dirname(os.path.abspath(args.checkpoint)), "config.json"
    )
    config = Config.load(config_path)
    state = create_train_state(config, torch.Generator().manual_seed(0), dev)
    state, count = restore_checkpoint(state, model_file=args.checkpoint)
    print(f"{count} tensors restored from {args.checkpoint}")
    n = export_reference_checkpoint(state, args.out)
    print(f"{n} tensors exported in reference layout -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
