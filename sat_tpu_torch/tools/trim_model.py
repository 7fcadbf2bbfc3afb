"""Strip optimizer slots from a checkpoint for slim inference files.

The port of ``scripts/trim_model.py``, the command line of the
reference's offline trim tool over the npz format.  Like every tool here
it asks for the card unless ``SAT_TORCH_DEVICE=cpu`` asks for the CPU,
though the trim itself is host numpy.

Usage: python -m sat_tpu_torch.tools.trim_model in.npz out.npz
"""

from __future__ import annotations

import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__)
        return 2
    from ..device import resolve_device
    from ..train.checkpoint import trim_checkpoint

    resolve_device()
    kept = trim_checkpoint(argv[0], argv[1])
    print(f"{kept} entries kept -> {argv[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
