"""Several CLI argument lists in turn, in every rank of one torchrun launch.

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m sat_tpu_torch.tools.cli_ranks TALLY_DIR '<JSON list of argument lists>'

Each rank joins the process group once (``parallel.mesh.
initialize_distributed``), runs ``sat_tpu_torch.cli.main`` on each
argument list in turn — the CLI leaves a group its caller made, so a
train and then an eval run in the same ranks and pay one start-up — and
leaves the group.  Every rank writes ``TALLY_DIR/tally_rank<r>.json``:
for each argument list its return code, wall seconds and the
``fused_attend`` launches it made (unmasked and masked).
The exit code is the first non-zero return code, else 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sat_tpu_torch.tools.cli_ranks")
    ap.add_argument("tally", help="directory for each rank's tally_rank<r>.json")
    ap.add_argument("argvs", help="JSON list of CLI argument lists, run in turn")
    args = ap.parse_args(argv)
    argvs = json.loads(args.argvs)

    from .. import cli
    from ..ops.fused_attend import fused_attend
    from ..parallel.mesh import initialize_distributed, rank, shutdown_distributed

    initialize_distributed()
    tally, rc = [], 0
    try:
        for run in argvs:
            fused_attend.launches = fused_attend.masked_launches = 0
            t0 = time.perf_counter()
            rc = cli.main(run)
            tally.append({"argv": run, "rc": rc, "wall_s": time.perf_counter() - t0,
                          "launches": fused_attend.launches, "masked_launches": fused_attend.masked_launches})
            if rc:
                break
    finally:
        os.makedirs(args.tally, exist_ok=True)
        with open(os.path.join(args.tally, f"tally_rank{rank()}.json"), "w") as f:
            json.dump(tally, f)
        shutdown_distributed()
    return rc


if __name__ == "__main__":
    sys.exit(main())
