"""Read the compared numbers of a cell over many seeds in one process:
the program's, and a control's or a fault's, each at the cell's own
sizes and load with a short window.  The limits in
``capbench/workloads/<cell>.json`` are set from these readings; the
benchmark's own runs never run this.

    python3 -m capbench.readings --workload <name> --seeds 11,12,13 \
        [--variant int8] [--fault rank_drop] [--seconds 3]

``--variant`` runs a control the driver offers; ``--fault`` plants one of
``capbench.faults`` in the program.  Prints one JSON line a seed: {seed,
variant, fault, readings, metrics}.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="capbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import contextlib

    from capbench import bench, faults

    cell = bench.load_cell(args.workload)
    bench.cache_dirs()
    import torch
    from sat_tpu_torch.device import resolve_device

    device = resolve_device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        with faults.planted(args.fault) if args.fault else contextlib.nullcontext():
            out = bench.driver(cell).run(cell, seed, args.seconds, False, device, time.perf_counter(),
                                         variant=args.variant)
        print(json.dumps({"seed": seed, "variant": args.variant, "fault": args.fault, "readings": out["readings"],
                          "metrics": out["metrics"], "check_s": out.get("check_s")}), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
