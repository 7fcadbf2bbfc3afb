"""Run one cell of the benchmark once and print its result line.

    python3 -m capbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  ``--trace 0`` prints the cell's end-to-end
metrics; ``--trace 1`` its per-layer metrics, read from a profiled segment
after the window, with the device's busy time and a ``breakdown``.  Either
way the run judges what its window produced against the plain reference
and prints each compared number beside its limit, last on standard error
and last in the result line.  Without as many CUDA cards as the cell asks
for it exits non-zero and prints no result.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="capbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from capbench import bench

    cell = bench.load_cell(args.workload)
    bench.cache_dirs()
    import torch

    torch.set_num_threads(1)  # the host drives the card; idle pool threads only contend with it

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"capbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible", file=sys.stderr)
        return 2
    from sat_tpu_torch.device import resolve_device

    device = resolve_device("cuda")
    out = bench.driver(cell).run(cell, args.seed, args.seconds, bool(args.trace), device, _T0)

    found = bench.forbidden_loaded()
    if found:
        print(f"capbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    record = out["record"]
    dev = bench.device_record(cell.chips, out["memory_peak_bytes"])
    breakdown = None
    if args.trace:
        from capbench.trace import breakdown as reduce_breakdown

        metrics = {}
        for name in bench.per_layer_names(cell):
            value = bench.metric_reader(name)(record)
            if value is not None:
                metrics[name] = value
        dev["busy_s"], dev["window_s"] = record["trace"]["busy_s"], record["trace"]["window_s"]
        breakdown = reduce_breakdown(record["trace"])
    else:
        metrics = {name: out["metrics"][name] for name in bench.end_to_end_names(cell)}
    correct = bench.checks_ok(out["checks"])
    bench.report_checks(out["checks"])
    sys.stderr.flush()
    print(bench.result_line(correct, out["attempted"], out["failed"], metrics, bench.units(cell.bench),
                            dev, out["checks"], breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
