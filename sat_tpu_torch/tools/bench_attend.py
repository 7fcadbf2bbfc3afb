"""The fused attention kernel against its plain version on the card — the
port of ``scripts/bench_pallas.py``, named after ``ops/fused_attend.py``.

At the flagship decode shapes (VGG16's grid N=196, da=D=512, float32
inputs drawn as the JAX script draws them) it times B1 (the unmasked
CUDA kernel) and the plain torch version over a sweep of batch sizes
(default B ∈ {32, 48, 64, 128}), checks both against a float64 ground
truth at each size, and gives the JAX script's verdict: the kernel holds
the path only if it is at least 1.02x the plain version at EVERY size.
Then B2 (the row-masked body) at B=48 with 48, 24 and 3 rows live: dead
rows +0.0, live rows bitwise B1's, its time beside the masked plain
version's.

Times come from ``utils.benchmarking.time_ms`` (CUDA events, the median
of ``--iters`` single launches, L2 flushed before each), which
``chip_smoke.py`` uses too; each sits beside its bound share (the least
time: each input read once and each output written once at 3.35 TB/s,
``utils.benchmarking.attention_bound_ms``).

``--block-b``: the JAX kernel's batch rows a grid block.  The CUDA
kernel's plan (``ops.fused_attend.attend_plan``) fixes its blocks a row
from (N, da, D) alone, so any value but 0 exits 2.  ``--cpu`` is a
plumbing smoke over the plain version (both arms are the plain version
there): its rows say so and it gives no verdict.

Usage: python -m sat_tpu_torch.tools.bench_attend [--batch 48] [--iters 200]
       [--cpu]   (--batch 0 = the default sweep)
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import List, Optional

from .benchlib import bench_device, device_kind

# flagship decode shapes: VGG16 grid N=196, da=D=512
N, DA, D = 196, 512, 512
SWEEP = (32, 48, 64, 128)
MASKED_B, MASKED_LIVE = 48, (48, 24, 3)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m sat_tpu_torch.tools.bench_attend")
    ap.add_argument("--batch", type=int, default=0, help="B (images × beams); 0 = sweep 32,48,64,128")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--block-b", type=int, default=0,
                    help="the JAX kernel's rows a grid block; the CUDA kernel's plan fixes "
                    "its own, so only 0 is accepted")
    ap.add_argument("--cpu", action="store_true",
                    help="plumbing smoke on the CPU over the plain version: no timing "
                    "of the kernel, no verdict")
    return ap


def _inputs(B: int, dev):
    """The JAX script's inputs: standard normals from numpy's seed 0."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    arrays = (rng.normal(size=(B, N, DA)), rng.normal(size=(B, DA)),
              rng.normal(size=(DA, 1)), rng.normal(size=(B, N, D)))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrays)


def _truth(t1, t2, w2, ctx):
    """float64 ground truth of (ctx, alpha)."""
    import torch

    logits = ((t1.double() + t2.double()[:, None, :]) @ w2.double()).squeeze(-1)
    alpha = torch.softmax(logits, dim=-1)
    return (alpha[..., None] * ctx.double()).sum(1), alpha


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _timer(dev, iters: int):
    """ms of one call: ``time_ms`` on the card, the median of host-timed
    calls on the CPU."""
    if dev.type == "cuda":
        import torch

        from ..utils.benchmarking import time_ms

        flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)  # over the 50 MB L2
        return lambda fn: time_ms(fn, flush, reps=iters)

    def host_ms(fn):
        fn()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    return host_ms


def bench_one(B: int, dev, timed) -> dict:
    """Time the plain version and the kernel at one batch size, and hold
    both to the float64 truth."""
    from ..ops.fused_attend import attend_plan, fused_attend, fused_attend_reference
    from ..utils.benchmarking import attention_bound_ms

    args = _inputs(B, dev)
    t_plain = timed(lambda: fused_attend_reference(*args))
    t_kernel = timed(lambda: fused_attend(*args))
    bound_ms, bound_by = attention_bound_ms(B, N, DA, D)
    traffic_mb = (args[0].nbytes + args[3].nbytes) / 1e6
    print(f"[B={B:3d}] plain:  {t_plain * 1e3:8.1f} us   (~{traffic_mb / t_plain:.0f} GB/s effective)", flush=True)
    print(f"[B={B:3d}] kernel: {t_kernel * 1e3:8.1f} us   (~{traffic_mb / t_kernel:.0f} GB/s effective; "
          f"bound {bound_ms * 1e3:.1f} us by {bound_by}, {bound_ms / t_kernel:.1%} of it)", flush=True)

    # correctness BEFORE the verdict: a fast-but-wrong kernel must never
    # emit the ENABLE line; both are held to a float64 truth, not to each
    # other
    truth = _truth(*args)
    want = fused_attend_reference(*args)
    got = fused_attend(*args)
    err_alpha = (_max_err(got[1], truth[1]), _max_err(want[1], truth[1]))
    err_ctx = (_max_err(got[0], truth[0]), _max_err(want[0], truth[0]))
    print(f"[B={B:3d}] max |err| vs float64 truth — alpha: kernel {err_alpha[0]:.2e} plain "
          f"{err_alpha[1]:.2e}; context: kernel {err_ctx[0]:.2e} plain {err_ctx[1]:.2e}", flush=True)
    if not (err_alpha[0] <= max(err_alpha[1] * 1.5, 1e-5) and err_ctx[0] <= max(err_ctx[1] * 1.5, 1e-4)):
        raise AssertionError(f"B={B}: kernel error alpha {err_alpha}, ctx {err_ctx} over the plain version's")
    speedup = t_plain / t_kernel
    plan = attend_plan(N, DA, D)
    print(f"[B={B:3d}] kernel: {plan.cluster} blocks a row  speedup vs plain: {speedup:.2f}x  "
          "correctness OK", flush=True)
    return {
        "batch": B,
        "plain_us": round(t_plain * 1e3, 1),
        "kernel_us": round(t_kernel * 1e3, 1),
        "blocks_per_row": plan.cluster,
        "speedup": round(speedup, 3),
        "bound_us": round(bound_ms * 1e3, 2),
        "bound_by": bound_by,
        "bound_share": round(bound_ms / t_kernel, 4),
        "err_ctx_kernel": err_ctx[0],
        "err_ctx_plain": err_ctx[1],
    }


def bench_masked(dev, timed) -> List[dict]:
    """B2 at B=48 with 48, 24 and 3 rows live: dead rows +0.0, live rows
    bitwise the unmasked kernel's; its time beside the masked plain
    version's and its bound (live rows' inputs only)."""
    import torch

    from ..ops.fused_attend import fused_attend, fused_attend_reference
    from ..utils.benchmarking import masked_bound_ms

    args = _inputs(MASKED_B, dev)
    full = fused_attend(*args)
    rows = []
    for live in MASKED_LIVE:
        mask = torch.arange(MASKED_B, device=dev) < live
        got = fused_attend(*args, row_mask=mask)
        for g, f in zip(got, full):
            if not (bool((g[~mask] == 0).all()) and torch.equal(g[mask], f[mask])):
                raise AssertionError(f"masked B={MASKED_B} live={live}: dead rows not 0 or live rows "
                                     "not the unmasked kernel's")
        t_kernel = timed(lambda: fused_attend(*args, row_mask=mask))
        t_plain = timed(lambda: fused_attend_reference(*args, row_mask=mask))
        bound_ms, bound_by = masked_bound_ms(MASKED_B, live, N, DA, D)
        print(f"[masked B={MASKED_B} live={live:2d}] kernel {t_kernel * 1e3:8.1f} us, plain "
              f"{t_plain * 1e3:8.1f} us; bound {bound_ms * 1e3:.1f} us by {bound_by}, "
              f"{bound_ms / t_kernel:.1%} of it", flush=True)
        rows.append({
            "batch": MASKED_B, "live": live,
            "plain_us": round(t_plain * 1e3, 1), "kernel_us": round(t_kernel * 1e3, 1),
            "speedup": round(t_plain / t_kernel, 3),
            "bound_us": round(bound_ms * 1e3, 2), "bound_by": bound_by,
            "bound_share": round(bound_ms / t_kernel, 4),
        })
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.block_b:
        print("bench_attend: --block-b has no counterpart: the CUDA kernel's launch plan "
              "(ops.fused_attend.attend_plan) fixes its blocks a row from (N, da, D) alone",
              file=sys.stderr)
        return 2
    dev = bench_device(args.cpu)

    from .. import telemetry
    from ..ops import fused_attend as fa

    kind = device_kind(dev)
    print(f"device: {kind} ({dev.type})", flush=True)
    timed = _timer(dev, args.iters)
    batches = [args.batch] if args.batch else list(SWEEP)
    launches0, masked0 = fa.fused_attend.launches, fa.fused_attend.masked_launches
    rows = [bench_one(B, dev, timed) for B in batches]
    masked = bench_masked(dev, timed)
    min_speedup = min(r["speedup"] for r in rows)
    print(json.dumps({
        "sweep": rows,
        "min_speedup": min_speedup,
        "masked": masked,
        "shape": {"N": N, "da": DA, "D": D, "dtype": "float32"},
        "iters": args.iters,
        "fused_attend_launches": fa.fused_attend.launches - launches0,
        "fused_attend_masked_launches": fa.fused_attend.masked_launches - masked0,
        "device_kind": kind,
        **({"smoke": "cpu: both arms are the plain version; not a measurement"} if dev.type != "cuda" else {}),
        **telemetry.bench_stamp(),
    }), flush=True)
    if dev.type != "cuda":
        print("smoke complete (plain version on the CPU): no enable/keep verdict")
        return 0
    # the path keeps the kernel only if it holds the win at EVERY measured
    # operating point; the 1.02 margin keeps timing noise from deciding a
    # wash
    print("verdict: ENABLE the fused_attend kernel (use_pallas_attention)" if min_speedup >= 1.02
          else "verdict: keep the plain path (wash or loses at some batch size)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
