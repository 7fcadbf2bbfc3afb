"""Multi-process distributed train + eval demo and proof — the port of
``scripts/multihost_demo.py``.

Launches N real OS processes (started here, not by ``torchrun``) that
join one ``torch.distributed`` group over a loopback ``127.0.0.1:<port>``
store, each with the environment a launcher gives a rank (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``).  Every rank trains the captioner through
``runtime.train`` on the demo's mesh, checkpoints, and runs the mesh eval
through ``runtime.evaluate`` with the cross-rank gather and attention
panels; each rank scores its own copy of the gathered results.

Layouts: data-parallel (N,1) by default, ``--cp`` context-parallel and
``--tp`` vocab tensor-parallel (1,N), ``--mesh D,M`` with either.  The
workers run on the card unless the tool runs under
``SAT_TORCH_DEVICE=cpu`` (they inherit it); on a host with one card
every rank shares ``cuda:0`` under gloo (``parallel.mesh.device_rule``).

The port's differences from the JAX script: the fixture comes from
:mod:`.fixtures`; ``--extra-set KEY=VALUE`` (repeatable) is applied after
the demo's config, so a run can take the flagship widths; under ``--tp``
each rank counts the parameters it holds as blocks of a leaf the
placement rule shards over ``model`` and prints ``TP verified``; under
``--fleet`` rank 0 merges the sidecars after a ``torch.distributed``
barrier, and worker 0's stall is ``--slow-ms`` or ``FLEET_SLOW_SCALE``
times its own median step, the longer.  Every worker's full output is kept as
``<root>/worker_p<r>.log`` and its ``fused_attend`` launches in the eval
as ``<root>/tally_p<r>.json``.

Run: python -m sat_tpu_torch.tools.multihost_demo [--procs 2]
Exit 0 = multi-process train + eval completed and all ranks agreed;
1 = a check failed (a ``FAIL: ...`` line says which); 2 = bad arguments.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from typing import List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# A rendezvous that never formed: the store's wait for its clients timed
# out, gloo's full-mesh connect failed, or the store's port is still held
# (an earlier attempt's socket in TIME_WAIT).  Only these are retried, on a
# fresh port; any other worker error fails at once.
RENDEZVOUS_FLAKE = re.compile(
    r"DistStoreError: .*[Tt]imed out|Gloo connectFullMesh failed|EADDRINUSE|address already in use"
)
ATTEMPTS = 3
# under --fleet worker 0 stalls --slow-ms, or this many of its own median
# steps where that is longer (SAT_FI_SLOW_STEP_SCALE): with two ranks the
# 1.5x straggler factor needs its step above three times the other's, and
# a fixed stall falls under that once a loaded host stretches every step
FLEET_SLOW_SCALE = 6


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m sat_tpu_torch.tools.multihost_demo")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--port", type=int, default=12765)
    ap.add_argument("--root", default="/tmp/sat_tpu_torch_multihost_demo")
    ap.add_argument(
        "--join-timeout", type=float, default=900.0,
        help="seconds to wait for the workers before declaring failure",
    )
    ap.add_argument(
        "--cp", action="store_true",
        help="context-parallel mode: mesh (1, procs) with the attention grid "
        "sharded ACROSS the processes for both training and beam-search "
        "decode; every rank feeds identical full batches",
    )
    ap.add_argument(
        "--tp", action="store_true",
        help="vocab tensor-parallel mode: mesh (1, procs) with the embedding "
        "table and softmax projection sharded ACROSS the processes; every "
        "rank feeds identical full batches",
    )
    ap.add_argument(
        "--mesh", default=None, metavar="D,M",
        help="explicit (data, model) mesh over D*M processes — e.g. --mesh "
        "2,2 --cp runs dp x CP combined",
    )
    ap.add_argument(
        "--fleet", action="store_true",
        help="fleet telemetry mode: enable the cross-rank fleet plane with a "
        "shared fleet_dir, inject SAT_FI_SLOW_STEP_MS into worker 0 only, and "
        "assert the merged fleet.json reports every rank and names worker 0 "
        "as the straggler",
    )
    ap.add_argument(
        "--slow-ms", type=int, default=75,
        help="host-side stall injected per step into worker 0 under --fleet "
        f"(or {FLEET_SLOW_SCALE:g} times its median own step, measured as it runs, "
        "where that is longer)",
    )
    ap.add_argument(
        "--check-loss-parity", action="store_true",
        help="also train a one-process (1,1) control on the same config/seed "
        "and assert rank 0's loss trajectory matches it",
    )
    ap.add_argument(
        "--extra-set", action="append", default=[], metavar="KEY=VALUE",
        help="Config override applied after the demo's config (repeatable), "
        "e.g. the flagship widths for a run on the card",
    )
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--control", default=None, help=argparse.SUPPRESS)
    return ap


# ---------------------------------------------------------------------------
# rank side
# ---------------------------------------------------------------------------


def sharded_leaves(params, config, model_size: int) -> int:
    """How many leaves of ``params`` this rank holds as a 1/``model_size``
    block of a leaf that the placement rule shards over ``model``
    (``parallel.sharding.leaf_dim`` on the leaf's full shape).  Replicated
    parameters count 0."""
    from ..parallel.sharding import leaf_dim, walk

    vocab, count = config.vocabulary_size, 0
    for path, t in walk(params):
        for dim, width in enumerate(t.shape):
            full = tuple(vocab if i == dim else s for i, s in enumerate(t.shape))
            if width * model_size == vocab and leaf_dim(path, full, config, model_size) == dim:
                count += 1
                break
    return count


def worker(root: str) -> int:
    from .. import runtime
    from ..config import Config
    from ..ops.fused_attend import fused_attend
    from ..parallel.mesh import initialize_distributed, rank, shutdown_distributed, sync_processes, world_size
    from ..runtime import placement_config

    initialize_distributed()
    pid, nprocs = rank(), world_size()
    try:
        config = Config.load(os.path.join(root, "config.json")).replace(
            summary_dir=os.path.join(root, f"summary_p{pid}"),
        )
        t0 = time.perf_counter()
        state = runtime.train(config)
        train_s = time.perf_counter() - t0
        print(f"[p{pid}] trained to step {int(state.step)}", flush=True)

        if config.fleet_telemetry:
            # every rank's fleet plane wrote its terminal sidecar when its
            # train ended; after the barrier rank 0 merges all of them
            sync_processes("fleet_final")
            if pid == 0:
                from ..telemetry import fleet as fleet_mod

                doc = fleet_mod.aggregate_directory(config.fleet_dir, config.straggler_factor)
                s = (doc or {}).get("straggler", {})
                print(
                    f"[p0] fleet final: hosts={(doc or {}).get('hosts_reporting')} "
                    f"straggler={s.get('verdict')} p{s.get('process_index')} skew={s.get('skew')}",
                    flush=True,
                )

        mp = tuple(config.mesh_shape)[1]
        if mp > 1 and config.context_parallel == 1:
            # vocab-TP mode: the banner must not be earnable with replicated
            # parameters — demand leaves this rank holds as blocks
            n = sharded_leaves(state.params, placement_config(config), mp)
            if n <= 0:
                raise SystemExit(f"[p{pid}] TP mode but no parameter is sharded over 'model'")
            print(f"[p{pid}] TP verified: {n} params sharded over 'model'", flush=True)
        del state

        # the eval loads the checkpoint rank 0 wrote (every rank synced on it)
        fused_attend.launches = fused_attend.masked_launches = 0
        t0 = time.perf_counter()
        scores = runtime.evaluate(config, every_rank=True)
        eval_s = time.perf_counter() - t0
        with open(os.path.join(root, f"scores_p{pid}.json"), "w") as f:
            json.dump(scores, f)
        with open(os.path.join(root, f"tally_p{pid}.json"), "w") as f:
            json.dump({"rank": pid, "world": nprocs, "train_s": train_s, "eval_s": eval_s,
                       "launches": fused_attend.launches, "masked_launches": fused_attend.masked_launches}, f)
        print(f"[p{pid}] eval done ({fused_attend.launches} fused_attend launches)", flush=True)
    finally:
        shutdown_distributed()
    return 0


def control(root: str) -> int:
    """The one-process (1,1) control of the loss-parity check: the same
    config and seed, its own summary and save directories."""
    from .. import runtime
    from ..config import Config

    config = Config.load(os.path.join(root, "config.json")).replace(
        mesh_shape=(1, 1), context_parallel=1,
        summary_dir=os.path.join(root, "summary_control"),
        save_dir=os.path.join(root, "save_control"),
        telemetry=False, fleet_telemetry=False,
    )
    runtime.train(config)
    print("[control] trained", flush=True)
    return 0


# ---------------------------------------------------------------------------
# launcher side
# ---------------------------------------------------------------------------


def _base_env() -> dict:
    # inherited fault hooks never reach a worker; the straggler's stall is
    # added to worker 0 alone
    env = {k: v for k, v in os.environ.items() if not k.startswith("SAT_FI_")}
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def _rank_env(base: dict, p: int, nprocs: int, port: int, slow_ms: Optional[int]) -> dict:
    env = dict(base)
    env.update(RANK=str(p), WORLD_SIZE=str(nprocs), LOCAL_RANK=str(p), LOCAL_WORLD_SIZE=str(nprocs),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    if slow_ms is not None:
        env["SAT_FI_SLOW_STEP_MS"] = str(slow_ms)
        env["SAT_FI_SLOW_STEP_SCALE"] = str(FLEET_SLOW_SCALE)
    return env


def run_workers(args, port: int):
    """One launch of the ranks; (every rank exited 0, their outputs)."""
    # fresh metric streams per attempt: the summary writer appends to
    # metrics.jsonl, so a retried launch (or a reused --root) would stack
    # trajectories and break the loss-parity check
    for name in [f"summary_p{p}" for p in range(args.procs)] + ["summary_control", "fleet"]:
        shutil.rmtree(os.path.join(args.root, name), ignore_errors=True)
    base = _base_env()
    procs = [
        subprocess.Popen(
            [sys.executable, "-u", "-m", "sat_tpu_torch.tools.multihost_demo", "--worker", args.root],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
            env=_rank_env(base, p, args.procs, port, args.slow_ms if args.fleet and p == 0 else None),
        )
        for p in range(args.procs)
    ]
    # drain every pipe concurrently: a rank blocked on a full pipe inside
    # a collective would deadlock the group
    outputs = [""] * args.procs

    def drain(p, proc):
        out, _ = proc.communicate()
        outputs[p] = out or ""

    threads = [threading.Thread(target=drain, args=(p, proc), daemon=True) for p, proc in enumerate(procs)]
    ok = True
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + args.join_timeout
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                ok = False
        # the drain threads fill `outputs` only after communicate() returns
        for t in threads:
            t.join(timeout=30)
    for p, proc in enumerate(procs):
        rc = proc.returncode
        with open(os.path.join(args.root, f"worker_p{p}.log"), "w") as f:
            f.write(outputs[p])
        tail = "\n".join(outputs[p].strip().splitlines()[-6:])
        print(f"--- process {p} (rc={rc}) ---\n{tail}", flush=True)
        ok &= rc == 0
    return ok, outputs, [proc.returncode for proc in procs]


def _losses(summary_dir: str) -> List[float]:
    with open(os.path.join(summary_dir, "metrics.jsonl")) as f:
        return [json.loads(line)["total_loss"] for line in f if line.strip()]


def main(argv: Optional[List[str]] = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker)
    if args.control:
        return control(args.control)
    if args.cp and args.tp:
        ap.error("--cp and --tp are mutually exclusive (one model axis)")
    if args.mesh:
        dp, mp = (int(x) for x in args.mesh.split(","))
        if (args.cp or args.tp) and mp < 2:
            ap.error("--cp/--tp need a model axis >= 2")
        if mp > 1 and not (args.cp or args.tp):
            # a bare model axis would run vocab-TP while the banner said
            # data-parallel: make the placement explicit instead
            ap.error("--mesh with a model axis > 1 requires --cp or --tp")
        args.procs = dp * mp
        mesh_shape = (dp, mp)
    else:
        mesh_shape = (1, args.procs) if (args.cp or args.tp) else (args.procs, 1)

    if (os.environ.get("SAT_TORCH_DEVICE") or "cuda") != "cpu":
        import torch

        if not torch.cuda.is_available():
            print("FAIL: no CUDA device is visible; run under SAT_TORCH_DEVICE=cpu to run the ranks "
                  "on the CPU")
            return 1

    from ..cli import _parse_override
    from .fixtures import make_coco_fixture

    os.makedirs(args.root, exist_ok=True)
    fx = make_coco_fixture(args.root)
    config = fx["config"].replace(
        image_size=32, dim_embedding=16, num_lstm_units=16,
        dim_initialize_layer=16, dim_attend_layer=16, dim_decode_layer=32,
        compute_dtype="float32", num_epochs=1, save_period=0, log_every=1,
        mesh_shape=mesh_shape,
        context_parallel=mesh_shape[1] if args.cp else 1,
        batch_size=4, beam_size=2,
        num_data_workers=2, max_eval_ann_num=8,
        # beam-0 alphas ride the cross-rank gather; every rank renders its
        # interleaved share of the panels (runtime._local_render_rows)
        save_attention_maps=True,
    )
    if args.fleet:
        # straggler visibility needs sparse log boundaries: each one syncs
        # the ranks, so the slow rank's stall should show in its own step
        # spans and not be spread over the fleet's
        config = config.replace(
            telemetry=True, fleet_telemetry=True,
            fleet_dir=os.path.join(args.root, "fleet"),
            straggler_factor=1.5,
            num_epochs=40, max_steps=40, log_every=20,
        )
    if args.extra_set:
        config = config.replace(**{
            key: _parse_override(config, key, raw)
            for key, _, raw in (item.partition("=") for item in args.extra_set)
        })
    config.save(os.path.join(args.root, "config.json"))
    # a reused --root must not inflate the panel-coverage check
    for f in glob.glob(os.path.join(config.eval_result_dir, "*_attention.jpg")):
        os.remove(f)
    for f in glob.glob(os.path.join(args.root, "scores_p*.json")) + glob.glob(
            os.path.join(args.root, "tally_p*.json")):
        os.remove(f)

    port = args.port
    for attempt in range(ATTEMPTS):
        ok, outputs, rcs = run_workers(args, port)
        if ok:
            break
        failed = [outputs[p] for p, rc in enumerate(rcs) if rc != 0]
        # retry only when every failed rank shows the rendezvous signature:
        # a rank that crashed for its own reason fails the demo at once
        if not failed or not all(RENDEZVOUS_FLAKE.search(out) for out in failed):
            print("FAIL: a worker exited nonzero")
            return 1
        port += 1   # the old store port may linger in TIME_WAIT
        print(f"rendezvous flake (attempt {attempt + 1}/{ATTEMPTS}); relaunching the ranks on port {port}",
              flush=True)
    else:
        print(f"FAIL: the rendezvous failed on every attempt ({ATTEMPTS})")
        return 1

    if args.tp and any("TP verified" not in outputs[p] for p in range(args.procs)):
        print("FAIL: a worker did not verify TP sharding over 'model'")
        return 1

    scores = []
    for p in range(args.procs):
        with open(os.path.join(args.root, f"scores_p{p}.json")) as f:
            scores.append(json.load(f))
    if not scores[0] or any(s != scores[0] for s in scores[1:]):
        print("FAIL: hosts disagree on eval scores")
        return 1

    # each rank rendered only its share of the panels, so full coverage
    # proves the cross-rank alpha gather and the render partition
    with open(config.eval_result_file) as f:
        results = json.load(f)
    panels = glob.glob(os.path.join(config.eval_result_dir, "*_attention.jpg"))
    if len(panels) != len(results):
        print(f"FAIL: {len(panels)} attention panels for {len(results)} decoded images")
        return 1

    if args.check_loss_parity:
        # the control trains in its own process, then the trajectories must
        # agree: the same global batch stream, init and dropout masks,
        # differing only in the collectives' reduction order (which Adam
        # amplifies over steps: a tight first step, a looser trajectory)
        base = _base_env()
        for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
            base.pop(var, None)
        ctl = subprocess.run(
            [sys.executable, "-u", "-m", "sat_tpu_torch.tools.multihost_demo", "--control", args.root],
            capture_output=True, text=True, cwd=REPO, env=base, timeout=args.join_timeout,
        )
        if ctl.returncode != 0:
            print(f"FAIL: loss-parity control: {ctl.stdout[-1500:]}\n{ctl.stderr[-1000:]}")
            return 1
        got = _losses(os.path.join(args.root, "summary_p0"))
        want = _losses(os.path.join(args.root, "summary_control"))
        if len(got) != len(want):
            print(f"FAIL: loss parity: {len(got)} vs {len(want)} steps")
            return 1
        first_rel = abs(got[0] - want[0]) / max(abs(want[0]), 1e-9)
        max_rel = max(abs(a - b) / max(abs(b), 1e-9) for a, b in zip(got, want))
        if first_rel > 1e-3 or max_rel > 5e-2:
            print(f"FAIL: loss parity: first-step rel {first_rel:.2e} (>1e-3) or trajectory rel "
                  f"{max_rel:.2e} (>5e-2)\nmesh: {got}\ncontrol: {want}")
            return 1
        print(f"loss parity vs single-process control: first step rel {first_rel:.2e}, "
              f"trajectory max rel {max_rel:.2e} over {len(got)} steps")

    if args.fleet:
        fleet_path = os.path.join(args.root, "fleet", "fleet.json")
        try:
            with open(fleet_path) as f:
                fleet_doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"FAIL: fleet.json missing/unreadable ({e})")
            return 1
        if fleet_doc.get("hosts_reporting") != args.procs:
            print(f"FAIL: fleet.json reports {fleet_doc.get('hosts_reporting')} hosts, expected {args.procs}")
            return 1
        verdict = fleet_doc.get("straggler", {})
        if not verdict.get("verdict") or verdict.get("process_index") != 0:
            print(f"FAIL: expected worker 0 named as straggler, got {verdict}")
            return 1
        print(f"fleet verdict: p{verdict['process_index']} ({verdict.get('host')}) is the straggler at "
              f"{verdict.get('skew')}x the fleet median (factor {verdict.get('factor')}); "
              f"{fleet_doc['hosts_reporting']} hosts merged")

    mode = "context-parallel" if args.cp else "tensor-parallel" if args.tp else "data-parallel"
    if args.mesh:
        mode = f"mesh {mesh_shape[0]}x{mesh_shape[1]} {mode}"
    print(f"MULTIHOST OK ({mode}): {args.procs} processes, scores agree: "
          f"Bleu_4={scores[0]['Bleu_4']:.3f}; {len(panels)} attention panels rendered across hosts")
    return 0


if __name__ == "__main__":
    sys.exit(main())
