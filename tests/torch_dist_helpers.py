"""Multi-process runs of sat_tpu_torch's parallel layer for the CPU tests.

``run_ranks(world, case, args, tmp)`` starts ``world`` processes as a
``torchrun`` launch would (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``) with
``SAT_TORCH_DEVICE=cpu``, so every rank joins a gloo group on the CPU.
Each runs the cases named in ``case`` (functions below, ``CASES``) on the
pickled ``args`` and pickles its result; the list of the ranks' results
comes back.  The ranks import torch and the port only, never jax: the
test process holds the JAX side.

Run as a script under ``torchrun`` with ``cli`` and a JSON list of
argument lists, it calls ``sat_tpu_torch.cli.main`` on each in turn in
the same processes (one launch runs train and then eval).
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys
from typing import Any, Dict, List

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> Dict[str, str]:
    env = {k: v for k, v in os.environ.items() if not k.startswith(("SAT_FI_", "JAX_", "XLA_"))}
    env.update(
        RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), SAT_TORCH_DEVICE="cpu", OMP_NUM_THREADS="2",
        PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
    )
    return env


def run_ranks(world: int, cases: List[str], args: Dict[str, Any], tmp: str, timeout: float = 240.0,
              env: Dict[int, Dict[str, str]] = None) -> List[Any]:
    """Run ``cases`` in ``world`` gloo ranks on the CPU; each rank's
    results ({case: value}), in rank order.  ``env``: variables added to
    one rank's environment ({rank: {name: value}})."""
    os.makedirs(tmp, exist_ok=True)
    arg_path = os.path.join(tmp, "args.pkl")
    with open(arg_path, "wb") as f:
        pickle.dump({"cases": cases, "args": args}, f)
    port = free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", "from tests.torch_dist_helpers import worker; worker()", arg_path,
             os.path.join(tmp, f"rank{r}.pkl")],
            cwd=REPO, env={**rank_env(r, world, port), **(env or {}).get(r, {})}, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        for r in range(world)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, outs[r][1][-4000:]) for r, p in enumerate(procs) if p.returncode]
    if failed:
        raise AssertionError(f"ranks failed: {failed}")
    results = []
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.pkl")
        with open(path, "rb") as f:
            results.append(pickle.load(f))
        os.remove(path)
    os.remove(arg_path)
    return results


def torchrun(nproc: int, argvs: List[List[str]], env: Dict[str, str], timeout: float = 300.0):
    """``python -m torch.distributed.run --standalone --nproc_per_node N``
    over this file's ``cli`` entry with ``argvs`` run in turn; returns the
    completed process (stdout, stderr, returncode)."""
    full = {k: v for k, v in os.environ.items() if not k.startswith(("SAT_FI_", "JAX_", "XLA_"))}
    full.update(SAT_TORCH_DEVICE="cpu", OMP_NUM_THREADS="2", PYTHONPATH=REPO, **env)
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc),
         os.path.join(REPO, "tests", "torch_dist_helpers.py"), "cli", json.dumps(argvs)],
        cwd=REPO, env=full, capture_output=True, text=True, timeout=timeout,
    )


# ---------------------------------------------------------------------------
# rank side (no jax below)
# ---------------------------------------------------------------------------


def _config(args):
    from sat_tpu_torch.config import Config

    return Config(**args["config"])


def _rows(mesh, x: np.ndarray) -> np.ndarray:
    """This rank's rows of a global batch array."""
    dp, d = mesh.size("data"), mesh.index("data")
    bl = x.shape[0] // dp
    return x[d * bl:(d + 1) * bl]


def _params(config, flat):
    """(params, batch statistics) from ``flat``; a CNN it does not carry
    (a case on precomputed contexts, where the frozen CNN runs nothing) is
    drawn from the port's initializer."""
    import torch

    from sat_tpu_torch.models.captioner import init_variables
    from sat_tpu_torch.train.checkpoint import batch_stats_from_flat, params_from_flat, params_to_flat

    if not any(k.startswith("params/cnn/") for k in flat):
        params, _ = init_variables(config, torch.Generator().manual_seed(0))
        flat = {**{k: v for k, v in params_to_flat(params).items() if k.startswith("params/cnn/")}, **flat}
    return params_from_flat(flat, config), batch_stats_from_flat(flat, config)


def _kept(flat, keep):
    return {k: v for k, v in flat.items() if k.startswith(tuple(keep))}


def _state(config, flat, mesh):
    from sat_tpu_torch.parallel.sharding import shard_train_state
    from sat_tpu_torch.runtime import placement_config
    from sat_tpu_torch.train.step import state_from_params

    params, stats = _params(config, flat)
    state = state_from_params(params, config, batch_stats=stats)
    return shard_train_state(state, placement_config(config), mesh)


def case_train_steps(args, mesh):
    """Train steps of this mesh over the global batches ``args['batches']``:
    each step's metrics, and the state after under the names starting
    with ``args['keep']`` (default the decoder's): full (the sharded
    leaves gathered) and this rank's own leaves."""
    import torch

    from sat_tpu_torch.train.checkpoint import named_leaves, params_to_flat
    from sat_tpu_torch.train.step import make_train_step, step_generator
    from sat_tpu_torch.utils.dist import gather_tree_replicated

    config = _config(args)
    state = _state(config, args["flat"], mesh)
    step = make_train_step(config, mesh=mesh)
    metrics = []
    for s, batch in enumerate(args["batches"]):
        local = {k: torch.from_numpy(np.ascontiguousarray(_rows(mesh, v))) for k, v in batch.items()}
        state, m = step(state, local, step_generator(args.get("seed", 0), s, "cpu"))
        metrics.append({k: float(v) for k, v in m.items()})
    keep = args.get("keep", ("params/decoder/",))
    full = gather_tree_replicated(state.params, config, mesh)
    flat = params_to_flat(full)
    flat.update({name: t.detach().numpy().copy() for name, t, _ in named_leaves(state.batch_stats, "batch_stats/")})
    # this rank's own leaves as they are (bitwise across the model group)
    own = params_to_flat(state.params)
    return {"metrics": metrics, "flat": _kept(flat, keep), "own": _kept(own, keep)}


def case_decode(args, mesh):
    """``parallel.train.mesh_decode_batch`` over this rank's rows of
    ``args['images']``: its beam results."""
    import torch

    from sat_tpu_torch.parallel.train import mesh_decode_batch, place_params
    from sat_tpu_torch.train.checkpoint import compute_params

    config = _config(args)
    params, stats = _params(config, args["flat"])
    params = compute_params(params, config, stats)
    params = place_params(params, config, mesh)
    images = torch.from_numpy(np.ascontiguousarray(_rows(mesh, args["images"])))
    out = mesh_decode_batch(params, config, images, args["eos"], args["valid_size"], mesh,
                            return_alphas=True)
    return {k: getattr(out, k).numpy() for k in ("words", "lengths", "log_scores", "alphas")}


def case_loss_grads(args, mesh):
    """The mesh's loss on this rank's rows of ``args['batch']`` (precomputed
    contexts): the global metrics with ``train=False``, and with
    ``train=True`` (dropout off) the gradients of the decoder's leaves
    after the data group's sum, full arrays."""
    import torch

    from sat_tpu_torch.models.captioner import compute_loss
    from sat_tpu_torch.parallel.collectives import flat_all_reduce_
    from sat_tpu_torch.parallel.sharding import walk

    config = _config(args)
    out = {}
    for remat in (False, True):
        cfg = config.replace(remat_decoder=remat)
        params, _ = _params(cfg, args["flat"])
        batch = {k: torch.from_numpy(np.ascontiguousarray(_rows(mesh, v))) for k, v in args["batch"].items()}
        leaves = [(p, t.requires_grad_(True)) for p, t in walk(params["decoder"])]
        if not remat:
            with torch.no_grad():
                _, aux = compute_loss(params, cfg, batch, None, train=False, mesh=mesh)
            out["eval_metrics"] = {k: float(v) for k, v in aux["metrics"].items()}
        total, aux = compute_loss(params, cfg, batch, torch.Generator().manual_seed(1), train=True, mesh=mesh)
        grads = list(torch.autograd.grad(total, [t for _, t in leaves]))
        flat_all_reduce_(grads, mesh.group("data"))
        out["remat" if remat else "plain"] = {
            "metrics": {k: float(v) for k, v in aux["metrics"].items()},
            "grads": {"/".join(p): g.numpy().copy() for (p, _), g in zip(leaves, grads)},
        }
    return out


def case_masks(args, mesh):
    """Dropout masks of a context-parallel step's two generators, at the
    step generator of ``args['step']``: a replicated tensor's (the shared
    generator) and a context-sharded tensor's (the model index folded in)."""
    import torch

    from sat_tpu_torch.nn.layers import BatchRows, dropout
    from sat_tpu_torch.parallel.context import shard_generator
    from sat_tpu_torch.train.step import step_generator

    B = args["batch"]
    gen = step_generator(0, args["step"], "cpu")
    rows = BatchRows(gen, mesh.index("data") * B // mesh.size("data"), B) if mesh.size("data") > 1 else gen
    own = shard_generator(rows, mesh.index("model"))
    ones = torch.ones((B // mesh.size("data"), 64))
    return {"replicated": dropout(ones, 0.5, rows).numpy(), "sharded": dropout(ones, 0.5, own).numpy()}


def case_collectives(args, mesh):
    """The explicit collectives on rank-dependent values: the mean over the
    data axis, the full batch from each data rank's rows, the host
    gather, the agreed stop flag, a zero-padded gather over the model
    axis."""
    import torch

    from sat_tpu_torch.parallel import collectives as c

    r, d, m = mesh.rank, mesh.index("data"), mesh.index("model")
    rows = torch.arange(3, dtype=torch.float32) + 10 * d
    return {
        "mean": float(c.cross_replica_mean(torch.tensor(float(d)), mesh)),
        "batch": c.all_gather_batch(rows, mesh),
        "objects": c.gather_objects({"rank": r}, mesh),
        "stop": bool(c.agree_any(torch.tensor(r == mesh.world - 1), mesh.group("model"))),
        "block": c.zero_padded_gather(torch.full((2, 3), float(m + 1)), 1, m, mesh.size("model"),
                                      mesh.group("model")).numpy(),
    }


def case_train_run(args, mesh):
    """``runtime.train`` on this rank (the device from the environment):
    the step it ended at."""
    from sat_tpu_torch import runtime

    return {"step": runtime.train(_config(args)).step}


CASES = {
    "collectives": case_collectives,
    "train_run": case_train_run,
    "train_steps": case_train_steps,
    "decode": case_decode,
    "loss_grads": case_loss_grads,
    "masks": case_masks,
}


def worker() -> None:
    """A rank: join the group, run the pickled cases, pickle the results."""
    import torch

    torch.set_num_threads(2)
    from sat_tpu_torch.config import Config
    from sat_tpu_torch.parallel.mesh import initialize_distributed, make_mesh, shutdown_distributed

    with open(sys.argv[1], "rb") as f:
        job = pickle.load(f)
    initialize_distributed()
    try:
        results = {}
        for name in job["cases"]:
            args = job["args"][name] if name in job["args"] else job["args"]
            items = args if isinstance(args, list) else [args]
            out = []
            for item in items:
                mesh = make_mesh(Config(**item["config"]))
                out.append(CASES[name.split(":")[0]](item, mesh))
            results[name] = out if isinstance(args, list) else out[0]
        with open(sys.argv[2], "wb") as f:
            pickle.dump(results, f)
    finally:
        shutdown_distributed()


def _cli_main() -> int:
    """Under torchrun: ``sat_tpu_torch.cli.main`` on each argument list in
    turn, in this process; the first non-zero exit ends the run."""
    from sat_tpu_torch import cli
    from sat_tpu_torch.parallel.mesh import initialize_distributed, shutdown_distributed

    initialize_distributed()
    try:
        for argv in json.loads(sys.argv[2]):
            rc = cli.main(argv)
            if rc:
                return rc
        return 0
    finally:
        shutdown_distributed()


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "cli":
    sys.path.insert(0, REPO)
    sys.exit(_cli_main())
