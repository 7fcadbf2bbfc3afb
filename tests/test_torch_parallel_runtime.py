"""The port's mesh runtime end to end on the CPU: the CLI under
``torchrun`` (``python -m torch.distributed.run --standalone
--nproc_per_node 2``) with ``SAT_TORCH_DEVICE=cpu``, each launch training
6 steps and then evaluating in the same ranks, on the session COCO
fixture at ``tests/test_runtime.py``'s small size; then an elastic resume
of the (2, 1) run's checkpoint in one process; and the lineage sidecar's
topology held against the one ``sat_tpu`` writes.

Held: the (2, 1) run's losses at every step within 1e-4 of the
single-process run's (the same batches and dropout masks; the sum order
differs), its checkpoint within 1e-4 of the single-process one, its
results.json the single-process eval's words; ``fleet.json`` with both
ranks' rows; each rank's own telemetry directory.  The context-parallel
(1, 2) run's loss falls and its eval's words are the single-process
eval's of the same checkpoint (float32).
"""

import json
import os

import numpy as np
import pytest
import torch

from sat_tpu_torch import runtime, telemetry
from sat_tpu_torch.config import Config
from sat_tpu_torch.resilience import lineage
from sat_tpu_torch.train.checkpoint import load_flat
from tests.torch_dist_helpers import run_ranks, torchrun

torch.set_num_threads(2)

SMALL = dict(
    image_size=32, dim_embedding=16, num_lstm_units=16, dim_initialize_layer=16, dim_attend_layer=16,
    dim_decode_layer=32, compute_dtype="float32", save_period=3, log_every=1, num_epochs=1, num_data_workers=2,
    beam_size=2,
)


def _config(coco_fixture, root: str, **kw) -> Config:
    base = Config.from_dict(coco_fixture["config"].to_dict())
    os.makedirs(root, exist_ok=True)
    return base.replace(**{
        **SMALL, "save_dir": os.path.join(root, "models"), "summary_dir": os.path.join(root, "summary"),
        "temp_annotation_file": os.path.join(root, "anns.csv"), "temp_data_file": os.path.join(root, "data.npy"),
        "eval_result_file": os.path.join(root, "results.json"), "eval_result_dir": os.path.join(root, "eval"),
        **kw,
    })


def _losses(config):
    with open(os.path.join(config.summary_dir, "metrics.jsonl")) as f:
        return [json.loads(line)["total_loss"] for line in f]


def _words(path):
    with open(path) as f:
        return {r["image_id"]: r["caption"] for r in json.load(f)}


def _launch(config, extra_train=()):
    path = os.path.join(os.path.dirname(config.save_dir), "config.json")
    config.save(path)
    out = torchrun(2, [["--config", path, "--phase", "train", *extra_train], ["--config", path, "--phase", "eval"]],
                   {})
    assert out.returncode == 0, f"{out.stdout[-3000:]}\n{out.stderr[-5000:]}"
    return out


@pytest.fixture(scope="module")
def single(coco_fixture, tmp_path_factory):
    """The single-process run the meshes are held against: 6 steps, then
    the eval of its final checkpoint."""
    config = _config(coco_fixture, str(tmp_path_factory.mktemp("single")))
    runtime.train(config, device="cpu")
    runtime.evaluate(config, device="cpu")
    return config


def test_data_parallel_launch_trains_and_evaluates_as_one_process(coco_fixture, single, tmp_path, capsys):
    config = _config(coco_fixture, str(tmp_path / "dp"), mesh_shape=(2, 1))
    out = _launch(config, ["--fleet_telemetry"])
    assert "2 ranks (2 on this host), backend gloo, rank 0 on cpu" in out.stderr
    np.testing.assert_allclose(_losses(config), _losses(single), rtol=1e-4)
    assert lineage.checkpoint_steps(config.save_dir) == [3, 6]
    got, want = load_flat(os.path.join(config.save_dir, "6.npz")), load_flat(os.path.join(single.save_dir, "6.npz"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)
    # rank 0 alone writes results; they are the single-process eval's
    assert _words(config.eval_result_file) == _words(single.eval_result_file)
    # the fleet plane: both ranks' sidecars merged by rank 0; each rank its
    # own telemetry directory
    tdir = os.path.join(config.summary_dir, "telemetry")
    fleet = json.load(open(os.path.join(tdir, "fleet.json")))
    assert fleet["process_count"] == 2 and [h["process_index"] for h in fleet["hosts"]] == [0, 1]
    assert [h["step"] for h in fleet["hosts"]] == [6, 6]
    for r in (0, 1):
        beat = json.load(open(os.path.join(tdir, f"rank{r}", "heartbeat.json")))
        assert (beat["process_index"], beat["process_count"], beat["collective_backend"]) == (r, 2, "gloo")
    # the lineage sidecar records the launch's topology
    topo = lineage.read_sidecar_meta(os.path.join(config.save_dir, "6.npz"))["topology"]
    assert topo == {"device_count": 2, "platform": "cpu", "process_count": 2, "mesh_shape": [2, 1],
                    "mesh_axes": ["data", "model"]}

    # elastic resume: the (2, 1) checkpoint continued by one process
    resumed = config.replace(mesh_shape=(1, 1), max_steps=8, num_epochs=2, telemetry=True,
                             telemetry_dir=str(tmp_path / "tel"), heartbeat_interval=0.05)
    try:
        state = runtime.setup_train_state(resumed, load=True, device="cpu")
        assert state.step == 6
        runtime.train(resumed, state=state, device="cpu")
        counters = telemetry.get().counters()
    finally:
        telemetry.disable()
    assert counters.get("ckpt/elastic_restores") == 1
    assert "elastic resume — checkpoint 6.npz was written on 2 device(s) (mesh [2, 1])" in capsys.readouterr().err
    assert lineage.last_good_step(config.save_dir) == 8
    topo = lineage.read_sidecar_meta(os.path.join(config.save_dir, "8.npz"))["topology"]
    assert (topo["process_count"], topo["mesh_shape"]) == (1, [1, 1])


def test_context_parallel_launch_trains_and_evaluates(coco_fixture, tmp_path):
    config = _config(coco_fixture, str(tmp_path / "cp"), mesh_shape=(1, 2), context_parallel=2)
    _launch(config)
    losses = _losses(config)
    assert len(losses) == 6 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    # the eval of the checkpoint it wrote, decoded context-parallel, is the
    # single-process eval's of the same checkpoint
    plain = config.replace(mesh_shape=(1, 1), context_parallel=1,
                           eval_result_file=str(tmp_path / "plain.json"))
    runtime.evaluate(plain, device="cpu")
    assert _words(config.eval_result_file) == _words(plain.eval_result_file)


def test_lineage_topology_has_sat_tpus_keys_and_values(tmp_path):
    """A single-process checkpoint's sidecar topology: the keys JAX writes
    for the same config, and its values — but ``device_count``, which
    counts the mesh's ranks here (one) and the JAX host's devices there."""
    import jax

    from sat_tpu.config import Config as JaxConfig
    from sat_tpu.resilience import lineage as jax_lineage
    from sat_tpu.train.checkpoint import save_checkpoint as jax_save
    from sat_tpu.train.step import create_train_state as jax_state
    from sat_tpu_torch.train.checkpoint import save_checkpoint
    from sat_tpu_torch.train.step import create_train_state
    from tests.torch_port_helpers import SMALL_MODEL

    knobs = dict(SMALL_MODEL, cnn="vgg16")
    jc = JaxConfig(**knobs, save_dir=str(tmp_path / "jax"))
    tc = Config(**knobs, save_dir=str(tmp_path / "port"))
    jpath = jax_save(jax_state(jax.random.PRNGKey(0), jc), jc)
    tpath = save_checkpoint(create_train_state(tc, torch.Generator().manual_seed(0)), tc)
    want = jax_lineage.read_sidecar_topology(jpath)
    got = lineage.read_sidecar_meta(tpath)["topology"]
    assert sorted(got) == sorted(want)
    assert {k: v for k, v in got.items() if k != "device_count"} == {
        k: v for k, v in want.items() if k != "device_count"}
    assert got["device_count"] == got["process_count"] == 1


def test_a_signal_to_one_rank_stops_every_rank_at_the_same_step(coco_fixture, tmp_path):
    """SIGTERM reaches rank 1 alone (``SAT_FI_SIGTERM_AT_STEP=2`` in its
    environment only, delivered before step 2 is dispatched): the ranks
    agree the stop, so both leave the loop at step 2, save together (the
    gather before the write) and return, where
    a stop taken by one rank alone would leave the other in the next
    step's collectives."""
    config = _config(coco_fixture, str(tmp_path / "run"), mesh_shape=(2, 1), save_period=0, num_epochs=3)
    args = {"config": {k: v for k, v in config.to_dict().items() if k in Config.__dataclass_fields__}}
    ranks = run_ranks(2, ["train_run"], args, str(tmp_path / "ranks"), timeout=150,
                      env={1: {"SAT_FI_SIGTERM_AT_STEP": "2"}})
    assert [r["train_run"]["step"] for r in ranks] == [2, 2]
    assert lineage.checkpoint_steps(config.save_dir) == [2]
