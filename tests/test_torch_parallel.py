"""The port's parallel layer held against sat_tpu's mesh on the CPU.

The launch bootstrap and the device and backend rule, the mesh layout,
the placement rule and the per-rank feed are held against the JAX
package in this process.  The train step and the mesh decode run as gloo
ranks on the CPU (``tests/torch_dist_helpers.py``), on the weights of
``sat_tpu``'s ``create_train_state`` / ``init_variables`` through the npz
bridge, and are held against the JAX package's single-device step and
search: metrics and updated parameters within ``rtol 2e-4, atol 2e-5``
(``tests/test_parallel.py``'s bounds), dropout off; decoded words
identical and alphas within 1e-5.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.config import Config as JaxConfig
from sat_tpu.data.dataset import DataSet as JaxDataSet
from sat_tpu.models import init_variables
from sat_tpu.models.captioner import encode as jax_encode
from sat_tpu.ops.beam_search import beam_search as jax_beam_search
from sat_tpu.parallel import data as jax_data
from sat_tpu.parallel import make_mesh as jax_make_mesh
from sat_tpu.parallel.sharding import param_partition_specs, train_state_shardings
from sat_tpu.train.checkpoint import flatten_with_names
from sat_tpu.train.step import create_train_state, make_jit_train_step
from sat_tpu_torch.config import Config
from sat_tpu_torch.data.dataset import DataSet
from sat_tpu_torch.parallel import data as port_data
from sat_tpu_torch.parallel import mesh as port_mesh
from sat_tpu_torch.parallel.sharding import leaf_dim
from tests.torch_dist_helpers import run_ranks

torch.set_num_threads(2)

# tests/test_parallel.py's tiny model, dropout off
TINY = dict(
    cnn="vgg16", vocabulary_size=64, dim_embedding=16, num_lstm_units=16, dim_initialize_layer=16,
    dim_attend_layer=16, dim_decode_layer=32, max_caption_length=4, batch_size=8, compute_dtype="float32",
    fc_drop_rate=0.0, lstm_drop_rate=0.0,
)
# a small decoder at 32 px (N = 4) for the search
SEARCH = dict(
    image_size=32, vocabulary_size=50, dim_embedding=8, num_lstm_units=8, dim_initialize_layer=8,
    dim_attend_layer=16, dim_decode_layer=16, max_caption_length=6, compute_dtype="float32", beam_size=3,
)


def _flat(tree, prefix="params/"):
    return {k: np.asarray(v) for k, v in flatten_with_names(tree, prefix).items()}


# ---------------------------------------------------------------------------
# bootstrap, device rule, mesh, placement, feed (in this process)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "env,want",
    [
        ({}, None),
        ({"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}, None),
        ({"WORLD_SIZE": "4", "RANK": "3", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"},
         {"rank": 3, "world": 4, "local_rank": 1, "local_world": 2}),
        ({"SLURM_STEP_NODELIST": "n1", "SLURM_NTASKS": "1"}, None),
        ({"SLURM_STEP_NODELIST": "n[1-2]", "SLURM_STEP_NUM_TASKS": "4", "SLURM_PROCID": "2",
          "SLURM_LOCALID": "0", "SLURM_STEP_TASKS_PER_NODE": "2(x2)", "MASTER_ADDR": "n1",
          "MASTER_PORT": "29500"},
         {"rank": 2, "world": 4, "local_rank": 0, "local_world": 2}),
    ],
    ids=["none", "torchrun-1", "torchrun-4", "slurm-1", "slurm-4"],
)
def test_launch_env_reads_torchrun_and_slurm(monkeypatch, env, want):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "SLURM_STEP_NODELIST", "SLURM_NTASKS",
                "SLURM_STEP_NUM_TASKS", "SLURM_PROCID", "SLURM_LOCALID", "SLURM_STEP_TASKS_PER_NODE",
                "SLURM_NTASKS_PER_NODE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert port_mesh.launch_env() == want
    if want is None:  # a plain single process joins nothing
        assert port_mesh.initialize_distributed() is False


def test_launch_env_refuses_a_partial_torchrun_env(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        port_mesh.launch_env()


@pytest.mark.parametrize(
    "cards,local_world,local_rank,want",
    [
        (2, 2, 1, ("cuda:1", "nccl")),       # a card per local rank
        (8, 4, 3, ("cuda:3", "nccl")),
        (1, 2, 1, ("cuda:0", "gloo")),       # the host's one card, shared
        (1, 1, 0, ("cuda:0", "nccl")),
        (2, 4, 0, "raise"),                  # neither rule fits
        (0, 2, 0, "raise"),                  # no card, and the CPU not asked for
    ],
)
def test_device_and_backend_rule(monkeypatch, cards, local_world, local_rank, want):
    """Decided from LOCAL_WORLD_SIZE and the visible cards before the
    group exists, never by catching an error."""
    monkeypatch.delenv("SAT_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if want == "raise":
        with pytest.raises(RuntimeError):
            port_mesh.device_rule(local_rank, local_world)
        return
    device, backend = port_mesh.device_rule(local_rank, local_world)
    assert (str(device), backend) == want
    monkeypatch.setenv("SAT_TORCH_DEVICE", "cpu")
    assert port_mesh.device_rule(local_rank, local_world) == (torch.device("cpu"), "gloo")


def test_a_mesh_in_a_single_process_raises_with_the_launch_command():
    with pytest.raises(RuntimeError, match="torch.distributed.run --standalone --nproc_per_node 2"):
        port_mesh.make_mesh(Config(mesh_shape=(2, 1)))
    with pytest.raises(RuntimeError, match="--nproc_per_node 4"):
        port_mesh.make_mesh(Config(mesh_shape=(2, 2)))
    one = port_mesh.make_mesh(Config(mesh_shape=(0, 1)))    # 0 takes the one rank there is
    assert (one.shape, one.world, one.coords) == ((1, 1), 1, {"data": 0, "model": 0})
    with pytest.raises(ValueError, match="cannot infer"):
        port_mesh.make_mesh(Config(mesh_shape=(0, 0)))


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (4, 2), (2, 4)])
def test_ranks_lay_out_data_major_as_jax_reshapes_devices(shape):
    """Rank r of the port's mesh sits where JAX's ``mesh_from_devices``
    puts device r, and its axis groups are the ranks sharing the other
    coordinate."""
    jmesh = jax_make_mesh(JaxConfig(mesh_shape=shape))
    ids = np.vectorize(lambda d: d.id)(np.asarray(jmesh.devices))
    for r in range(int(np.prod(shape))):
        m = port_mesh.Mesh(shape, ("data", "model"), r, None, "", {}, None)
        assert ids[m.index("data"), m.index("model")] == r


def test_placement_rule_matches_jax_for_params_and_adam_slots():
    jc = JaxConfig(**TINY, mesh_shape=(4, 2))
    jmesh = jax_make_mesh(jc)
    state = jax.eval_shape(lambda r: create_train_state(r, jc), jax.random.PRNGKey(0))
    tc = Config(**TINY, mesh_shape=(4, 2))

    def model_dim(spec):
        return next((i for i, a in enumerate(spec) if a == "model"), None)

    specs = jax.tree_util.tree_leaves_with_path(param_partition_specs(state.params, jc, jmesh),
                                                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    leaves = dict(jax.tree_util.tree_leaves_with_path(state.params))
    sharded = 0
    for path, spec in specs:
        keys = tuple(str(getattr(p, "key", p)) for p in path)
        want = model_dim(spec)
        sharded += want is not None
        assert leaf_dim(keys, np.shape(leaves[path]), tc, 2) == want, keys
    assert sharded == 3   # the embedding, the last decode kernel and bias
    # Adam's slots carry the same rule
    slot_specs = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda s: s.spec, train_state_shardings(state, jc, jmesh).opt_state),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    slots = dict(jax.tree_util.tree_leaves_with_path(state.opt_state))
    for path, spec in slot_specs:
        keys = tuple(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p)))) for p in path)
        assert leaf_dim(keys, np.shape(slots[path]), tc, 2) == model_dim(spec), keys


def _fake_jax_mesh(shape):
    devices = np.array([types.SimpleNamespace(process_index=r, id=r) for r in range(int(np.prod(shape)))],
                       dtype=object).reshape(shape)
    return types.SimpleNamespace(axis_names=("data", "model"), devices=devices)


@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (1, 2), (2, 2), (1, 4)])
def test_mesh_data_shard_and_feed_match_jax(monkeypatch, shape):
    """One process a mesh position, as a torchrun launch has: each rank's
    ``mesh_data_shard`` is JAX's for the process holding that device, and
    the block of each global batch its view yields (the rows the loader
    keeps) is JAX's view's batch, for three epochs and after a mid-epoch
    seek."""
    world = int(np.prod(shape))
    monkeypatch.setattr(jax, "process_count", lambda: world)
    rng = np.random.default_rng(3)
    n, B = 21, 8
    ids, files = np.arange(n), np.array([f"f{i}.jpg" for i in range(n)])
    words, masks = rng.integers(0, 9, (n, 5)), rng.random((n, 5)).astype(np.float32)
    for r in range(world):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        want = jax_data.mesh_data_shard(_fake_jax_mesh(shape))
        got = port_data.mesh_data_shard(port_mesh.Mesh(shape, ("data", "model"), r, None, "", {}, None))
        assert got == want
        jds = jax_data.process_local_dataset(JaxDataSet(ids, files, B, words, masks, is_train=True, shuffle=True,
                                                        seed=5), *want)
        tds = port_data.process_local_dataset(DataSet(ids, files, B, words, masks, is_train=True, shuffle=True,
                                                      seed=5), *got)
        assert (tds.batch_size, tds.num_batches, tds.count) == (jds.batch_size, jds.num_batches, jds.count)
        block = slice(*getattr(tds, "block", (0, B)))
        for _ in range(3):
            for (jf, jw, jm), (tf, tw, tm) in zip(jds, tds, strict=True):
                assert jf.tolist() == tf[block].tolist()
                np.testing.assert_array_equal(jw, tw[block])
                np.testing.assert_array_equal(jm, tm[block])
        jds.seek(4, 1)
        tds.seek(4, 1)
        assert [f.tolist() for f, _, _ in jds] == [f[block].tolist() for f, _, _ in tds]


@pytest.mark.parametrize("dp", [2, 4])
def test_ranks_feed_the_single_process_batches_with_quarantined_rows(tmp_path, dp):
    """Captions that fill the whole caption length are quarantined and
    substituted by a healthy row of their batch.  The data ranks' blocks,
    put together, are the single process's batches element for element
    (images, captions, masks, files), the substitute taken from another
    rank's block where the single process takes it; and the ranks' shared
    ledger holds each quarantined row once, at its global position, as
    the single process's does."""
    import json

    import cv2

    from sat_tpu_torch.data.images import ImageLoader, PrefetchLoader
    from sat_tpu_torch.resilience.quarantine import QuarantineManager

    rng = np.random.default_rng(4)
    n, B, T = 21, 8, 6
    files = []
    for i in range(n):
        path = str(tmp_path / f"img{i}.jpg")
        cv2.imwrite(path, rng.integers(0, 255, (20, 20, 3), dtype=np.uint8))
        files.append(path)
    words = rng.integers(1, 9, (n, T))
    masks = (np.arange(T)[None, :] < rng.integers(2, T, (n, 1))).astype(np.float32)
    masks[[2, 9, 10, 17]] = 1.0          # these fill the caption length

    def run(ds, ledger, appends=True):
        loader = PrefetchLoader(ds, ImageLoader(size=16), num_workers=2,
                                quarantine=QuarantineManager(ledger, appends=appends))
        return [b for _ in range(2) for b in loader]

    one = run(DataSet(np.arange(n), files, B, words, masks, is_train=True, shuffle=True, seed=5),
              str(tmp_path / "one.jsonl"))
    ranks = []
    for r in range(dp):
        view = port_data.process_local_dataset(
            DataSet(np.arange(n), files, B, words, masks, is_train=True, shuffle=True, seed=5), r, dp)
        # a second model-axis peer of rank r feeds the same rows and writes nothing
        run(port_data.process_local_dataset(
            DataSet(np.arange(n), files, B, words, masks, is_train=True, shuffle=True, seed=5), r, dp),
            str(tmp_path / "mesh.jsonl"), appends=False)
        ranks.append(run(view, str(tmp_path / "mesh.jsonl")))
    substituted = 0
    for b, batch in enumerate(one):
        for k in ("images", "word_idxs", "masks"):
            np.testing.assert_array_equal(np.concatenate([rk[b][k] for rk in ranks]), batch[k])
        assert [f for rk in ranks for f in rk[b]["files"]] == batch["files"]
        substituted += len(batch["files"]) - len(set(batch["files"]))
    assert substituted >= 4

    def ledger(name):
        with open(tmp_path / name) as f:
            return sorted((e["reason"], tuple(e["pos"]), e["file"]) for e in map(json.loads, f))

    assert ledger("mesh.jsonl") == ledger("one.jsonl")
    assert len(ledger("one.jsonl")) == len(set(ledger("one.jsonl"))) >= 4


# ---------------------------------------------------------------------------
# the train step and the mesh decode, in gloo ranks
# ---------------------------------------------------------------------------


def _context_batch(seed):
    jc = JaxConfig(**TINY)
    rng = np.random.default_rng(seed)
    return {
        "contexts": rng.normal(size=(8, jc.num_ctx, jc.dim_ctx)).astype(np.float32),
        "word_idxs": rng.integers(0, TINY["vocabulary_size"], size=(8, 4)).astype(np.int32),
        "masks": (rng.random((8, 4)) > 0.25).astype(np.float32),
    }


@pytest.fixture(scope="module")
def jax_world():
    """JAX's single-device side: two train steps of the tiny model on two
    masked batches (rows of unequal mask sums), and one search."""
    jc = JaxConfig(**TINY)
    state = create_train_state(jax.random.PRNGKey(7), jc)
    flat = _flat(state.params)
    batches = [_context_batch(0), _context_batch(1)]
    step = make_jit_train_step(jc)
    metrics = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(11))
        metrics.append({k: float(v) for k, v in m.items()})
    sc = JaxConfig(**SEARCH)
    variables = init_variables(jax.random.PRNGKey(0), sc)
    images = np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    contexts, _ = jax_encode(variables, sc, jnp.asarray(images), train=False)
    search = jax_beam_search(variables["params"]["decoder"], sc, contexts, 1, valid_size=40, return_alphas=True)
    decoder = {k: v for k, v in flat.items() if k.startswith("params/decoder/")}
    return {
        "flat": decoder, "batches": batches, "metrics": metrics,
        "params": {k: v for k, v in _flat(state.params).items() if k.startswith("params/decoder/")},
        "search_flat": _flat(variables["params"]), "images": images,
        "search": {k: np.asarray(getattr(search, k)) for k in ("words", "lengths", "log_scores", "alphas")},
    }


@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (1, 2), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_train_steps_and_mesh_decode_match_jax_single_device(jax_world, shape, tmp_path):
    """Data parallelism ((2,1), (4,1)), vocab tensor parallelism ((1,2))
    and both ((2,2)): two steps' metrics and the updated parameters (the
    sharded leaves gathered full) within JAX's mesh-vs-single bounds, the
    replicated leaves bitwise equal over the model group; and the mesh's
    search over each data rank's rows: JAX's words and lengths exactly,
    alphas within 1e-5."""
    w = jax_world
    world = int(np.prod(shape))
    args = {
        "train_steps": {"config": {**TINY, "mesh_shape": shape}, "flat": w["flat"], "batches": w["batches"]},
        "decode": {"config": {**SEARCH, "mesh_shape": shape}, "flat": w["search_flat"], "images": w["images"],
                   "eos": 1, "valid_size": 40},
    }
    args["collectives"] = {"config": {**SEARCH, "mesh_shape": shape}}
    ranks = run_ranks(world, ["train_steps", "decode", "collectives"], args, str(tmp_path))
    dp, mp = shape
    for r, res in enumerate(ranks):
        col = res["collectives"]
        assert col["mean"] == (dp - 1) / 2
        np.testing.assert_array_equal(col["batch"], np.concatenate([np.arange(3) + 10 * d for d in range(dp)]))
        assert col["objects"] == [{"rank": q} for q in range(world)]
        assert col["stop"] == (mp > 1 and r // mp == dp - 1 or r == world - 1)
        np.testing.assert_array_equal(col["block"], np.repeat(np.arange(1, mp + 1, dtype=np.float32), 3)[None]
                                      .repeat(2, 0))
        got = res["train_steps"]
        for s in range(2):
            for k, v in w["metrics"][s].items():
                np.testing.assert_allclose(got["metrics"][s][k], v, rtol=2e-4, atol=2e-5, err_msg=f"{s} {k}")
        assert set(got["flat"]) == set(w["params"])
        for k, v in w["params"].items():
            np.testing.assert_allclose(got["flat"][k], v, rtol=2e-4, atol=2e-5, err_msg=k)
        # the model group's replicated leaves are bitwise one another's;
        # the sharded ones are blocks
        peer = ranks[r - r % shape[1]]["train_steps"]["own"]
        for k, v in got["own"].items():
            if v.shape == w["params"][k].shape:
                np.testing.assert_array_equal(v, peer[k], err_msg=k)
            else:
                assert shape[1] > 1 and v.size * shape[1] == w["params"][k].size, k
        rows = slice((r // shape[1]) * (4 // shape[0]), (r // shape[1] + 1) * (4 // shape[0]))
        dec = res["decode"]
        np.testing.assert_array_equal(dec["words"], w["search"]["words"][rows])
        np.testing.assert_array_equal(dec["lengths"], w["search"]["lengths"][rows])
        np.testing.assert_allclose(dec["log_scores"], w["search"]["log_scores"][rows], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(dec["alphas"], w["search"]["alphas"][rows], rtol=0, atol=1e-5)


def test_train_cnn_batch_statistics_are_global_over_the_data_group(tmp_path):
    """``train_cnn`` with ResNet50 on a (2, 1) mesh: the batch-norm
    moments are the global batch's (summed over the data group with their
    gradient), so one step equals JAX's single-device step — held in
    float64, as the single-device ResNet50 parity is (float32 batch norm at
    this size is ill-conditioned): each loss term within 1e-5 of the total
    loss, every parameter and running statistic within 1e-5."""
    from flax.traverse_util import unflatten_dict

    from sat_tpu.train.optimizer import make_optimizer as jax_make_optimizer
    from sat_tpu.train.step import TrainState as JaxTrainState
    from sat_tpu.train.step import make_train_step as jax_make_train_step
    from sat_tpu.train.step import split_trainable as jax_split_trainable
    from tests.test_torch_train import LOSSES, make_batch
    from tests.torch_port_helpers import configs, jax_variables

    knobs = dict(cnn="resnet50", image_size=64, fc_drop_rate=0.0, lstm_drop_rate=0.0)
    jc, tc = configs(**knobs)
    variables = jax_variables(jc)
    flat = {**_flat(variables["params"]), **_flat(variables["batch_stats"], "batch_stats/")}
    rng = np.random.default_rng(7)
    for name, value in sorted(flat.items()):
        if name.endswith("/mean"):
            flat[name] = rng.normal(0, 0.1, value.shape).astype(np.float32)
        elif name.endswith(("/var", "/scale")):
            flat[name] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
    f64 = dict(train_cnn=True, compute_dtype="float64")
    jc = jc.replace(**f64)
    batch = make_batch(tc, B=4, seed=21)
    with jax.enable_x64(True):
        nested = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
        trainable, _ = jax_split_trainable(nested["params"], jc)
        jstate = JaxTrainState(params=nested["params"], batch_stats=nested["batch_stats"],
                               opt_state=jax_make_optimizer(jc).init(trainable), step=jnp.zeros((), jnp.int32))
        jstate, want = jax.jit(jax_make_train_step(jc))(jstate, batch, jax.random.PRNGKey(0))
        want_flat = {**_flat(jstate.params), **_flat(jstate.batch_stats, "batch_stats/")}
    config = {**tc.to_dict(), **f64, "mesh_shape": (2, 1)}
    config = {k: v for k, v in config.items() if k in Config.__dataclass_fields__}
    args = {"config": config, "flat": flat, "batches": [batch], "keep": ("params/", "batch_stats/")}
    ranks = run_ranks(2, ["train_steps"], args, str(tmp_path))
    for res in ranks:
        got = res["train_steps"]
        total = float(want["total_loss"])
        for k in LOSSES:
            assert abs(got["metrics"][0][k] - float(want[k])) <= 1e-5 * total, k
        assert set(got["flat"]) == set(want_flat)
        for name, value in want_flat.items():
            np.testing.assert_allclose(got["flat"][name], value, rtol=0, atol=1e-5, err_msg=name)
