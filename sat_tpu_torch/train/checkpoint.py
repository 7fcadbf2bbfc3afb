"""Checkpoints and the weight bridge — the port of ``sat_tpu.train.checkpoint``.

Both packages share one on-disk format: a flat ``<step>.npz`` of
slash-joined names (``params/cnn/conv1_1/conv/kernel``,
``params/decoder/attend/fc_1a/kernel``, ``optimizer/...``,
``global_step``).  :func:`params_from_flat` turns those names into the
port's parameters and :func:`params_to_flat` turns them back, so a
checkpoint crosses in both directions:

* conv kernels are HWIO in the JAX package and OIHW here (``weight``);
* dense kernels stay ``[in, out]``, the LSTM kernel ``[E+D+H, 4H]`` and
  the word embedding ``[V, E]``, under their JAX names.

Optimizer state and ``global_step`` are skipped by name; any other name
this configuration does not have raises, and so does a missing one.

:func:`walk_back` picks the newest checkpoint of a save_dir that
verifies, :func:`state_from_flat` loads one as a :class:`ServingState`,
and :func:`compute_params` makes the copy of the params that every
decoding entry point (serving, eval, test) runs on.

The training side: :func:`state_to_flat` snapshots a ``TrainState``
(params, optax-layout optimizer slots under ``optimizer/``, and
``global_step``) into numpy arrays that own their bytes;
:func:`save_checkpoint` and :class:`AsyncCheckpointWriter` write it as an
atomic npz with the ``config.json`` sidecar and the lineage tail (sha256
sidecar with the vocabulary and the run's topology, verify,
``LAST_GOOD``, retention); :func:`restore_checkpoint` loads a file into
a ``TrainState`` in place, skipping names or shapes it does not have.

A mesh run's checkpoint holds full arrays, as the JAX package's does:
the save gathers the vocab-sharded leaves over the model group, rank 0
writes, and every rank waits for the write.  A restore under another
topology than the sidecar records (an elastic resume) is counted in
``ckpt/elastic_restores`` and said on stderr; on a vocab-parallel mesh
it loads each sharded leaf's block of the file's full array.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import telemetry
from ..config import Config
from ..models import resnet50
from ..models.vgg16 import VGG_LAYERS
from ..resilience import lineage
from ..resilience.faultinject import FaultPlan
from ..resilience.lineage import CheckpointWriteError
from ..resilience.retry import retry_io
from ..utils.fileio import atomic_write

Params = Dict[str, Any]


class VocabMismatchError(RuntimeError):
    """The checkpoint's sidecar attests another vocabulary than the one
    configured: decoding would map token ids to the wrong words."""


def param_shapes(config: Config) -> Dict[str, Tuple[int, ...]]:
    """Flat name → shape (JAX layout) of every parameter of ``config``'s
    model, and of ResNet50's running statistics (``batch_stats/...``): the
    names ``sat_tpu.models.init_variables`` creates."""
    c = config
    shapes: Dict[str, Tuple[int, ...]] = {}
    if c.cnn == "vgg16":
        cin = 3
        for name, features, _ in VGG_LAYERS:
            shapes[f"params/cnn/{name}/conv/kernel"] = (3, 3, cin, features)
            shapes[f"params/cnn/{name}/conv/bias"] = (features,)
            cin = features
    else:
        for block, conv, bn, k, cin, cout, _stride in resnet50.conv_specs():
            at = f"{block}/" if block else ""
            shapes[f"params/cnn/{at}{conv}/conv/kernel"] = (k, k, cin, cout)
            if conv == "conv1":
                shapes["params/cnn/conv1/conv/bias"] = (cout,)
            for leaf, prefix in (("scale", "params/cnn/"), ("bias", "params/cnn/"),
                                 ("mean", "batch_stats/"), ("var", "batch_stats/")):
                shapes[f"{prefix}{at}{bn}/{leaf}"] = (cout,)
    E, H, D, N, V = c.dim_embedding, c.num_lstm_units, c.dim_ctx, c.num_ctx, c.vocabulary_size
    dec = "params/decoder/"

    def dense(name, d_in, d_out, bias=True):
        shapes[f"{dec}{name}/kernel"] = (d_in, d_out)
        if bias:
            shapes[f"{dec}{name}/bias"] = (d_out,)

    shapes[f"{dec}word_embedding/weights"] = (V, E)
    shapes[f"{dec}lstm/kernel"] = (D + E + H, 4 * H)
    shapes[f"{dec}lstm/bias"] = (4 * H,)
    if c.num_initialize_layers == 1:
        dense("initialize/fc_a", D, H)
        dense("initialize/fc_b", D, H)
    else:
        di = c.dim_initialize_layer
        dense("initialize/fc_a1", D, di)
        dense("initialize/fc_a2", di, H)
        dense("initialize/fc_b1", D, di)
        dense("initialize/fc_b2", di, H)
    if c.num_attend_layers == 1:
        dense("attend/fc_a", D, 1, bias=False)
        dense("attend/fc_b", H, N, bias=False)
    else:
        da = c.dim_attend_layer
        dense("attend/fc_1a", D, da)
        dense("attend/fc_1b", H, da)
        dense("attend/fc_2", da, 1, bias=False)
    if c.num_decode_layers == 1:
        dense("decode/fc", H + D + E, V)
    else:
        dense("decode/fc_1", H + D + E, c.dim_decode_layer)
        dense("decode/fc_2", c.dim_decode_layer, V)
    return shapes


def _skipped(name: str) -> bool:
    return name == "global_step" or name.startswith("optimizer/")


def _unflatten(flat: Dict[str, np.ndarray], config: Config, prefix: str, device) -> Dict[str, Any]:
    """The entries of ``flat`` under ``prefix`` as nested dicts of float32
    tensors on ``device``; a conv's ``conv/kernel`` (HWIO) becomes the
    layer's ``weight`` (OIHW), its ``conv/bias`` the layer's ``bias``.
    Other prefixes but optimizer slots and ``global_step`` are refused by
    name; an unknown or missing name or a wrong shape raises."""
    expected = {k: v for k, v in param_shapes(config).items() if k.startswith(prefix)}
    tree: Dict[str, Any] = {}
    for name, value in flat.items():
        if not name.startswith(prefix):
            if not (_skipped(name) or name.startswith(("params/", "batch_stats/"))):
                raise KeyError(f"checkpoint entry {name!r} is not a parameter of this config")
            continue
        if name not in expected:
            raise KeyError(f"checkpoint entry {name!r} is not a parameter of this config")
        arr = np.asarray(value)
        if tuple(arr.shape) != expected[name]:
            raise ValueError(
                f"checkpoint entry {name!r} has shape {arr.shape}, config expects {expected[name]}"
            )
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        *keys, leaf = name[len(prefix):].split("/")
        if keys[-1] == "conv":
            keys = keys[:-1]
            if leaf == "kernel":
                leaf, t = "weight", t.permute(3, 2, 0, 1).contiguous()
        node = tree
        for key in keys:
            node = node.setdefault(key, {})
        node[leaf] = t.to(device)
    have = {name for name, _, _ in named_leaves(tree, prefix)}
    missing = sorted(set(expected) - have)
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} parameter(s): {missing[:4]}")
    return tree


def params_from_flat(
    flat: Dict[str, np.ndarray], config: Config, device="cpu"
) -> Params:
    """JAX flat names → ``{"cnn": {layer: {"weight" OIHW, "bias"}, ...},
    "decoder": <the JAX nested dict>}`` of float32 tensors on ``device``
    (ResNet50's blocks nest one level deeper, its batch norms hold
    ``scale`` and ``bias``); ``batch_stats/`` entries are left to
    :func:`batch_stats_from_flat`."""
    return _unflatten(flat, config, "params/", device)


def batch_stats_from_flat(flat: Dict[str, np.ndarray], config: Config, device="cpu") -> Params:
    """ResNet50's running statistics (``batch_stats/<block>/<bn>/{mean,
    var}``) as nested dicts of tensors on ``device``; ``{}`` for VGG16."""
    return _unflatten(flat, config, "batch_stats/", device)


def named_leaves(node, prefix: str):
    """(flat name, tensor, is conv kernel) of every tensor under ``node``
    (nested dicts and lists), named as the JAX package names it: list
    items by index, a conv layer's ``weight`` (OIHW) and ``bias`` as
    ``conv/kernel`` (HWIO there) and ``conv/bias``."""
    conv = isinstance(node, dict) and "weight" in node
    for key, value in enumerate(node) if isinstance(node, list) else node.items():
        if isinstance(value, (dict, list)):
            yield from named_leaves(value, f"{prefix}{key}/")
        elif conv:
            yield f"{prefix}conv/{'kernel' if key == 'weight' else key}", value, key == "weight"
        else:
            yield f"{prefix}{key}", value, False


def _host(t: torch.Tensor, conv: bool) -> np.ndarray:
    """A numpy copy that owns its bytes, in the JAX layout.  Never a view:
    a snapshot handed to the writer thread must not change when the next
    step updates the parameter in place."""
    t = t.detach()
    if conv:
        t = t.permute(2, 3, 1, 0)
    return t.to("cpu", memory_format=torch.contiguous_format, copy=True).numpy()


def params_to_flat(params: Params) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_flat`: JAX flat names → float32
    numpy arrays in the JAX layout."""
    return {name: _host(t, conv) for name, t, conv in named_leaves(params, "params/")}


def state_to_flat(state) -> Dict[str, np.ndarray]:
    """``TrainState`` → flat dict: ``params/``, ``batch_stats/`` (ResNet50),
    ``optimizer/`` (optax's chain state: the slots of the trainable
    sub-dict) and ``global_step``, every array a copy."""
    with telemetry.span("ckpt/snapshot"):
        flat = params_to_flat(state.params)
        flat.update({name: _host(t, conv) for name, t, conv in named_leaves(state.batch_stats, "batch_stats/")})
        flat.update({name: _host(t, conv) for name, t, conv in named_leaves(state.opt_state, "optimizer/")})
        flat["global_step"] = np.asarray(state.step, np.int32)
    return flat


def assign_flat(node, prefix: str, flat: Dict[str, np.ndarray]) -> int:
    """Copy every entry of ``flat`` whose name and (JAX-layout) shape match
    a tensor under ``node`` into it, in place; returns how many did."""
    count = 0
    with torch.no_grad():
        for name, t, conv in named_leaves(node, prefix):
            if name not in flat:
                continue
            value = torch.from_numpy(np.asarray(flat[name]))
            if conv:
                value = value.permute(3, 2, 0, 1)
            if tuple(value.shape) != tuple(t.shape):
                continue
            t.copy_(value.to(t.dtype))
            count += 1
    return count


def load_flat(path: str) -> Dict[str, np.ndarray]:
    def read() -> Dict[str, np.ndarray]:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    return retry_io(read, desc=f"read checkpoint {path}")


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """Newest ``<step>.npz`` under ``save_dir``: the directory scan, plus
    the step ``config.json`` names when its file is real."""
    steps = set(lineage.checkpoint_steps(save_dir))
    cfg_path = os.path.join(save_dir, "config.json")
    if os.path.exists(cfg_path):
        try:
            pointed = int(Config.load(cfg_path).global_step)
        except (ValueError, KeyError, TypeError):
            pass
        else:
            path = os.path.join(save_dir, f"{pointed}.npz")
            if os.path.isfile(path) and os.path.getsize(path) > 0:
                steps.add(pointed)
    if steps:
        return os.path.join(save_dir, f"{max(steps)}.npz")
    return None


def check_vocab(path: str, expect: Optional[dict]) -> None:
    """Raise :class:`VocabMismatchError` when ``path``'s sidecar attests a
    vocabulary other than ``expect``; either side missing checks nothing."""
    if not expect:
        return
    recorded = lineage.read_sidecar_meta(path).get("vocab")
    if not recorded:
        return
    if recorded.get("sha256") != expect.get("sha256") or int(
        recorded.get("size", 0)
    ) != int(expect.get("size", 0)):
        raise VocabMismatchError(
            f"vocab mismatch (got {expect.get('size')} words, sha "
            f"{str(expect.get('sha256'))[:12]}…; checkpoint "
            f"{os.path.basename(path)} expects {recorded.get('size')} "
            f"words, sha {str(recorded.get('sha256'))[:12]}…) — restore "
            "with the original vocabulary.csv or retrain"
        )


def walk_back(save_dir: str, expect: Optional[dict]) -> Tuple[Dict[str, np.ndarray], str]:
    """Newest checkpoint under ``save_dir`` that verifies and loads.  A
    vocabulary mismatch raises at once: every older checkpoint of the run
    shares the vocabulary."""
    rejected = []
    for step in sorted(lineage.checkpoint_steps(save_dir), reverse=True):
        path = os.path.join(save_dir, f"{step}.npz")
        ok, reason = lineage.verify_checkpoint(path)
        if ok:
            check_vocab(path, expect)
            try:
                return load_flat(path), path
            except (OSError, ValueError) as e:
                reason = f"load failed: {e}"
        rejected.append(f"{os.path.basename(path)} ({reason})")
        telemetry.count("ckpt/walkbacks")
        print(
            f"sat_tpu_torch: checkpoint {path} rejected ({reason}); walking back",
            file=sys.stderr,
            flush=True,
        )
    detail = f"; rejected: {', '.join(rejected)}" if rejected else ""
    raise FileNotFoundError(f"no verifiable checkpoint found (save_dir={save_dir!r}{detail})")


class ServingState(NamedTuple):
    """A checkpoint's frozen params, as every decoding entry point (serving,
    eval, test) loads them."""

    params: Dict[str, Any]   # params_from_flat layout, on the decoding device
    step: int                # the checkpoint's global_step
    batch_stats: Dict[str, Any] = {}   # ResNet50's running statistics; {} for VGG16


def state_from_flat(flat: Dict[str, np.ndarray], config: Config, device, source: str) -> ServingState:
    """``params_from_flat`` and ``batch_stats_from_flat`` on ``device`` and
    the checkpoint's step; a file that holds no parameter at all is an
    error."""
    if not any(k.startswith("params/") for k in flat):
        raise ValueError(f"checkpoint {source} restored 0 tensors")
    return ServingState(
        params=params_from_flat(flat, config, device),
        step=int(np.asarray(flat.get("global_step", 0))),
        batch_stats=batch_stats_from_flat(flat, config, device),
    )


def _cast_cnn(node: Dict[str, Any], dt: torch.dtype) -> Dict[str, Any]:
    """A conv layer's ``weight`` (``channels_last``) and ``bias`` in ``dt``;
    batch-norm ``scale``/``bias`` stay float32 (the normalization runs in
    float32)."""
    if "weight" in node:
        return {
            k: v.to(dt).contiguous(memory_format=torch.channels_last) if k == "weight" else v.to(dt)
            for k, v in node.items()
        }
    return {k: _cast_cnn(v, dt) if isinstance(v, dict) else v for k, v in node.items()}


def compute_params(
    params: Dict[str, Any], config: Config, batch_stats: Optional[Dict[str, Any]] = None
) -> Dict[str, Any]:
    """The decoding copy of the params (serving, eval and test): conv
    weights and dense kernels and biases cast once to ``compute_dtype``
    (each op would round them to it anyway, so values are unchanged),
    conv weights ``channels_last``; ResNet50's running statistics ride
    along under ``"batch_stats"``, where ``captioner.encode`` reads them.
    Kept float32: batch-norm parameters and statistics, the LSTM bias
    (added after the float32 cast), the word embedding (gathered in
    float32) and the attention ``fc_2`` kernel (the fused kernel's float32
    ``w2``).  A tree without ``"cnn"`` (the quantized encoder's) casts
    the decoder alone."""
    dt = getattr(torch, config.compute_dtype)

    def cast(node, path):
        out = {}
        for key, value in node.items():
            if isinstance(value, dict):
                out[key] = cast(value, f"{path}/{key}")
            elif f"{path}/{key}" in ("/lstm/bias", "/word_embedding/weights", "/attend/fc_2/kernel"):
                out[key] = value
            else:
                out[key] = value.to(dt)
        return out

    out = {"decoder": cast(params["decoder"], "")}
    if "cnn" in params:
        out["cnn"] = _cast_cnn(params["cnn"], dt)
    if batch_stats:
        out["batch_stats"] = batch_stats
    return out


def to_device(node, device):
    """The params tree (nested dicts of tensors) moved to ``device``; a
    leaf that is not a tensor (a quantized conv's ``act_scale``) stays."""
    if isinstance(node, dict):
        return {k: to_device(v, device) for k, v in node.items()}
    return node.to(device) if isinstance(node, torch.Tensor) else node


# ---------------------------------------------------------------------------
# training: save and restore
# ---------------------------------------------------------------------------


def _topology(config: Config, state) -> Dict[str, Any]:
    """The topology recorded in the lineage sidecar: the JAX package's
    keys, from this launch (``parallel.mesh.topology``) and the config's
    mesh."""
    from ..parallel.mesh import topology

    return topology(config, next(named_leaves(state.params, ""))[1].device)


# elastic restores since the last take_elastic_restores(): a restore
# before a run (the CLI's --load) precedes the run's fresh telemetry
# registry, which counts them again when it starts
_ELASTIC = [0]


def take_elastic_restores() -> int:
    """The elastic restores noted since the last call (and reset)."""
    n, _ELASTIC[0] = _ELASTIC[0], 0
    return n


def _note_elastic_restore(path: str) -> None:
    """Count and say on stderr a restore onto another number of devices
    than the checkpoint was written from (an elastic resume).  The state
    is full arrays on disk, so the restore itself does not depend on it."""
    from ..parallel.mesh import world_size

    recorded = lineage.read_sidecar_meta(path).get("topology")
    if not recorded or recorded.get("device_count") is None:
        return
    now, then = world_size(), int(recorded["device_count"])
    if then != now:
        telemetry.count("ckpt/elastic_restores")
        _ELASTIC[0] += 1
        print(
            f"sat_tpu_torch: elastic resume — checkpoint {os.path.basename(path)} was written on {then} "
            f"device(s) (mesh {recorded.get('mesh_shape')}), restoring onto {now}; the state is "
            "placed on the current mesh",
            file=sys.stderr, flush=True,
        )


def _write_flat(
    flat: Dict[str, np.ndarray], path: str, config: Config, save_dir: str,
    topology: Dict[str, Any], healthy: bool = True,
) -> None:
    """The disk half of a save: atomic npz and ``config.json`` sidecar,
    then the lineage tail — sha256 sidecar (with the vocabulary
    fingerprint and the topology), post-write verify, ``LAST_GOOD``
    advanced only when the verify passed and the run was ``healthy``, and
    keep-N retention."""
    from ..data.vocabulary import vocab_fingerprint

    step = int(flat["global_step"])
    with telemetry.span("ckpt/write"):
        retry_io(
            lambda: atomic_write(path, "wb", lambda f: np.savez(f, **flat)),
            desc=f"write checkpoint {path}",
        )
    # hash now, while the file is what was serialized
    with telemetry.span("ckpt/sidecar"):
        try:
            vocab = vocab_fingerprint(config.vocabulary_file, config.vocabulary_size)
        except Exception:
            vocab = None  # attestation is best-effort; the save is not
        lineage.write_sidecar(path, vocab=vocab, topology=topology)
    retry_io(
        lambda: config.replace(global_step=step).save(os.path.join(save_dir, "config.json")),
        desc=f"write checkpoint config {save_dir}",
    )
    # injection point: bit rot between the rename and the verify; the
    # post-write verify must catch it and refuse to bless the file
    FaultPlan.from_env().maybe_corrupt_checkpoint(path, step)
    with telemetry.span("ckpt/finalize"):
        lineage.finalize_save(save_dir, path, step, healthy=healthy, keep=config.keep_checkpoints)
    telemetry.count("ckpt/saves")
    telemetry.gauge("ckpt/last_save_step", step)
    telemetry.gauge("ckpt/last_save_unix", time.time())


def save_checkpoint(state, config: Config, save_dir: Optional[str] = None, healthy: bool = True,
                    mesh=None) -> str:
    """Write ``<global_step>.npz`` and ``config.json`` under save_dir;
    ``healthy=False`` (the sentinel saw non-finite metrics) writes the
    file but withholds the ``LAST_GOOD`` blessing.

    ``mesh`` (a launch of several ranks): every rank calls it; the
    vocab-sharded leaves are gathered full in one collective, rank 0
    writes, and every rank leaves after the write."""
    save_dir = save_dir or config.save_dir
    path = os.path.join(save_dir, f"{int(state.step)}.npz")
    if mesh is None or mesh.world == 1:
        _write_flat(state_to_flat(state), path, config, save_dir, _topology(config, state), healthy=healthy)
        return path
    from ..parallel.mesh import sync_processes
    from ..utils.dist import gather_tree_replicated

    full = state._replace(
        params=gather_tree_replicated(state.params, config, mesh),
        opt_state=gather_tree_replicated(state.opt_state, config, mesh),
    )
    if mesh.rank == 0:
        _write_flat(state_to_flat(full), path, config, save_dir, _topology(config, state), healthy=healthy)
    sync_processes(f"checkpoint {int(state.step)}")
    return path


class AsyncCheckpointWriter:
    """Checkpoint writes overlapped with training.  ``save`` snapshots the
    state synchronously (:func:`state_to_flat`: copies the next step
    cannot touch) and queues the npz write and lineage tail for one
    worker thread; saves land in submission order, the queue holds two
    snapshots at most (a slow disk slows ``save`` rather than stacking
    snapshots), and a worker failure is raised, as
    :class:`CheckpointWriteError`, by every later ``save``, ``flush`` and
    ``close``."""

    def __init__(self) -> None:
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._error: Optional[BaseException] = None
        self._error_lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, name="sat-ckpt-writer", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        import threading

        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, threading.Event):  # flush() barrier
                item.set()
                continue
            args, healthy = item
            try:
                _write_flat(*args, healthy=healthy)
            except BaseException as e:  # surfaced on the next save/flush/close
                with self._error_lock:
                    if self._error is None:  # keep the root cause
                        self._error = e

    def _check(self) -> None:
        with self._error_lock:
            e = self._error
        if e is not None:
            raise CheckpointWriteError("async checkpoint write failed") from e

    def save(self, state, config: Config, save_dir: Optional[str] = None, healthy: bool = True) -> str:
        self._check()
        save_dir = save_dir or config.save_dir
        flat = state_to_flat(state)
        path = os.path.join(save_dir, f"{int(flat['global_step'])}.npz")
        self._q.put(((flat, path, config, save_dir, _topology(config, state)), healthy))
        return path

    def flush(self) -> None:
        """Block until every queued save is on disk with its lineage tail,
        then raise any worker failure."""
        import threading

        barrier = threading.Event()
        self._q.put(barrier)
        barrier.wait()
        self._check()

    def close(self) -> None:
        """Drain pending writes; raise the first worker failure."""
        self._q.put(None)
        self._thread.join()
        self._check()


def restore_checkpoint(
    state,
    model_file: Optional[str] = None,
    save_dir: Optional[str] = None,
    expect_vocab: Optional[dict] = None,
    mesh=None,
    placement: Optional[Config] = None,
):
    """Load a checkpoint into ``state`` in place: ``model_file`` as given,
    else the newest checkpoint under ``save_dir`` that verifies and loads
    (:func:`walk_back`).  Entries whose name or shape the state lacks are
    skipped (a trimmed or partial file loads what it has).  Returns
    (state with the file's ``global_step``, tensors loaded); the step is
    not counted, so 0 means nothing usable was loaded.

    ``mesh`` and ``placement`` (the placement rule's config): ``state`` is
    this rank's, so each vocab-sharded leaf takes its block of the file's
    full array."""
    if model_file:
        check_vocab(model_file, expect_vocab)
        flat, source = load_flat(model_file), model_file
    elif save_dir:
        flat, source = walk_back(save_dir, expect_vocab)
    else:
        raise FileNotFoundError(f"no checkpoint found (save_dir={save_dir!r})")
    _note_elastic_restore(source)
    if mesh is not None and placement is not None:
        from ..parallel.sharding import shard_flat

        flat = shard_flat(flat, placement, mesh)
    count = (
        assign_flat(state.params, "params/", flat)
        + assign_flat(state.batch_stats, "batch_stats/", flat)
        + assign_flat(state.opt_state, "optimizer/", flat)
    )
    step = int(np.asarray(flat["global_step"])) if "global_step" in flat else state.step
    return state._replace(step=step), count


def trim_checkpoint(in_path: str, out_path: str) -> int:
    """Strip the optimizer slots from a checkpoint (the reference's
    trim tool); returns the number of entries kept."""
    kept = {k: v for k, v in load_flat(in_path).items() if not k.startswith("optimizer/")}
    atomic_write(out_path, "wb", lambda f: np.savez(f, **kept))
    return len(kept)


# ---------------------------------------------------------------------------
# the reference's own formats: pretrained-CNN import, checkpoint import/export
# ---------------------------------------------------------------------------

# parameter-name aliases across the caffe-converted npy files and TF scopes
_KERNEL_NAMES = {"kernel", "weights", "W", "w"}
_BIAS_NAMES = {"bias", "biases", "b", "offset", "beta"}
_SCALE_NAMES = {"scale", "gamma"}
_MEAN_NAMES = {"mean", "moving_mean", "mu"}
_VAR_NAMES = {"variance", "moving_variance", "var"}

_DECODER_SCOPES = ("word_embedding", "initialize", "attend", "decode")
_BN_EXPORT_NAMES = {"scale": "gamma", "bias": "beta", "mean": "moving_mean", "var": "moving_variance"}


def _nested_npy(data_path: str) -> Dict[str, Dict[str, np.ndarray]]:
    raw = np.load(data_path, allow_pickle=True, encoding="latin1")
    d = raw.item() if hasattr(raw, "item") and raw.dtype == object else dict(raw)
    return {str(k): {str(p): np.asarray(a) for p, a in v.items()} for k, v in d.items()}


def _find_op(tree: Any, op: str) -> Optional[Dict[str, Any]]:
    """The dict node named ``op`` at any depth: ResNet50's convs and batch
    norms sit one level below the reference's flat TF scopes, in their
    block (``cnn["res2a"]["res2a_branch2a"]``)."""
    if not isinstance(tree, dict):
        return None
    if op in tree and isinstance(tree[op], dict):
        return tree[op]
    for child in tree.values():
        hit = _find_op(child, op)
        if hit is not None:
            return hit
    return None


def _set_key(dest: Dict[str, Any], key: str, value: np.ndarray) -> bool:
    """Copy ``value`` into ``key`` of the op node (or the first child node
    that has it) in place when the shapes agree.  A conv kernel arrives
    HWIO and lands in the layer's OIHW ``weight``."""
    leaf = "weight" if key == "kernel" else key
    t = dest.get(leaf)
    if isinstance(t, torch.Tensor):
        if leaf == "weight" and value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        if tuple(t.shape) != tuple(value.shape):
            return False
        with torch.no_grad():
            t.copy_(torch.from_numpy(np.ascontiguousarray(value)).to(t.dtype))
        return True
    return any(isinstance(child, dict) and _set_key(child, key, value) for child in dest.values())


def _place_nested(params_cnn: Dict[str, Any], batch_stats: Dict[str, Any],
                  nested: Dict[str, Dict[str, np.ndarray]]) -> int:
    """Place ``{op: {param: array}}`` entries into the CNN's parameters and
    running statistics in place, alias-mapping the parameter names;
    unknown ops and parameters are skipped, as the reference's
    ``ignore_missing=True`` load does.  Returns the tensors placed."""
    count = 0
    for op_name, entries in nested.items():
        for param_name, value in entries.items():
            if param_name in _KERNEL_NAMES:
                key, tree = "kernel", params_cnn
            elif param_name in _SCALE_NAMES:
                key, tree = "scale", params_cnn
            elif param_name in _BIAS_NAMES:
                key, tree = "bias", params_cnn
            elif param_name in _MEAN_NAMES:
                key, tree = "mean", batch_stats
            elif param_name in _VAR_NAMES:
                key, tree = "var", batch_stats
            else:
                continue
            dest = _find_op(tree, op_name)
            if dest is not None and _set_key(dest, key, np.asarray(value)):
                count += 1
    return count


def load_pretrained_cnn(params: Params, batch_stats: Params, data_path: str) -> int:
    """Import a pretrained CNN in the reference's nested npy format
    (``vgg16_no_fc.npy``, ``resnet50_no_fc.npy``: ``{op: {param:
    array}}``, ops named as the model's layers) into ``params["cnn"]``
    and ``batch_stats`` in place; returns the tensors loaded."""
    return _place_nested(params["cnn"], batch_stats, _nested_npy(data_path))


def apply_cnn_import(state, nested_or_path: Any) -> Tuple[Any, int]:
    """Import a nested CNN dict (or its npy path) into a ``TrainState`` or
    ``ServingState`` in place; returns (state, tensors loaded)."""
    if isinstance(nested_or_path, str):
        nested_or_path = _nested_npy(nested_or_path)
    return state, _place_nested(state.params["cnn"], state.batch_stats, nested_or_path)


def import_reference_checkpoint(state, path: str, restore_step: bool = False) -> Tuple[Any, int]:
    """Load a checkpoint written by the reference's own ``save()`` (a flat
    ``{var.name: value}`` npy) into a ``TrainState`` or ``ServingState``
    in place; returns (state, tensors loaded).

    ``<scope>/.../kernel:0`` of the decoder scopes and
    ``lstm/lstm_cell/{kernel,bias}:0`` map by name; CNN scopes (convs and
    batch norms) go through the pretrained-CNN aliases; optimizer slots
    (``OptimizeLoss/...``) are dropped.  ``global_step:0`` is adopted only
    with ``restore_step``: fine-tuning an imported model starts at step 0."""
    raw = np.load(path, allow_pickle=True, encoding="latin1").item()
    decoder_flat: Dict[str, np.ndarray] = {}
    cnn_nested: Dict[str, Dict[str, np.ndarray]] = {}
    step = None
    for name, value in raw.items():
        parts = name.split(":")[0].split("/")
        if parts[0] == "global_step":
            step = int(np.asarray(value))
        elif parts[0].startswith("OptimizeLoss") or "optimizer" in parts[0].lower():
            continue
        elif parts[0] == "lstm":
            decoder_flat[f"params/decoder/lstm/{parts[-1]}"] = np.asarray(value)
        elif parts[0] in _DECODER_SCOPES:
            decoder_flat["params/decoder/" + "/".join(parts)] = np.asarray(value)
        elif len(parts) >= 2:
            cnn_nested.setdefault(parts[0], {})[parts[-1]] = np.asarray(value)
    count = assign_flat(state.params, "params/", decoder_flat)
    state, n_cnn = apply_cnn_import(state, cnn_nested)
    if restore_step and step is not None:
        state = state._replace(step=step)
    return state, count + n_cnn


def _export_cnn_tree(tree: Dict[str, Any], out: Dict[str, np.ndarray]) -> None:
    """Reference TF-scope names for a CNN parameter or statistics tree: a
    conv layer becomes ``<op>/kernel:0`` (HWIO) and ``<op>/bias:0``, a
    batch norm ``<op>/{gamma,beta}:0`` or ``<op>/{moving_mean,
    moving_variance}:0``; a block recurses."""
    for op, sub in tree.items():
        if not isinstance(sub, dict):
            continue
        if "weight" in sub:
            for leaf, t in sub.items():
                out[f"{op}/{'kernel' if leaf == 'weight' else leaf}:0"] = _host(t, leaf == "weight")
        elif any(isinstance(sub.get(k), torch.Tensor) for k in _BN_EXPORT_NAMES):
            for leaf, t in sub.items():
                if leaf in _BN_EXPORT_NAMES and isinstance(t, torch.Tensor):
                    out[f"{op}/{_BN_EXPORT_NAMES[leaf]}:0"] = _host(t, False)
        else:
            _export_cnn_tree(sub, out)


def export_reference_checkpoint(state, path: str) -> int:
    """Write the reference's flat ``{var.name: value}`` npy, the inverse of
    :func:`import_reference_checkpoint`: decoder scopes by name, the LSTM
    under ``lstm/lstm_cell/``, conv kernels HWIO, batch norms as
    gamma/beta/moving_mean/moving_variance, ``global_step:0``; no
    optimizer slots.  Returns the tensors written."""
    flat: Dict[str, np.ndarray] = {}
    for scope, sub in state.params.get("decoder", {}).items():
        if scope == "lstm":
            for leaf, t in sub.items():
                flat[f"lstm/lstm_cell/{leaf}:0"] = _host(t, False)
            continue
        for name, node in sub.items():
            if isinstance(node, dict):
                for leaf, t in node.items():
                    flat[f"{scope}/{name}/{leaf}:0"] = _host(t, False)
            else:
                flat[f"{scope}/{name}:0"] = _host(node, False)
    _export_cnn_tree(state.params.get("cnn", {}), flat)
    _export_cnn_tree(state.batch_stats or {}, flat)
    flat["global_step:0"] = np.asarray(int(state.step), np.int64)
    atomic_write(path, "wb", lambda f: np.save(f, np.array(flat, dtype=object), allow_pickle=True))
    return len(flat) - 1  # global_step is bookkeeping, not a tensor
