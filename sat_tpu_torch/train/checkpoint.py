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
sidecar with the vocabulary and a one-device topology, verify,
``LAST_GOOD``, retention); :func:`restore_checkpoint` loads a file into
a ``TrainState`` in place, skipping names or shapes it does not have.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..models.vgg16 import VGG_LAYERS
from ..resilience import lineage
from ..resilience.lineage import CheckpointWriteError
from ..resilience.retry import retry_io
from ..utils.fileio import atomic_write

Params = Dict[str, Any]


class VocabMismatchError(RuntimeError):
    """The checkpoint's sidecar attests another vocabulary than the one
    configured: decoding would map token ids to the wrong words."""


def param_shapes(config: Config) -> Dict[str, Tuple[int, ...]]:
    """Flat name → shape (JAX layout) of every parameter of ``config``'s
    model: the names ``sat_tpu.models.init_variables`` creates."""
    if config.cnn != "vgg16":
        raise NotImplementedError(f"cnn={config.cnn!r} is not ported yet (only 'vgg16')")
    c = config
    shapes: Dict[str, Tuple[int, ...]] = {}
    cin = 3
    for name, features, _ in VGG_LAYERS:
        shapes[f"params/cnn/{name}/conv/kernel"] = (3, 3, cin, features)
        shapes[f"params/cnn/{name}/conv/bias"] = (features,)
        cin = features
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


def params_from_flat(
    flat: Dict[str, np.ndarray], config: Config, device="cpu"
) -> Params:
    """JAX flat names → ``{"cnn": {layer: {"weight" OIHW, "bias"}},
    "decoder": <the JAX nested dict>}`` of float32 tensors on ``device``."""
    expected = param_shapes(config)
    params: Params = {"cnn": {}, "decoder": {}}
    for name, value in flat.items():
        if _skipped(name):
            continue
        if name not in expected:
            raise KeyError(f"checkpoint entry {name!r} is not a parameter of this config")
        arr = np.asarray(value)
        if tuple(arr.shape) != expected[name]:
            raise ValueError(
                f"checkpoint entry {name!r} has shape {arr.shape}, config expects {expected[name]}"
            )
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        parts = name.split("/")[1:]
        if parts[0] == "cnn":
            layer, leaf = parts[1], parts[3]
            if leaf == "kernel":
                params["cnn"].setdefault(layer, {})["weight"] = t.permute(3, 2, 0, 1).contiguous().to(device)
            else:
                params["cnn"].setdefault(layer, {})["bias"] = t.to(device)
            continue
        node = params["decoder"]
        for key in parts[1:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = t.to(device)
    missing = sorted(set(expected) - set(params_to_flat(params)))
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} parameter(s): {missing[:4]}")
    return params


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
    """``TrainState`` → flat dict: ``params/``, ``optimizer/`` (optax's
    chain state: the slots of the trainable sub-dict) and ``global_step``,
    every array a copy."""
    flat = params_to_flat(state.params)
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


def state_from_flat(flat: Dict[str, np.ndarray], config: Config, device, source: str) -> ServingState:
    """``params_from_flat`` on ``device`` and the checkpoint's step; a file
    that holds no parameter at all is an error."""
    if not any(k.startswith("params/") for k in flat):
        raise ValueError(f"checkpoint {source} restored 0 tensors")
    return ServingState(
        params=params_from_flat(flat, config, device),
        step=int(np.asarray(flat.get("global_step", 0))),
    )


def compute_params(params: Dict[str, Any], config: Config) -> Dict[str, Any]:
    """The decoding copy of the params (serving, eval and test): conv
    weights and dense kernels and biases cast once to ``compute_dtype``
    (each op would round them to it anyway, so values are unchanged),
    conv weights ``channels_last``.
    Kept float32: the LSTM bias (added after the float32 cast), the word
    embedding (gathered in float32) and the attention ``fc_2`` kernel (the
    fused kernel's float32 ``w2``)."""
    dt = getattr(torch, config.compute_dtype)
    cnn = {
        name: {
            "weight": p["weight"].to(dt).contiguous(memory_format=torch.channels_last),
            "bias": p["bias"].to(dt),
        }
        for name, p in params["cnn"].items()
    }

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

    return {"cnn": cnn, "decoder": cast(params["decoder"], "")}


def to_device(node, device):
    """The params tree (nested dicts of tensors) moved to ``device``."""
    if isinstance(node, dict):
        return {k: to_device(v, device) for k, v in node.items()}
    return node.to(device)


# ---------------------------------------------------------------------------
# training: save and restore
# ---------------------------------------------------------------------------


def _topology(state) -> Dict[str, Any]:
    """The one-device topology recorded in the lineage sidecar."""
    device = next(named_leaves(state.params, ""))[1].device
    return {
        "device_count": 1,
        "platform": "gpu" if device.type == "cuda" else device.type,
        "process_count": 1,
        "mesh_shape": [1],
        "mesh_axes": ["data"],
    }


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
    retry_io(
        lambda: atomic_write(path, "wb", lambda f: np.savez(f, **flat)),
        desc=f"write checkpoint {path}",
    )
    # hash now, while the file is what was serialized
    try:
        vocab = vocab_fingerprint(config.vocabulary_file, config.vocabulary_size)
    except Exception:
        vocab = None  # attestation is best-effort; the save is not
    lineage.write_sidecar(path, vocab=vocab, topology=topology)
    retry_io(
        lambda: config.replace(global_step=step).save(os.path.join(save_dir, "config.json")),
        desc=f"write checkpoint config {save_dir}",
    )
    lineage.finalize_save(save_dir, path, step, healthy=healthy, keep=config.keep_checkpoints)


def save_checkpoint(state, config: Config, save_dir: Optional[str] = None, healthy: bool = True) -> str:
    """Write ``<global_step>.npz`` and ``config.json`` under save_dir;
    ``healthy=False`` (the sentinel saw non-finite metrics) writes the
    file but withholds the ``LAST_GOOD`` blessing."""
    save_dir = save_dir or config.save_dir
    flat = state_to_flat(state)
    path = os.path.join(save_dir, f"{int(flat['global_step'])}.npz")
    _write_flat(flat, path, config, save_dir, _topology(state), healthy=healthy)
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
        self._q.put(((flat, path, config, save_dir, _topology(state)), healthy))
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
):
    """Load a checkpoint into ``state`` in place: ``model_file`` as given,
    else the newest checkpoint under ``save_dir`` that verifies and loads
    (:func:`walk_back`).  Entries whose name or shape the state lacks are
    skipped (a trimmed or partial file loads what it has).  Returns
    (state with the file's ``global_step``, tensors loaded); the step is
    not counted, so 0 means nothing usable was loaded."""
    if model_file:
        check_vocab(model_file, expect_vocab)
        flat = load_flat(model_file)
    elif save_dir:
        flat, _ = walk_back(save_dir, expect_vocab)
    else:
        raise FileNotFoundError(f"no checkpoint found (save_dir={save_dir!r})")
    count = assign_flat(state.params, "params/", flat) + assign_flat(state.opt_state, "optimizer/", flat)
    step = int(np.asarray(flat["global_step"])) if "global_step" in flat else state.step
    return state._replace(step=step), count
