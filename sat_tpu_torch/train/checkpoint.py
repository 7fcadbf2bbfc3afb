"""Checkpoint read side and the weight bridge — the port of the serving half
of ``sat_tpu.train.checkpoint``.

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
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..models.vgg16 import VGG_LAYERS
from ..resilience import lineage

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


def params_to_flat(params: Params) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_flat`: JAX flat names → float32
    numpy arrays in the JAX layout."""
    flat: Dict[str, np.ndarray] = {}
    for layer, p in params["cnn"].items():
        if "weight" in p:
            flat[f"params/cnn/{layer}/conv/kernel"] = p["weight"].detach().cpu().permute(2, 3, 1, 0).numpy()
        if "bias" in p:
            flat[f"params/cnn/{layer}/conv/bias"] = p["bias"].detach().cpu().numpy()

    def walk(node, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, f"{prefix}{key}/")
            else:
                flat[f"{prefix}{key}"] = value.detach().cpu().numpy()

    walk(params["decoder"], "params/decoder/")
    return flat


def load_flat(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


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
