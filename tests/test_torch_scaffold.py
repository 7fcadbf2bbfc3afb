"""sat_tpu_torch's package rules: no jax and nothing of sat_tpu in the
port, entry points on the card unless the caller asks for the CPU, and a
kernel build that fails loudly instead of falling back."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "sat_tpu_torch")

torch.set_num_threads(2)


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_import_loads_neither_jax_nor_sat_tpu():
    """Every submodule imports in a fresh interpreter without loading jax,
    flax, optax or any sat_tpu module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import sat_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(sat_tpu_torch.__path__, 'sat_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'sat_tpu'))\n"
        "print(len(names), bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 20
    assert bad == "[]"


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_of_jax_or_sat_tpu(path):
    """A regex over the source: ``import sat_tpu``/``from sat_tpu`` (not
    ``sat_tpu_torch``) and jax/flax/optax imports appear nowhere."""
    pattern = re.compile(
        r"^\s*(from|import)\s+(sat_tpu|jax|jaxlib|flax|optax)(\.|\s|$)", re.MULTILINE
    )
    with open(path) as f:
        hits = pattern.findall(f.read())
    assert not hits, f"{path} imports {hits}"


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    from sat_tpu_torch.data.vocabulary import Vocabulary
    from sat_tpu_torch.device import resolve_device
    from sat_tpu_torch.serve import engine as engine_mod
    from sat_tpu_torch.serve.server import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = configs(save_dir=str(tmp_path), vocabulary_file=str(tmp_path / "vocabulary.csv"))
    state = engine_mod.ServingState(params={"cnn": {}, "decoder": {}}, step=0)
    vocab = Vocabulary(10)
    vocab.build(["a dog runs."])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine_mod.ServeEngine(tc, state, vocab)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine_mod.load_serving_state(tc)
    vocab.save(tc.vocabulary_file)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(tc)
    assert resolve_device("cpu") == torch.device("cpu")
    engine = engine_mod.ServeEngine(tc, state, vocab, device="cpu")
    assert engine.device == torch.device("cpu")


@pytest.mark.parametrize(
    "knob",
    [
        {"serve_wedge_timeout_ms": 250.0},  # the watchdog is not ported: never ignored
        {"encoder_quant": "int8"},
        {"encode_cache": "on"},
        {"cnn": "resnet50"},
    ],
)
def test_unported_serve_knobs_raise(knob):
    from sat_tpu_torch.serve.engine import check_ported

    _, tc = configs(**knob)
    with pytest.raises(NotImplementedError, match="not ported"):
        check_ported(tc)


def test_fused_attend_has_no_kernel_for_other_devices():
    from sat_tpu_torch.ops.fused_attend import fused_attend

    t1 = torch.zeros((2, 3, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_attend(t1, t1[:, 0], t1[0, 0].reshape(4, 1), t1)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No toolkit: the build raises; nothing falls back to the plain
    version."""
    import shutil

    import torch.utils.cpp_extension as cpp_ext

    from sat_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()


def test_kernel_library_is_named_by_source_hash(tmp_path, monkeypatch):
    from sat_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    src = tmp_path / "k.cu"
    src.write_text("// a\n")
    first = build._target(str(src))
    assert os.path.basename(first).startswith("k-") and first.endswith(".so")
    assert build._target(str(src)) == first
    src.write_text("// b\n")
    assert build._target(str(src)) != first


def test_cli_serves_only_the_ported_phase(tmp_path):
    from sat_tpu_torch.cli import build_config, main

    config, model_file = build_config(
        ["--phase", "serve", "--port", "0", "--max_batch", "4", "--model_file", "x.npz",
         "--set", "beam_size=2", "--set", "serve_buckets=1,4", "--set", "num_initalize_layers=1"]
    )
    assert (config.phase, config.serve_port, config.serve_max_batch) == ("serve", 0, 4)
    assert (config.beam_size, config.serve_buckets, config.num_initialize_layers) == (2, (1, 4), 1)
    assert model_file == "x.npz"
    with pytest.raises(SystemExit, match="not ported yet"):
        main(["--phase", "train"])
    with pytest.raises(SystemExit, match="unknown Config field"):
        build_config(["--set", "no_such_field=1"])


def test_config_copy_matches_the_jax_config(tmp_path):
    """One config file drives both packages: same fields and defaults,
    and a JSON saved by either loads in the other."""
    import dataclasses

    from sat_tpu.config import Config as JaxConfig
    from sat_tpu_torch.config import Config

    assert Config().to_dict() == JaxConfig().to_dict()
    assert [f.name for f in dataclasses.fields(Config)] == [
        f.name for f in dataclasses.fields(JaxConfig)
    ]
    path = str(tmp_path / "c.json")
    JaxConfig(beam_size=5, serve_buckets=(2, 64)).save(path)
    assert Config.load(path).to_dict() == JaxConfig.load(path).to_dict()
    Config(dim_attend_layer=64).save(path)
    assert JaxConfig.load(path).dim_attend_layer == 64
    with pytest.raises(ValueError):
        Config(cnn="vgg19")
    assert Config(cnn="resnet50", image_size=224).num_ctx == 49
    np.testing.assert_equal(Config().num_ctx, JaxConfig().num_ctx)
