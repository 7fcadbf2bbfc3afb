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


# the evidence tools, one a script of scripts/ (and the corpus they share)
TOOLS = ("corpus", "quality_run", "continue_quality_run", "import_finetune_run", "export_reference",
         "trim_model", "replay_exemplar", "merge_traces", "check_slo", "fixtures", "analyze_postmortem",
         "chaos_campaign", "cli_ranks", "vocab5000_run", "multihost_demo", "profile_trace")
# the measurement vehicles, one a script of scripts/bench_*.py, the regression
# gate, and what they share
BENCH_TOOLS = ("benchlib", "check_regression", "bench_eval", "bench_attend", "bench_serve", "bench_bulk",
               "bench_eval_ab", "bench_early_exit", "bench_diag", "bench_input", "bench_quality",
               "bench_telemetry", "bench_obs", "bench_fleet", "bench_watchdog", "bench_integrity", "bench_ckpt")


def test_import_loads_neither_jax_nor_sat_tpu():
    """The runtime (train, eval, test), the train step and optimizer, the
    scorers, the CLI, the bulk runner and the input pipeline's cache,
    integrity, quarantine and fault hooks, every evidence tool, then every
    submodule, import in a fresh interpreter without loading jax, flax,
    optax or any sat_tpu module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import sat_tpu_torch.runtime, sat_tpu_torch.evalcap, sat_tpu_torch.cli\n"
        "import sat_tpu_torch.train.step, sat_tpu_torch.train.optimizer\n"
        "import sat_tpu_torch.bulk.runner, sat_tpu_torch.data.shards, sat_tpu_torch.data.integrity\n"
        "import sat_tpu_torch.resilience.quarantine, sat_tpu_torch.resilience.faultinject\n"
        "import sat_tpu_torch.telemetry.heartbeat\n"
        "import sat_tpu_torch.telemetry.device, sat_tpu_torch.telemetry.compile_report\n"
        "from sat_tpu_torch.runtime import train, setup_train_state\n"
        f"tools = {TOOLS + BENCH_TOOLS!r}\n"
        "for t in tools: importlib.import_module('sat_tpu_torch.tools.' + t)\n"
        "names = [m.name for m in pkgutil.walk_packages(sat_tpu_torch.__path__, 'sat_tpu_torch.')]\n"
        "assert {'sat_tpu_torch.tools.' + t for t in tools} <= set(names), names\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'sat_tpu'))\n"
        "print(len(names), bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 30
    assert bad == "[]"


def test_campaign_and_vocab5000_load_neither_jax_nor_sat_tpu():
    """``import sat_tpu_torch.tools.chaos_campaign,
    sat_tpu_torch.tools.vocab5000_run`` in a fresh interpreter: no jax,
    flax, optax or sat_tpu module loads."""
    code = (
        "import sys\n"
        "import sat_tpu_torch.tools.chaos_campaign, sat_tpu_torch.tools.vocab5000_run\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'sat_tpu'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("module", ["utils.benchmarking"] + [f"tools.{t}" for t in BENCH_TOOLS])
def test_measurement_vehicles_load_neither_jax_nor_sat_tpu_nor_torch(module):
    """Each measurement vehicle, the regression gate and the shared
    measurement core, imported alone in a fresh interpreter: no jax,
    flax, optax or sat_tpu module loads, and no torch either (a vehicle
    takes torch inside ``main``)."""
    code = (
        "import sys\n"
        f"import sat_tpu_torch.{module}\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'sat_tpu', 'torch'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("module", ["telemetry.device", "telemetry.compile_report", "telemetry.promtext",
                                    "telemetry.profwin", "resilience.watchdog"])
def test_observability_modules_load_neither_jax_nor_sat_tpu(module):
    """The diag taps, the compile report, the ``/metrics`` listener, the
    ``SIGUSR2`` trigger and the watchdog's postmortem path, each imported
    alone in a fresh interpreter (and the listener and trigger exercised):
    no jax, flax, optax or sat_tpu module loads."""
    code = (
        "import sys\n"
        f"import sat_tpu_torch.{module} as m\n"
        "if hasattr(m, 'SignalTrigger'):\n"
        "    t = m.SignalTrigger(); t.fire(); assert t.pop() and not t.pop()\n"
        "if hasattr(m, 'MetricsListener'):\n"
        "    from sat_tpu_torch import telemetry\n"
        "    ml = m.MetricsListener('127.0.0.1', 0, telemetry.Telemetry(64)); assert ml.start(); ml.stop()\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'sat_tpu'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# the router and the supervisor parent own no device: importing them, and
# the CLI up to their dispatch, loads neither torch nor jax nor sat_tpu
_PARENT_CODE = (
    "import sys\n"
    "{setup}\n"
    "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('torch', 'jax', 'jaxlib', 'sat_tpu'))\n"
    "print(bad)\n"
)
_PARENTS = {
    "modules": "import sat_tpu_torch.serve.router, sat_tpu_torch.serve.replica, "
               "sat_tpu_torch.resilience.supervisor, sat_tpu_torch.telemetry.fleet",
    "cli_route": "from sat_tpu_torch import cli\n"
                 "from sat_tpu_torch.serve import router\n"
                 "router.route = lambda config: 0\n"
                 "assert cli.main(['--phase', 'route', '--num_replicas', '2']) == 0\n"
                 "assert cli.main(['--replicas', '127.0.0.1:1,127.0.0.1:2']) == 0",
    "cli_supervise": "from sat_tpu_torch import cli\n"
                     "from sat_tpu_torch.resilience import supervisor\n"
                     "supervisor.supervise = lambda argv, **kw: 0\n"
                     "assert cli.main(['--phase', 'train', '--supervise', '--watchdog', '1']) == 0\n"
                     "assert cli.main(['--phase', 'serve', '--supervise']) == 0",
    # the modules that emit the train layer's sentinel and epoch metrics
    "train_metric_modules": "import sat_tpu_torch.resilience.sentinel, sat_tpu_torch.data.dataset\n"
                            "from sat_tpu_torch.resilience.sentinel import AnomalySentinel\n"
                            "assert AnomalySentinel('rollback').check(1, {'loss': float('nan')}) == 'rollback'",
    # the live capture only speaks HTTP (port 1: nothing listens, exit 1)
    "profile_trace_live": "import contextlib, io\n"
                          "from sat_tpu_torch.tools import profile_trace\n"
                          "with contextlib.redirect_stdout(io.StringIO()) as said:\n"
                          "    assert profile_trace.main(['--live', '127.0.0.1:1', '100']) == 1\n"
                          "assert 'unreachable' in said.getvalue()",
}


@pytest.mark.parametrize("what", sorted(_PARENTS))
def test_router_and_supervisor_parents_load_no_device_stack(what):
    out = subprocess.run(
        [sys.executable, "-c", _PARENT_CODE.format(setup=_PARENTS[what])],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


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
    # a child process is asked for the CPU through SAT_TORCH_DEVICE: a
    # request, not a fallback
    monkeypatch.setenv("SAT_TORCH_DEVICE", "cpu")
    assert resolve_device() == torch.device("cpu")
    assert engine_mod.ServeEngine(tc, state, vocab).device == torch.device("cpu")
    for bad in ("gpu", "cuda:0", "CPU"):
        monkeypatch.setenv("SAT_TORCH_DEVICE", bad)
        with pytest.raises(ValueError, match="SAT_TORCH_DEVICE"):
            resolve_device()
    monkeypatch.setenv("SAT_TORCH_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    monkeypatch.delenv("SAT_TORCH_DEVICE")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()


@pytest.mark.parametrize(
    "knob",
    [
        {"tenants": "a:1"},  # the tenant plane: accepted and acting, never ignored
        {"encode_cache": "on"},
    ],
)
def test_unported_serve_knobs_raise(knob, tmp_path):
    """Both knobs were refused until the serve plane's model and traffic
    planes were ported (no serve knob raises any longer); now each is
    accepted and acts: the tenant plane's /stats block counts tenant
    ``a``'s two requests, the encode cache's block a miss then a hit."""
    import cv2

    from sat_tpu_torch import telemetry
    from sat_tpu_torch.data.vocabulary import Vocabulary
    from sat_tpu_torch.serve import engine as engine_mod
    from sat_tpu_torch.serve.server import CaptionServer
    from tests.torch_port_helpers import port_params

    assert not hasattr(engine_mod, "check_ported")
    jc, tc = configs(serve_buckets=(1, 2), serve_max_batch=2, summary_dir=str(tmp_path), **knob)
    _, params = port_params(jc, tc)
    vocab = Vocabulary(tc.vocabulary_size)
    vocab.build(["a dog runs on the grass."])
    telemetry.enable()
    try:
        engine = engine_mod.ServeEngine(tc, engine_mod.ServingState(params=params, step=0), vocab, device="cpu")
        engine.warmup()
        server = CaptionServer(tc, engine, port=0, host="127.0.0.1").start()
        try:
            ok, jpeg = cv2.imencode(".jpg", np.random.default_rng(0).integers(0, 256, (32, 32, 3), dtype=np.uint8))
            replies = [server.handle_caption(jpeg.tobytes()) for _ in range(2)]
            stats = server.stats()
        finally:
            server.shutdown()
    finally:
        telemetry.disable()
    assert [status for status, _ in replies] == [200, 200]
    if "tenants" in knob:
        assert replies[0][1]["tenant"] == "a" and stats["tenants"]["a"]["requests"] == 2
    else:
        assert (stats["encode_cache"]["misses"], stats["encode_cache"]["hits"]) == (1, 1)
        assert replies[0][1]["captions"] == replies[1][1]["captions"]


@pytest.mark.parametrize(
    "knob",
    [{"cnn": "resnet50"}, {"encoder_quant": "int8"}, {"encoder_quant": "bf16"}],
    ids=lambda k: next(iter(k.values())),
)
def test_encoder_knobs_pass_every_phase_check(knob):
    """ResNet50 and the quantized encoder run in every ported phase: no
    eval/test or train check refuses them (train, eval and test encode in
    full precision, as the JAX package does), and serve has no knob check
    left."""
    from sat_tpu_torch import runtime
    from sat_tpu_torch.serve import engine as engine_mod

    _, tc = configs(**knob)
    assert not hasattr(engine_mod, "check_ported")
    assert runtime.mesh_for(tc) is None


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
    from sat_tpu_torch.cli import PORTED_PHASES, build_config, main

    config, opts = build_config(
        ["--phase", "serve", "--port", "0", "--max_batch", "4", "--model_file", "x.npz",
         "--set", "beam_size=2", "--set", "serve_buckets=1,4", "--set", "num_initalize_layers=1"]
    )
    assert (config.phase, config.serve_port, config.serve_max_batch) == ("serve", 0, 4)
    assert (config.beam_size, config.serve_buckets, config.num_initialize_layers) == (2, (1, 4), 1)
    assert opts["model_file"] == "x.npz"
    assert "train" in PORTED_PHASES and "route" in PORTED_PHASES
    # --phase route and --supervise reach the port's router and supervisor
    from sat_tpu_torch.resilience import supervisor
    from sat_tpu_torch.serve import router

    reached = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(router, "route", lambda c: reached.append(("route", c.route_num_replicas)) or 0)
        mp.setattr(supervisor, "supervise", lambda argv, **kw: reached.append(("supervise", kw["max_restarts"])) or 0)
        assert main(["--phase", "route", "--num_replicas", "3"]) == 0
        assert main(["--phase", "serve", "--supervise", "--max_restarts", "2"]) == 0
    assert reached == [("route", 3), ("supervise", 2)]
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


def test_tf32_is_off_once_a_card_is_resolved(monkeypatch):
    """``resolve_device`` turns cuDNN's and cuBLAS's TF32 off when it
    resolves a card (patched here to see one); the encoder no longer flips
    the process-wide switch around a call; the CPU leaves it alone."""
    import inspect

    from sat_tpu_torch.device import resolve_device
    from sat_tpu_torch.models import captioner

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cudnn.allow_tf32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    # the card resolves to its index, as a tensor on it names it
    assert resolve_device() == torch.device("cuda", 0)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert "allow_tf32" not in inspect.getsource(captioner)


def test_fused_attend_refuses_to_be_differentiated():
    """The kernel has no backward: with grad enabled and an input that
    requires grad the guard raises (a zero gradient is never returned);
    under no_grad, or with no input requiring grad, it passes."""
    from sat_tpu_torch.ops.fused_attend import _refuse_grad

    t1, t2, w2, ctx = torch.zeros(2, 3, 4), torch.zeros(2, 4), torch.zeros(4, 1), torch.zeros(2, 3, 5)
    _refuse_grad(t1, t2, w2, ctx)
    w2.requires_grad_(True)
    with pytest.raises(RuntimeError, match="fused_attend: the CUDA kernel has no backward"):
        _refuse_grad(t1, t2, w2, ctx)
    with torch.no_grad():
        _refuse_grad(t1, t2, w2, ctx)
