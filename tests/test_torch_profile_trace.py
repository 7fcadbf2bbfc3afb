"""``python -m sat_tpu_torch.tools.profile_trace`` on the CPU, the port of
``scripts/profile_trace.sh``: the live mode against an in-process port
server (200 with the capture directory, then 409 while that window is
open, then exit 1 on an unreachable server and on any other reply), and
the default mode at the tests' small size (25 train steps, a window over
steps 8-12): ``trace.json`` holding the train step's backward pass, and
``profile_done.txt`` only beside such a capture."""

import http.server
import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from sat_tpu_torch import telemetry
from sat_tpu_torch.data.vocabulary import Vocabulary
from sat_tpu_torch.serve.engine import ServeEngine, load_serving_state
from sat_tpu_torch.serve.server import CaptionServer
from sat_tpu_torch.tools import profile_trace
from tests.test_torch_serve import make_checkpoint

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["image_size=32", "dim_embedding=16", "num_lstm_units=16", "dim_initialize_layer=16",
         "dim_attend_layer=16", "dim_decode_layer=32", "compute_dtype=float32"]


def tool(*args, timeout=120):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("SAT_FI_", "JAX_", "XLA_"))}
    env.update(SAT_TORCH_DEVICE="cpu", OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "sat_tpu_torch.tools.profile_trace", *args],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=timeout)


@pytest.fixture()
def server(tmp_path):
    _, tc, _, _ = make_checkpoint(tmp_path, serve_buckets=(1, 2), serve_max_batch=2)
    tc = tc.replace(telemetry_dir=str(tmp_path / "telemetry"))
    telemetry.enable()
    state, _ = load_serving_state(tc, device="cpu")
    engine = ServeEngine(tc, state, Vocabulary(tc.vocabulary_size, tc.vocabulary_file), device="cpu")
    engine.warmup()
    srv = CaptionServer(tc, engine, port=0, host="127.0.0.1").start()
    try:
        yield srv
    finally:
        srv.shutdown()
        telemetry.disable()


def test_live_window_opens_then_409_while_it_runs(server):
    """The first call opens a window (exit 0, the reply and the banner);
    the second, while that window runs, is the 409 (exit 1); the window
    then writes its trace.json."""
    addr = f"127.0.0.1:{server.port}"
    first = tool("--live", addr, "2000")
    assert first.returncode == 0, first.stdout + first.stderr
    body, banner = first.stdout.strip().splitlines()
    assert banner == "profiler window open for 2000 ms"
    out_dir = json.loads(body)["profile_dir"]
    second = tool("--live", addr, "2000")
    assert second.returncode == 1
    assert second.stdout.strip().splitlines()[-1] == "capture already in progress (409)"
    server.profiles.wait(timeout=60)
    assert os.path.exists(os.path.join(out_dir, "trace.json"))


def test_live_unreachable_server_exits_1():
    from tests.torch_dist_helpers import free_port

    addr = f"127.0.0.1:{free_port()}"
    out = tool("--live", addr, "100")
    assert out.returncode == 1
    assert out.stdout.strip() == f"live capture failed: server at {addr} unreachable"


def test_live_other_reply_is_refused_and_usage_exits_1():
    """A reply that is neither a capture nor a 409 (a profiler that failed
    to start answers 503) exits 1 with the script's message; ``--live``
    without an address prints the usage and exits 1."""

    class Refusing(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.dumps({"error": "profiler start failed: busy"}).encode()
            self.send_response(503)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    httpd = http.server.HTTPServer(("127.0.0.1", 0), Refusing)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        out = tool("--live", f"127.0.0.1:{httpd.server_address[1]}")
    finally:
        httpd.shutdown()
    assert out.returncode == 1
    assert out.stdout.strip().splitlines() == ['{"error": "profiler start failed: busy"}', "live capture refused"]
    usage = tool("--live")
    assert usage.returncode == 1 and "usage:" in usage.stderr


def _sets(args):
    return [x for s in args for x in ("--extra-set", s)]


def test_default_mode_captures_the_train_window(tmp_path):
    """The corpus, then 25 steps at batch 32 with the window over steps
    8-12: rc 0, one trace.json with the backward pass, profile_done.txt
    and the step-25 checkpoint."""
    out_dir = tmp_path / "trace"
    first = tool(str(out_dir), *_sets(SMALL), timeout=300)
    assert first.returncode == 0, first.stdout + (out_dir / "profile_train.log").read_text()[-3000:]
    traces = list((out_dir / "profile_run_trace").glob("*/trace.json"))
    assert len(traces) == 1 and profile_trace.train_step_events(str(traces[0])) > 0
    done = (out_dir / "profile_done.txt").read_text()
    assert done.strip() == f"trace captured under {out_dir / 'profile_run_trace'}" == first.stdout.strip()
    assert (out_dir / "profile_corpus.log").exists()
    assert (out_dir / "profile_run" / "models2" / "25.npz").exists()     # max_steps=25


def test_default_mode_failure_writes_no_done_marker(tmp_path):
    """A train run that fails (an unknown Config field) leaves no
    profile_done.txt and exits 1 with the script's message."""
    out_dir = tmp_path / "trace"
    out = tool(str(out_dir), *_sets(SMALL + ["no_such_field=1"]), timeout=300)
    assert out.returncode == 1
    assert out.stdout.strip() == f"trace capture failed (rc=1) — see {out_dir / 'profile_train.log'}"
    assert not (out_dir / "profile_done.txt").exists()


def test_incomplete_trace_has_no_train_step_events(tmp_path):
    """A trace cut short (unparseable) or one without a backward pass does
    not count as a capture."""
    cut = tmp_path / "cut.json"
    cut.write_text('{"traceEvents": [{"name": "aten::mm"')
    assert profile_trace.train_step_events(str(cut)) == 0
    decode_only = tmp_path / "decode.json"
    decode_only.write_text(json.dumps({"traceEvents": [{"name": "aten::mm"}, {"name": "aten::topk"}]}))
    assert profile_trace.train_step_events(str(decode_only)) == 0
