"""Shared set-up of the serve-plane tests (the encode cache, the tier
handoff, the lifecycle, tenants and the quality plane): one small float32
checkpoint in sat_tpu's format, and sat_tpu's and the port's serve
engines and servers booted on it side by side on the CPU, each
package's telemetry registry on."""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np

from sat_tpu_torch import telemetry
from sat_tpu_torch.data.vocabulary import Vocabulary
from sat_tpu_torch.serve.engine import ServeEngine, load_serving_state
from sat_tpu_torch.serve.server import CaptionServer
from tests.test_torch_serve import _jpegs, make_checkpoint
from tests.test_torch_serve_ops import get_json, http  # noqa: F401  (re-exported to the plane tests)

# buckets 1 and 2, a 2 x 2 slot pool, no heartbeat thread
SERVE = dict(serve_buckets=(1, 2), serve_max_batch=2, serve_slot_pages=2, serve_page_width=2,
             heartbeat_interval=0.0)


def world(root, **overrides):
    """A step-5 checkpoint and vocabulary under ``root``; returns
    {"root", "jc", "tc", "jpegs"}."""
    jc, tc, _, _ = make_checkpoint(root, **{**SERVE, **overrides})
    return {"root": root, "jc": jc, "tc": tc, "jpegs": _jpegs(6, seed=11)}


def jax_engine(jc, model_file=None):
    from sat_tpu import telemetry as jtelemetry
    from sat_tpu.data.vocabulary import Vocabulary as JaxVocabulary
    from sat_tpu.serve.engine import ServeEngine as JaxEngine
    from sat_tpu.serve.engine import load_serving_state as jax_load

    state, _ = jax_load(jc, model_file=model_file)
    engine = JaxEngine(jc, state, JaxVocabulary(jc.vocabulary_size, jc.vocabulary_file), tel=jtelemetry.get())
    if jc.serve_mode == "batch":
        engine.warmup()
    return engine


def port_engine(tc, model_file=None):
    state, _ = load_serving_state(tc, model_file=model_file, device="cpu")
    engine = ServeEngine(tc, state, Vocabulary(tc.vocabulary_size, tc.vocabulary_file), device="cpu")
    if tc.serve_mode == "batch":
        engine.warmup()
    return engine


def boot(package: str, config, engine):
    if package == "jax":
        from sat_tpu.serve.server import CaptionServer as JaxServer

        return JaxServer(config, engine, port=0).start()
    return CaptionServer(config, engine, port=0, host="127.0.0.1").start()


@contextlib.contextmanager
def registries():
    """Both packages' telemetry registries on for the block."""
    from sat_tpu import telemetry as jtelemetry

    jtelemetry.enable()
    telemetry.enable()
    try:
        yield
    finally:
        telemetry.disable()
        jtelemetry.disable()


@contextlib.contextmanager
def both_servers(jc, tc, jax_model_file=None, port_model_file=None):
    """sat_tpu's server on ``jc`` and the port's on ``tc`` (each on a fresh
    engine), under both registries; yields {"jax": server, "torch":
    server}."""
    with registries():
        servers = {}
        try:
            servers["jax"] = boot("jax", jc, jax_engine(jc, jax_model_file))
            servers["torch"] = boot("torch", tc, port_engine(tc, port_model_file))
            yield servers
        finally:
            for server in servers.values():
                server.shutdown()


def caption(port, body, headers=None):
    """(status, reply, headers) of a POST /caption of image bytes."""
    status, hdrs, raw = http(port, "POST", "/caption", body, {"Content-Type": "image/jpeg", **(headers or {})})
    return status, json.loads(raw), hdrs


def words(payload):
    return [c["caption"] for c in payload["captions"]]


def beams(payload):
    return [(c["caption"], c["log_prob"]) for c in payload["captions"]]


def close_beams(a, b, atol=1e-5):
    """The same words, log-probs within ``atol`` (the packages sum in
    other orders)."""
    assert words(a) == words(b)
    np.testing.assert_allclose([c["log_prob"] for c in a["captions"]],
                               [c["log_prob"] for c in b["captions"]], rtol=0, atol=atol)


def stage_candidate(config, step: int, seed: int, scale: float = 0.2) -> str:
    """The config's LAST_GOOD checkpoint with its decoder's float tensors
    jittered by N(0, scale) from ``seed``, saved as ``<step>.npz`` with a
    sidecar, LAST_GOOD pointed at it (sat_tpu's lineage writes both, so
    the two packages read the same bytes)."""
    from sat_tpu.data.vocabulary import vocab_fingerprint
    from sat_tpu.resilience import lineage

    src = lineage.last_good_checkpoint(config.save_dir)
    rng = np.random.default_rng(seed)
    with np.load(src) as z:
        flat = {k: z[k] for k in z.files}
    for k in sorted(flat):
        if k.startswith("params/decoder/") and flat[k].dtype.kind == "f":
            flat[k] = (flat[k] + rng.normal(0, scale, flat[k].shape)).astype(flat[k].dtype)
    flat["global_step"] = np.asarray(step, np.int32)
    path = os.path.join(config.save_dir, f"{step}.npz")
    np.savez(path, **flat)
    lineage.write_sidecar(path, vocab=vocab_fingerprint(config.vocabulary_file, config.vocabulary_size))
    lineage.mark_last_good(config.save_dir, step)
    return path
