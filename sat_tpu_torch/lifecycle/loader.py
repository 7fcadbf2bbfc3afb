"""Candidate checkpoint loading for the hot-swap path — the port of
``sat_tpu.lifecycle.loader``.

Loads a lineage-blessed checkpoint into one of the engine's extra param
slots (the lifecycle's canary, or a tenant's resident model) while the
incumbent keeps serving, with every guard that can fail doing so before
device memory is spent:

1. lineage integrity (``lineage.verify_checkpoint``: the sidecar's
   sha256, or the zip CRC walk);
2. the vocabulary fingerprint (``VocabMismatchError``: a candidate
   trained against another vocabulary would caption in gibberish);
3. the host-side flat load (``checkpoint.load_flat``, numpy);
4. full coverage of the serving model: ``params_from_flat`` refuses a
   checkpoint that lacks a tensor of the config or holds one of another
   shape (a tolerant partial restore is right for a training resume,
   wrong for a model that will serve);
5. the engine's ``slot_params``: ``compute_params`` on its device, or
   with ``encoder_quant`` the encoder folded and quantized on the device
   one conv at a time from this host tree, so the candidate's float32
   CNN never lands there whole (only its folded kernels, for the
   calibration, and the decoder do), and the slot holds what the engine
   computed for the incumbent at load.

It runs on the controller's thread (or the server's, for residents), so
it takes the engine's device and inference mode itself: both are
thread-local.  The engine's ``_validate_compat`` (shapes, dtypes,
device) then runs at install.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict

from ..resilience import lineage


def load_candidate(engine, config, path: str) -> Dict[str, Any]:
    """Load ``path`` as a param set for ``engine``.

    Returns ``{"variables", "decoder_params", "step", "source",
    "load_seconds"}`` ready for ``engine.install_candidate`` (or
    ``install_resident``).  Raises ``ValueError``/``KeyError``
    (integrity, coverage, geometry) or ``VocabMismatchError``; the
    controller maps any raise to a lineage rejection."""
    import numpy as np
    import torch

    from ..data.vocabulary import vocab_fingerprint
    from ..train import checkpoint

    ok, reason = lineage.verify_checkpoint(path)
    if not ok:
        raise ValueError(f"candidate {path} failed verification: {reason}")
    expect = vocab_fingerprint(config.vocabulary_file, config.vocabulary_size)
    checkpoint.check_vocab(path, expect)  # raises VocabMismatchError

    t0 = time.perf_counter()
    flat = checkpoint.load_flat(path)  # host numpy only
    step = int(np.asarray(flat.get("global_step", 0)))
    try:
        # the tensors on the host first: a partial or drifted file fails
        # here, before any device memory is spent on it
        params = checkpoint.params_from_flat(flat, config, "cpu")
        batch_stats = checkpoint.batch_stats_from_flat(flat, config, "cpu")
    except KeyError as e:
        raise ValueError(
            f"candidate {os.path.basename(path)} does not cover the serving model: {e.args[0]}; rejecting"
        ) from None
    with engine.on_device():
        variables = engine.slot_params(params, batch_stats)
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
    load_s = time.perf_counter() - t0
    print(
        f"sat_tpu_torch: lifecycle candidate {os.path.basename(path)} (step {step}) staged in {load_s:.2f}s",
        file=sys.stderr,
        flush=True,
    )
    return {
        "variables": variables,
        "decoder_params": variables["decoder"],
        "step": step,
        "source": path,
        "load_seconds": load_s,
    }
