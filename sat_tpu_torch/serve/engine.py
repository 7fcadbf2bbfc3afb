"""Serving engine — the port of ``sat_tpu.serve.engine``.

Loads frozen params through the checkpoint lineage (``LAST_GOOD`` first,
walking back past rotted files; a save_dir without a pointer falls back to
the newest checkpoint that verifies), pads each batch up to a bucket of
``serve_buckets``, and runs ``encode`` + ``beam_search`` on its device.

PyTorch runs eagerly, so there are no AOT executables: ``warmup`` runs
every bucket once on zeros instead, which builds the CUDA kernel and
settles cuDNN's algorithm choice before the first request.  Continuous
mode decodes through ``serve.slot_pool`` instead, which warms its own
lanes.  The encode cache, quantization, canary/resident param slots, the
wedge watchdog and telemetry spans are later slices of the port; their
knobs raise here.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.images import ImageLoader
from ..data.vocabulary import Vocabulary, vocab_fingerprint
from ..device import resolve_device
from ..models.captioner import check_encoder, encode
from ..ops.beam_search import BeamResult, beam_search
from ..resilience import lineage
from ..train.checkpoint import check_vocab, load_flat, params_from_flat


class BucketOverflow(ValueError):
    """A batch larger than the largest bucket: an admission-side overload
    (HTTP 429), not a server fault."""

    def __init__(self, n: int, buckets: Sequence[int]):
        super().__init__(
            f"batch of {n} exceeds the largest warmed bucket "
            f"{buckets[-1]} (serve_buckets={tuple(buckets)})"
        )
        self.n = n
        self.largest = int(buckets[-1])


class ServingState(NamedTuple):
    params: Dict[str, Any]   # params_from_flat layout, on the serving device
    step: int                # the checkpoint's global_step


def check_ported(config: Config) -> None:
    """Raise on serve knobs whose subsystem is not ported yet."""
    check_encoder(config)
    unported = {
        "encode_cache": (config.encode_cache, "off"),
        "serve_quality": (config.serve_quality, "off"),
        "serve_tier": (config.serve_tier, "both"),
        "tenants": (config.tenants, ""),
        "model_reload": (config.model_reload, 0.0),
        "serve_wedge_timeout_ms": (config.serve_wedge_timeout_ms, 0.0),
    }
    for name, (value, ported) in unported.items():
        if value != ported:
            raise NotImplementedError(
                f"{name}={value!r} is not ported to sat_tpu_torch yet (only {ported!r})"
            )


def _walk_back(save_dir: str, expect: Optional[dict]) -> Tuple[Dict[str, np.ndarray], str]:
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


def load_serving_state(
    config: Config, model_file: Optional[str] = None, device=None
) -> Tuple[ServingState, str]:
    """Frozen params for serving; returns ``(state, source)``.

    An explicit ``model_file`` is loaded as-is.  Otherwise the verified
    ``LAST_GOOD`` target wins, and a save_dir without one falls back to
    the newest checkpoint that verifies.  The configured vocabulary must
    match the one the checkpoint's sidecar attests."""
    dev = resolve_device(device)
    expect = vocab_fingerprint(config.vocabulary_file, config.vocabulary_size)
    source = model_file or lineage.last_good_checkpoint(config.save_dir)
    if source is not None:
        check_vocab(source, expect)
        flat = load_flat(source)
    else:
        flat, source = _walk_back(config.save_dir, expect)
    if not any(k.startswith("params/") for k in flat):
        raise ValueError(f"serving checkpoint {source} restored 0 tensors")
    params = params_from_flat(flat, config, dev)
    step = int(np.asarray(flat.get("global_step", 0)))
    return ServingState(params=params, step=step), source


def _effective_buckets(buckets: Sequence[int], max_batch: int) -> Tuple[int, ...]:
    """Every bucket below max_batch, plus the first one that holds a full
    max_batch dispatch."""
    out = [int(b) for b in buckets if b < max_batch]
    for b in buckets:
        if b >= max_batch:
            out.append(int(b))
            break
    return tuple(out)


def _compute_params(params: Dict[str, Any], config: Config) -> Dict[str, Any]:
    """The serving copy of the params: conv weights and dense kernels and
    biases cast once to ``compute_dtype`` (each op would round them to it
    anyway, so values are unchanged), conv weights ``channels_last``.
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


class ServeEngine:
    """Frozen params on one device, a bucket ladder, and the host-side
    pad / drain / detokenize steps around each dispatch."""

    def __init__(
        self,
        config: Config,
        state: ServingState,
        vocabulary: Vocabulary,
        device=None,
    ) -> None:
        check_ported(config)
        self.device = resolve_device(device)
        self.config = config
        self.vocabulary = vocabulary
        self.eos_id = vocabulary.word2idx["."]
        self.step = int(state.step)
        self._params = _compute_params(
            {k: _to(v, self.device) for k, v in state.params.items()}, config
        )
        self.buckets = _effective_buckets(config.serve_buckets, config.serve_max_batch)
        self.loader = ImageLoader(size=config.image_size, raw=config.device_preprocess)
        self._image_dtype = np.uint8 if config.device_preprocess else np.float32
        self.warm_seconds = 0.0

    # -- startup -----------------------------------------------------------

    def warmup(self) -> None:
        """Run encode + beam search once per bucket on zeros: builds the
        CUDA kernel and settles cuDNN before the first request."""
        size = self.config.image_size
        t0 = time.perf_counter()
        for b in self.buckets:
            out = self.dispatch(np.zeros((b, size, size, 3), self._image_dtype))
            self.drain_output(out, b)
        self.warm_seconds = time.perf_counter() - t0
        print(
            f"sat_tpu_torch: serve warmup — buckets {self.buckets} on "
            f"{self.device} in {self.warm_seconds:.1f}s",
            file=sys.stderr,
            flush=True,
        )

    # -- batching geometry -------------------------------------------------

    def pick_bucket(self, n: int) -> int:
        """Smallest bucket that holds ``n`` requests."""
        for b in self.buckets:
            if b >= n:
                return b
        raise BucketOverflow(n, self.buckets)

    def pad_batch(self, images: List[np.ndarray]) -> Tuple[np.ndarray, int]:
        """Stack request images and zero-pad up to the chosen bucket.  Rows
        are independent, so pad rows never perturb real rows."""
        bucket = self.pick_bucket(len(images))
        size = self.config.image_size
        batch = np.zeros((bucket, size, size, 3), self._image_dtype)
        for i, image in enumerate(images):
            batch[i] = image
        return batch, bucket

    # -- request path ------------------------------------------------------

    def preprocess(self, data: bytes) -> np.ndarray:
        """POSTed image bytes → one model input row; ValueError on bytes
        that do not decode (the frontend's 400)."""
        return self.loader.load_bytes(data)

    @property
    def decoder_params(self) -> Dict[str, Any]:
        return self._params["decoder"]

    @torch.inference_mode()
    def encode_images(self, images: np.ndarray) -> torch.Tensor:
        """Host batch [B, S, S, 3] → contexts [B, N, D] on the device."""
        x = torch.from_numpy(images).to(self.device, non_blocking=True)
        return encode(self._params, self.config, x)

    @torch.inference_mode()
    def dispatch(self, images: np.ndarray) -> BeamResult:
        """Padded batch [bucket, S, S, 3] → BeamResult of device tensors."""
        return beam_search(
            self.decoder_params, self.config, self.encode_images(images), self.eos_id,
            valid_size=len(self.vocabulary.words), return_steps=True,
        )

    def drain_output(self, out: BeamResult, n: int) -> Tuple[np.ndarray, ...]:
        """Host arrays (words, lengths, log_scores) of the ``n`` live rows."""
        return (
            out.words[:n].cpu().numpy(),
            out.lengths[:n].cpu().numpy(),
            out.log_scores[:n].cpu().numpy(),
        )

    def detok_rows(self, arrays: Tuple[np.ndarray, ...], n: int) -> List[Dict[str, Any]]:
        """Detokenize every beam of ``n`` drained rows."""
        words, lengths, scores = arrays[:3]
        results = []
        for i in range(n):
            captions = []
            for k in range(words.shape[1]):
                length = max(1, int(lengths[i, k]))
                captions.append(
                    {
                        "caption": self.vocabulary.get_sentence(words[i, k, :length]),
                        "log_prob": float(scores[i, k]),
                        "prob": float(np.exp(scores[i, k])),
                    }
                )
            results.append({"captions": captions})
        return results

    def decode_output(self, out: BeamResult, n: int) -> List[Dict[str, Any]]:
        return self.detok_rows(self.drain_output(out, n), n)


def _to(node, device):
    if isinstance(node, dict):
        return {k: _to(v, device) for k, v in node.items()}
    return node.to(device)
