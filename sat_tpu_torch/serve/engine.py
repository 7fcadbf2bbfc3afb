"""Serving engine — the port of ``sat_tpu.serve.engine``.

Loads frozen params through the checkpoint lineage (``LAST_GOOD`` first,
walking back past rotted files; a save_dir without a pointer falls back to
the newest checkpoint that verifies), pads each batch up to a bucket of
``serve_buckets``, and runs ``encode`` + ``beam_search`` on its device.

PyTorch runs eagerly, so there are no AOT executables: ``warmup`` runs
every bucket once on zeros instead, which builds the CUDA kernel and
settles cuDNN's algorithm choice before the first request.  Continuous
mode decodes through ``serve.slot_pool`` instead, which warms its own
lanes.  ``tel`` is the telemetry registry the engine's pools record into
(the process-global one unless given).

With ``encoder_quant`` on, the engine quantizes the CNN once at load,
before any warmup (``nn.quant``), and then holds only the quantized
encoder: the float32 CNN and ResNet50's running statistics (folded into
the conv biases) leave its params.  Batch dispatches and the slot pool's
encode lanes all encode through :meth:`ServeEngine.encode_images`.

With the telemetry registry on, ``encode_batch`` waits the encode out
and records ``serve/encode`` (charging each request's ``RequestCost`` an
equal share), ``preprocess`` records ``serve/preprocess`` and
``drain_output`` the search's decode-step count; warmups record nothing,
so every busy span is a request's.  The encode cache, the tier handoff,
tenants and canary/resident param slots are later slices of the port;
their knobs raise here.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from ..config import Config
from ..data.images import ImageLoader
from ..data.vocabulary import Vocabulary, vocab_fingerprint
from ..device import resolve_device
from ..models.captioner import encode
from ..nn.quant import quantize_encoder
from ..ops.beam_search import BeamResult, beam_search
from ..resilience import lineage
from ..train.checkpoint import (
    ServingState, check_vocab, compute_params, load_flat, state_from_flat, to_device, walk_back,
)


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


def check_ported(config: Config) -> None:
    """Raise on serve knobs whose subsystem is not ported yet."""
    unported = {
        "encode_cache": (config.encode_cache, "off"),
        "serve_quality": (config.serve_quality, "off"),
        "serve_tier": (config.serve_tier, "both"),
        "tenants": (config.tenants, ""),
        "model_reload": (config.model_reload, 0.0),
    }
    for name, (value, ported) in unported.items():
        if value != ported:
            raise NotImplementedError(
                f"{name}={value!r} is not ported to sat_tpu_torch yet (only {ported!r})"
            )


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
        flat, source = walk_back(config.save_dir, expect)
    return state_from_flat(flat, config, dev, source), source


def _effective_buckets(buckets: Sequence[int], max_batch: int) -> Tuple[int, ...]:
    """Every bucket below max_batch, plus the first one that holds a full
    max_batch dispatch."""
    out = [int(b) for b in buckets if b < max_batch]
    for b in buckets:
        if b >= max_batch:
            out.append(int(b))
            break
    return tuple(out)


class ServeEngine:
    """Frozen params on one device, a bucket ladder, and the host-side
    pad / drain / detokenize steps around each dispatch."""

    def __init__(
        self,
        config: Config,
        state: ServingState,
        vocabulary: Vocabulary,
        device=None,
        tel=None,
    ) -> None:
        check_ported(config)
        self.device = resolve_device(device)
        self._tel = tel if tel is not None else telemetry.get()
        self.config = config
        self.vocabulary = vocabulary
        self.eos_id = vocabulary.word2idx["."]
        self.step = int(state.step)
        params = to_device(state.params, self.device)
        batch_stats = to_device(state.batch_stats, self.device)
        self.encoder_quant = config.encoder_quant
        self.quantize_seconds = 0.0
        if config.encoder_quant != "off":
            t0 = time.perf_counter()
            qcnn = quantize_encoder({"cnn": params["cnn"], "batch_stats": batch_stats}, config)
            self._params = {**compute_params({"decoder": params["decoder"]}, config), "qcnn": qcnn}
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.quantize_seconds = time.perf_counter() - t0
            self._tel.gauge("serve/encoder_quantize_seconds", round(self.quantize_seconds, 3))
            print(
                f"sat_tpu_torch: serve encoder quantized ({config.encoder_quant}, {config.cnn}) "
                f"in {self.quantize_seconds:.2f}s",
                file=sys.stderr,
                flush=True,
            )
        else:
            self._params = compute_params(params, config, batch_stats)
        self.buckets = _effective_buckets(config.serve_buckets, config.serve_max_batch)
        self.loader = ImageLoader(size=config.image_size, raw=config.device_preprocess)
        self._image_dtype = np.uint8 if config.device_preprocess else np.float32
        self.warm_seconds = 0.0

    # -- startup -----------------------------------------------------------

    @torch.inference_mode()
    def warmup(self) -> None:
        """Run encode + beam search once per bucket on zeros: builds the
        CUDA kernel and settles cuDNN before the first request.  Batch
        mode's re-warm after a wedge, too: it returns once the card has
        answered every bucket.  Records no span (no request's work)."""
        size = self.config.image_size
        t0 = time.perf_counter()
        for b in self.buckets:
            out = self.search(self.encode_images(np.zeros((b, size, size, 3), self._image_dtype)))
            out.words.cpu()
        self.warm_seconds = time.perf_counter() - t0
        self._tel.gauge("serve/warm_buckets", len(self.buckets))
        self._tel.gauge("serve/warm_seconds", round(self.warm_seconds, 3))
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
        with self._tel.span("serve/preprocess"):
            return self.loader.load_bytes(data)

    @property
    def decoder_params(self) -> Dict[str, Any]:
        return self._params["decoder"]

    @torch.inference_mode()
    def encode_images(self, images: np.ndarray) -> torch.Tensor:
        """Host batch [B, S, S, 3] → contexts [B, N, D] on the device."""
        x = torch.from_numpy(images).to(self.device, non_blocking=True)
        return encode(self._params, self.config, x)

    def encode_batch(self, images: np.ndarray, costs=None) -> torch.Tensor:
        """``encode_images`` on a padded batch; with telemetry on, waits
        the encode out, records ``serve/encode`` and
        ``serve/encode_lane<bucket>`` and charges each live request's
        ``RequestCost`` in ``costs`` an equal share (pad rows bill
        nobody)."""
        t0 = time.perf_counter_ns()
        contexts = self.encode_images(images)
        if self._tel.enabled:
            if contexts.is_cuda:
                torch.cuda.synchronize(contexts.device)
            dur = time.perf_counter_ns() - t0
            self._tel.record("serve/encode", t0, dur)
            self._tel.record(f"serve/encode_lane{images.shape[0]}", t0, dur)
            if costs:
                share = dur // len(costs)
                for cost in costs:
                    if cost is not None:
                        cost.add_encode(share)
                self._tel.count("serve/encode_images", len(costs))
                self._tel.count("serve/encode_lane_slots", images.shape[0])
        return contexts

    @torch.inference_mode()
    def search(self, contexts: torch.Tensor) -> BeamResult:
        """Contexts [bucket, N, D] → BeamResult of device tensors (with
        the decode steps run)."""
        return beam_search(
            self.decoder_params, self.config, contexts, self.eos_id,
            valid_size=len(self.vocabulary.words), return_steps=True,
        )

    def dispatch(self, images: np.ndarray) -> BeamResult:
        """Padded batch [bucket, S, S, 3] → BeamResult of device tensors."""
        return self.search(self.encode_batch(images))

    def drain_output(self, out: BeamResult, n: int) -> Tuple[np.ndarray, ...]:
        """Host arrays (words, lengths, log_scores) of the ``n`` live rows.
        The search's decode-step count goes to ``serve/decode_steps`` and
        ``serve/steps_per_dispatch`` (raw counts, not ns): the monolithic
        search is one dispatch of that many steps."""
        arrays = (
            out.words[:n].cpu().numpy(),
            out.lengths[:n].cpu().numpy(),
            out.log_scores[:n].cpu().numpy(),
        )
        if out.steps_run is not None:
            steps = int(out.steps_run)
            self._tel.record("serve/decode_steps", 0, steps)
            self._tel.record("serve/steps_per_dispatch", 0, steps)
        return arrays

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

