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
so every busy span is a request's.

**Param slots** (the lifecycle and tenant planes): besides the
incumbent, the engine holds a staged canary candidate and any number of
resident models, each the dict the engine computes at load
(``compute_params``, or the quantized ``qcnn`` with the decoder), never
the raw checkpoint.  A set must match the incumbent's key set, shapes,
dtypes and device (:meth:`ServeEngine._validate_compat`), so every slot
runs through the same warmed encode lanes, searches and slot pools.

**Encode cache** (``encode_cache="on"``): batch dispatches with content
keys encode only their unique misses, at the smallest bucket that holds
them, and gather every row from the ring (``serve.encode_cache``);
promote and rollback flush it.  **Tier handoff**: ``context_batch``
stacks pre-encoded grids for the search (no encode; the JAX package's
``dispatch_contexts`` less the search), ``encode_one`` is ``POST
/encode``'s width-1 encode.  **Quality**: ``serve_quality="on"`` carries
the alphas through the search and ``drain_output`` returns them.
"""

from __future__ import annotations

import sys
import threading
import time
from contextlib import contextmanager
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


def _leaves(tree, prefix: str = ""):
    """(path, leaf) of a nested dict of params, in key order."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


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
        self.device = resolve_device(device)
        self._tel = tel if tel is not None else telemetry.get()
        self.config = config
        self.vocabulary = vocabulary
        self.eos_id = vocabulary.word2idx["."]
        self.step = int(state.step)
        self.encoder_quant = config.encoder_quant
        t0 = time.perf_counter()
        self._params = self.slot_params(state.params, state.batch_stats)
        self.quantize_seconds = 0.0
        if config.encoder_quant != "off":
            self.quantize_seconds = time.perf_counter() - t0
            self._tel.gauge("serve/encoder_quantize_seconds", round(self.quantize_seconds, 3))
            print(
                f"sat_tpu_torch: serve encoder quantized ({config.encoder_quant}, {config.cnn}) "
                f"in {self.quantize_seconds:.2f}s",
                file=sys.stderr,
                flush=True,
            )
        self.buckets = _effective_buckets(config.serve_buckets, config.serve_max_batch)
        self.loader = ImageLoader(size=config.image_size, raw=config.device_preprocess)
        self._image_dtype = np.uint8 if config.device_preprocess else np.float32
        self.warm_seconds = 0.0
        self._return_alphas = config.serve_quality == "on"
        # content-addressed encode cache: built here, its ring sized at
        # warmup (buckets in batch mode, pool lanes in continuous mode)
        self.encode_cache = None
        if config.encode_cache == "on":
            from .encode_cache import EncodeCache

            self.encode_cache = EncodeCache(config.encode_cache_mb, tel=self._tel)
        # the context row's shape [N, D] and dtype, set by whichever warmup
        # runs; the decode tier checks handoff grids against it
        self.ctx_row_shape: Optional[Tuple[int, ...]] = None
        self.ctx_row_dtype = None
        # POST /encode runs on HTTP threads, one at a time
        self._enc_one_lock = threading.Lock()
        self._enc_one_warm = False
        # the lifecycle's staged candidate and the tenants' resident
        # models: extra param sets beside the incumbent's
        self._candidate: Optional[Dict[str, Any]] = None
        self._residents: Dict[str, Dict[str, Any]] = {}

    def slot_params(self, params: Dict[str, Any], batch_stats: Dict[str, Any]) -> Dict[str, Any]:
        """A checkpoint's params (float32, any device) → the set a slot
        holds on this engine's device: ``compute_params``, or with
        ``encoder_quant`` on the quantized ``qcnn`` beside the decoder
        (the float32 CNN and ResNet50's statistics, folded into the conv
        biases, leave it).  The encoder is folded and quantized on this
        device one conv at a time, so a tree on the host (a candidate's)
        never lands there whole: only its folded kernels, for the
        calibration, and the decoder do."""
        if self.config.encoder_quant == "off":
            params = to_device(params, self.device)
            batch_stats = to_device(batch_stats, self.device)
            return compute_params(params, self.config, batch_stats)
        qcnn = quantize_encoder({"cnn": params["cnn"], "batch_stats": batch_stats}, self.config, device=self.device)
        decoder = to_device({"decoder": params["decoder"]}, self.device)
        out = {**compute_params(decoder, self.config), "qcnn": qcnn}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    @contextmanager
    def on_device(self):
        """This engine's device and inference mode on the calling thread
        (both are thread-local): for device work off the batcher's
        thread, such as ``POST /encode``, the lifecycle loader and the
        shadow loop."""
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            yield

    # -- param slots (the lifecycle and tenant planes) ---------------------

    def slot_variables(self, slot: str = "incumbent") -> Dict[str, Any]:
        """The param set ``slot`` runs: the canary falls back to the
        incumbent when no candidate is staged (in-flight canary work
        during a rollback completes on real params), a resident alias
        resolves its own set."""
        if slot == "canary" and self._candidate is not None:
            return self._candidate["variables"]
        resident = self._residents.get(slot)
        if resident is not None:
            return resident["variables"]
        return self._params

    def slot_decoder_params(self, slot: str = "incumbent") -> Dict[str, Any]:
        return self.slot_variables(slot)["decoder"]

    @property
    def candidate_step(self) -> Optional[int]:
        return None if self._candidate is None else self._candidate["step"]

    def param_fingerprint(self, slot: str = "incumbent") -> Tuple:
        """The identity of the params ``slot`` resolves to now: the
        generation part of an encode-cache key, so a grid encoded under
        one model never serves a hit under another."""
        if slot == "canary" and self._candidate is not None:
            return ("canary", self._candidate["step"], self.encoder_quant)
        resident = self._residents.get(slot)
        if resident is not None:
            return (slot, resident["step"], self.encoder_quant)
        return ("incumbent", self.step, self.encoder_quant)

    def _validate_compat(self, variables: Dict[str, Any], source: str, what: str = "candidate") -> None:
        """Raise ValueError unless a param set has the incumbent's key set
        and, leaf by leaf, its shape, dtype and device: the warmed lanes,
        searches and pools then run it unchanged.  Called before the set
        can see a request."""
        have_leaves, want_leaves = dict(_leaves(variables)), dict(_leaves(self._params))
        if set(have_leaves) != set(want_leaves):
            diff = sorted(set(have_leaves) ^ set(want_leaves))
            raise ValueError(
                f"{what} key set differs from the incumbent ({source}): {diff[:4]}; "
                "the warmed paths cannot run it"
            )
        for key, h in have_leaves.items():
            w = want_leaves[key]
            if isinstance(w, torch.Tensor) != isinstance(h, torch.Tensor):
                raise ValueError(f"{what} leaf {key} is of another kind than the incumbent's ({source})")
            if isinstance(w, torch.Tensor) and (h.shape != w.shape or h.dtype != w.dtype or h.device != w.device):
                raise ValueError(
                    f"{what} leaf {key} {tuple(h.shape)}/{h.dtype}/{h.device} vs incumbent "
                    f"{tuple(w.shape)}/{w.dtype}/{w.device} ({source}): geometry drift, rejecting"
                )

    def install_candidate(self, variables: Dict[str, Any], decoder_params, step: int, source: str) -> None:
        """Stage a candidate in the canary slot once ``_validate_compat``
        passes (the caller rejects the checkpoint on a raise).
        ``decoder_params`` is ``variables["decoder"]`` in the port; the
        argument keeps the JAX package's signature, which the lifecycle
        controller calls."""
        self._validate_compat(variables, source)
        self._candidate = {"variables": variables, "step": int(step), "source": source}
        self._tel.gauge("lifecycle/candidate_step", int(step))

    def promote_candidate(self) -> int:
        """The candidate becomes the incumbent and the old set is dropped.
        Callers run this at the batcher's admission boundary, so no batch
        straddles the flip.  Flushes the encode cache; returns the new
        serving step."""
        if self._candidate is None:
            raise RuntimeError("no candidate staged to promote")
        cand, self._candidate = self._candidate, None
        self._params = cand["variables"]
        self.step = cand["step"]
        self._tel.gauge("lifecycle/candidate_step", -1)
        if self.encode_cache is not None:
            self.encode_cache.flush()
        return self.step

    def clear_candidate(self) -> None:
        """Drop a staged candidate (rollback); the canary slot falls back
        to the incumbent for stragglers.  Flushes the encode cache."""
        self._candidate = None
        self._tel.gauge("lifecycle/candidate_step", -1)
        if self.encode_cache is not None:
            self.encode_cache.flush()

    def install_resident(self, alias: str, variables: Dict[str, Any], decoder_params, step: int,
                         source: str) -> None:
        """Hold a resident param set under ``alias`` (``X-Model``, a
        tenant's default model), checked like a candidate; the lifecycle
        slot names are reserved."""
        if alias in ("incumbent", "canary"):
            raise ValueError(f"resident alias {alias!r} collides with a lifecycle slot name")
        self._validate_compat(variables, source, what=f"resident {alias!r}")
        self._residents[alias] = {"variables": variables, "step": int(step), "source": source}
        self._tel.gauge("serve/resident_models", len(self._residents))

    def has_resident(self, alias: str) -> bool:
        return alias in self._residents

    def resident_step(self, alias: str) -> Optional[int]:
        resident = self._residents.get(alias)
        return None if resident is None else resident["step"]

    @property
    def resident_aliases(self) -> Tuple[str, ...]:
        return tuple(self._residents)

    def _set_ctx_row(self, contexts: torch.Tensor) -> None:
        self.ctx_row_shape = tuple(int(d) for d in contexts.shape[1:])
        self.ctx_row_dtype = np.dtype(str(contexts.dtype).replace("torch.", ""))

    # -- startup -----------------------------------------------------------

    @torch.inference_mode()
    def warmup(self) -> None:
        """Run encode + beam search once per bucket on zeros: builds the
        CUDA kernel and settles cuDNN before the first request; sizes the
        encode cache's ring.  Batch mode's re-warm after a wedge, too: it
        returns once the card has answered every bucket.  Records no span
        (no request's work)."""
        size = self.config.image_size
        t0 = time.perf_counter()
        for b in self.buckets:
            contexts = self.encode_images(np.zeros((b, size, size, 3), self._image_dtype))
            self.search(contexts).words.cpu()
        self._set_ctx_row(contexts)
        if self.encode_cache is not None:
            # the ring sized off the real context row, every bucket's
            # width recorded: part of the same pre-ready warmup
            self.encode_cache.ensure_store(
                self.ctx_row_shape, self.ctx_row_dtype, min_rows=max(self.buckets), device=self.device
            )
            self.encode_cache.warm(self.buckets)
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
    def encode_images(self, images: np.ndarray, slot: str = "incumbent") -> torch.Tensor:
        """Host batch [B, S, S, 3] → contexts [B, N, D] on the device,
        under ``slot``'s params."""
        x = torch.from_numpy(images).to(self.device, non_blocking=True)
        return encode(self.slot_variables(slot), self.config, x)

    def _timed_encode(self, images: np.ndarray, slot: str, costs) -> torch.Tensor:
        """``encode_images``; with telemetry on, waits the encode out,
        records ``serve/encode`` and ``serve/encode_lane<width>`` and
        charges each request's ``RequestCost`` in ``costs`` an equal share
        (pad rows bill nobody)."""
        t0 = time.perf_counter_ns()
        contexts = self.encode_images(images, slot)
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

    def encode_batch(self, images: np.ndarray, costs=None, slot: str = "incumbent", keys=None) -> torch.Tensor:
        """Contexts for a padded batch under ``slot``'s params.  With
        ``keys`` (one content key a live request, cache on) the batch goes
        through the encode cache: only unique misses are encoded, at the
        smallest bucket that holds them, and every row is gathered from
        the ring, so a hit row is the exact bits its miss produced and a
        hit request is charged no encode time."""
        if self.encode_cache is None or keys is None:
            return self._timed_encode(images, slot, costs)
        cache = self.encode_cache
        gen = self.param_fingerprint(slot)
        plan = cache.plan([(k, gen) for k in keys])
        try:
            if plan.n_miss:
                mb = self.pick_bucket(plan.n_miss)
                size = self.config.image_size
                miss_images = np.zeros((mb, size, size, 3), self._image_dtype)
                for j, pos in enumerate(plan.miss_pos):
                    miss_images[j] = images[pos]
                miss_costs = [costs[p] for p in plan.miss_pos] if costs else None
                cache.insert(mb, self._timed_encode(miss_images, slot, miss_costs), plan.miss_rows)
            t0 = time.perf_counter_ns()
            contexts = cache.gather(images.shape[0], plan.rows)
            if self._tel.enabled:
                # the hit path's own latency probe, not a busy span
                if contexts.is_cuda:
                    torch.cuda.synchronize(contexts.device)
                self._tel.record("serve/cache_gather", t0, time.perf_counter_ns() - t0)
        except Exception:
            # the plan registered the miss keys; their rows hold garbage
            cache.drop([(k, gen) for k in plan.miss_keys])
            raise
        return contexts

    @torch.inference_mode()
    def context_batch(self, grids: List[np.ndarray]) -> torch.Tensor:
        """Decode-tier batch: pre-encoded handoff grids (checked at
        ingress) stacked and zero-padded to their bucket, on the device;
        no encode, no encode time charged."""
        bucket = self.pick_bucket(len(grids))
        batch = np.zeros((bucket,) + tuple(self.ctx_row_shape), self.ctx_row_dtype)
        for i, grid in enumerate(grids):
            batch[i] = grid
        self._tel.count("serve/context_dispatches")
        self._tel.count("serve/context_images", len(grids))
        return torch.from_numpy(batch).to(self.device, non_blocking=True)

    @torch.inference_mode()
    def search(self, contexts: torch.Tensor, slot: str = "incumbent") -> BeamResult:
        """Contexts [bucket, N, D] → BeamResult of device tensors (with
        the decode steps run, and the alphas with ``serve_quality`` on)."""
        return beam_search(
            self.slot_decoder_params(slot), self.config, contexts, self.eos_id,
            valid_size=len(self.vocabulary.words), return_alphas=self._return_alphas,
            return_steps=True,
        )

    def dispatch(self, images: np.ndarray, slot: str = "incumbent", costs=None, keys=None) -> BeamResult:
        """Padded batch [bucket, S, S, 3] → BeamResult of device tensors."""
        return self.search(self.encode_batch(images, costs, slot, keys), slot)

    # -- encode tier (POST /encode) ----------------------------------------

    def warm_encode_one(self) -> None:
        """Run the width-1 encode of ``POST /encode`` once on zeros and set
        the context row (an encode-tier server calls this before ready; a
        ``both``-tier server runs it at the first ``/encode``)."""
        if self._enc_one_warm:
            return
        size = self.config.image_size
        with self.on_device():
            contexts = self.encode_images(np.zeros((1, size, size, 3), self._image_dtype))
            contexts.cpu()
        self._set_ctx_row(contexts)
        self._enc_one_warm = True

    def encode_one(self, image: np.ndarray, slot: str = "incumbent") -> np.ndarray:
        """One preprocessed image row → its ``[N, D]`` context grid on the
        host (``POST /encode``'s body before framing).  Serialized by a
        lock: it runs on HTTP threads, and the encode tier holds no
        batch to join."""
        with self._enc_one_lock:
            if not self._enc_one_warm:
                self.warm_encode_one()
            t0 = time.perf_counter_ns()
            with self.on_device():
                grid = self.encode_images(image[None], slot)[0].cpu().numpy()
            if self._tel.enabled:
                self._tel.record("serve/encode", t0, time.perf_counter_ns() - t0)
                self._tel.count("serve/encode_images")
                self._tel.count("serve/encode_lane_slots")
        return grid

    def drain_output(self, out: BeamResult, n: int) -> Tuple[np.ndarray, ...]:
        """Host arrays (words, lengths, log_scores, alphas or None) of the
        ``n`` live rows.
        The search's decode-step count goes to ``serve/decode_steps`` and
        ``serve/steps_per_dispatch`` (raw counts, not ns): the monolithic
        search is one dispatch of that many steps."""
        arrays = (
            out.words[:n].cpu().numpy(),
            out.lengths[:n].cpu().numpy(),
            out.log_scores[:n].cpu().numpy(),
            None if out.alphas is None else out.alphas[:n].cpu().numpy(),
        )
        if out.steps_run is not None:
            steps = int(out.steps_run)
            self._tel.record("serve/decode_steps", 0, steps)
            self._tel.record("serve/steps_per_dispatch", 0, steps)
        return arrays

    def detok_rows(self, arrays: Tuple[np.ndarray, ...], n: int) -> List[Dict[str, Any]]:
        """Detokenize every beam of ``n`` drained rows (a trailing alphas
        element of ``arrays`` is ignored)."""
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

