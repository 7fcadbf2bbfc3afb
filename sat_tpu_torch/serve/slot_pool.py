"""Fixed-capacity paged slot pool — the port of ``sat_tpu.serve.slot_pool``.

Decode state lives in one fixed ``SlotCarry`` of ``pages × page_width``
slots on the engine's device.  Admission runs through encode lanes: a
burst of admitted images is encoded at the smallest lane width (powers of
two up to ``page_width``) that holds it, and one ``init_slots`` gather
seeds the lane into whichever slots are free.  Every tick is one fused
``decode_multi_step`` window over the whole pool; finished slots are
merged by ``harvest_slots`` and freed.

PyTorch runs eagerly, so there are no AOT executables: ``warmup`` runs
each lane width, one seed and one window once on zeros, which builds the
CUDA kernel and settles cuDNN's algorithm choice before the server is
ready.  A pool runs one of the engine's param slots (``param_slot``):
the lifecycle's canary pool and each resident model's pool are
``clone_warmed`` copies, a fresh carry over the same engine.  Admission
takes three kinds of lane: images through the encoder, images through
the engine's encode cache (``encode_cache="on"``: only unique misses
encoded, every row gathered from the ring), and pre-encoded handoff
grids (``_ctx_lane``, the decode tier), in runs of one kind.  With
``serve_quality="on"`` the carry holds each hypothesis' alphas and
``harvest`` drains them.

With the telemetry registry enabled (``tel``, the engine's by default)
each lane encode waits for the device, records ``serve/encode`` and
``serve/encode_lane<k>`` and charges each admitted payload carrying a
``cost`` (a serve request's ``RequestCost``) an equal share of it; with
it off, admission stays fully asynchronous.  The pool keeps the JAX
pool's gauges (``serve/slot_occupancy``, ``serve/slot_pool_slots``,
``serve/slot_pool_pages``, ``serve/pool_warm_seconds``).

``reset`` (startup, and recovery after a wedged window) starts a new
carry generation: a window still running on a helper thread the
watchdog gave up on cannot write its stale carry over the fresh one.

The pool owns device state and host bookkeeping (free slots, slot →
payload binding) only; when to admit and step is the
``ContinuousBatcher``'s (or the bulk runner's).  Not thread-safe: one
owner thread drives it.
"""

from __future__ import annotations

import sys
import time
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..ops.beam_search import (
    decode_multi_step,
    harvest_slots,
    init_slot_pool,
    init_slots,
    retire_slots,
)


def _lane_widths(page_width: int) -> List[int]:
    """Powers of two below ``page_width``, then ``page_width`` itself: the
    encode-lane widths warmed at startup."""
    widths = []
    w = 1
    while w < page_width:
        widths.append(w)
        w *= 2
    widths.append(page_width)
    return widths


class PagedSlotPool:
    """``pages × page_width`` decode slots over a ``ServeEngine``'s
    params, on its device."""

    def __init__(self, engine, pages=None, page_width=None, tel=None, param_slot: str = "incumbent") -> None:
        config = engine.config
        self.engine = engine
        # the engine param slot this pool runs ("incumbent", "canary" or a
        # resident alias)
        self.param_slot = param_slot
        self._occ_gauge = (
            "serve/slot_occupancy" if param_slot == "incumbent" else f"serve/slot_occupancy_{param_slot}"
        )
        self._tel = tel if tel is not None else engine._tel
        self.config = config
        self.device = engine.device
        self.pages = int(pages if pages is not None else config.serve_slot_pages)
        self.width = int(page_width if page_width is not None else config.serve_page_width)
        self.slots = self.pages * self.width
        self.beam_size = config.beam_size
        self.max_len = config.max_caption_length
        self.valid_size = len(engine.vocabulary.words)
        self.eos_id = engine.eos_id
        self.lane_widths = _lane_widths(self.width)
        # the fused window's depths; config validation pins depths[0] == 1
        self.decode_depths = tuple(config.serve_decode_depth)
        self._free = set(range(self.slots))
        self._payload = {}
        self._mask = np.zeros((self.slots,), np.bool_)
        self._carry = None
        self._generation = 0
        self.warm_seconds = 0.0
        self._return_alphas = config.serve_quality == "on"
        # the last ``admit``'s placements, one an admitted item in order:
        # (lane width, row in the lane, slot) for an image encoded in its
        # lane, None for a cache hit or miss and a handoff grid
        self.admitted: List[Optional[Tuple[int, int, int]]] = []

    # -- startup -----------------------------------------------------------

    @torch.inference_mode()
    def warmup(self) -> None:
        """Run every lane width, a seed, a window and a harvest once on
        zeros (no slot admitted, none active), then start empty."""
        size = self.config.image_size
        engine = self.engine
        t0 = time.perf_counter()
        self.reset()
        nobody = self._on_device(np.zeros((self.slots,), np.bool_))
        for lane in self.lane_widths:
            contexts = engine.encode_images(np.zeros((lane, size, size, 3), engine._image_dtype), self.param_slot)
            self._carry = init_slots(
                self._decoder_params(), self.config, self._carry, contexts,
                self._on_device(np.zeros((self.slots,), np.int64)), nobody,
                beam_size=self.beam_size,
            )
        # the decode tier checks handoff grids against this row, and
        # grid admissions stack into it
        engine._set_ctx_row(contexts)
        cache = engine.encode_cache
        if cache is not None:
            cache.ensure_store(
                engine.ctx_row_shape, engine.ctx_row_dtype, min_rows=max(self.lane_widths), device=self.device
            )
            cache.warm(self.lane_widths)
        self._carry, _, _ = decode_multi_step(
            self._decoder_params(), self.config, self._carry, nobody, self.eos_id,
            k=1, beam_size=self.beam_size, valid_size=self.valid_size,
        )
        harvest_slots(self._carry, self._return_alphas).words.cpu()  # the drain proves the device answers
        self.reset()
        self.warm_seconds = time.perf_counter() - t0
        self._tel.gauge("serve/slot_pool_slots", self.slots)
        self._tel.gauge("serve/slot_pool_pages", self.pages)
        self._tel.gauge("serve/pool_warm_seconds", round(self.warm_seconds, 3))
        print(
            f"sat_tpu_torch: slot pool warmup — {self.pages}x{self.width} slots, "
            f"lanes {self.lane_widths}, decode depths {list(self.decode_depths)} on "
            f"{self.device} in {self.warm_seconds:.1f}s",
            file=sys.stderr,
            flush=True,
        )

    @torch.inference_mode()
    def reset(self) -> None:
        """A fresh empty carry and every slot free.  Bound payloads must
        have been failed by the caller first."""
        self._generation += 1
        self._carry = init_slot_pool(
            self.config, self.slots, beam_size=self.beam_size, max_len=self.max_len,
            return_alphas=self._return_alphas, device=self.device,
        )
        self._free = set(range(self.slots))
        self._payload.clear()
        self._mask[:] = False
        self._tel.gauge(self._occ_gauge, 0)

    def clone_warmed(self, param_slot: str) -> "PagedSlotPool":
        """A second pool of this geometry over the same engine, with a
        fresh empty carry, running ``param_slot``: the lifecycle's canary
        pool and the resident models' pools.  The engine's lanes and the
        kernel are warm already, so a clone runs no warmup.  Must be
        called after ``warmup()``."""
        if self._carry is None:
            raise RuntimeError("clone_warmed before warmup()")
        clone = PagedSlotPool(
            self.engine, pages=self.pages, page_width=self.width, tel=self._tel, param_slot=param_slot
        )
        clone.warm_seconds = self.warm_seconds
        clone.reset()
        return clone

    def _decoder_params(self):
        return self.engine.slot_decoder_params(self.param_slot)

    # -- host bookkeeping --------------------------------------------------

    def occupancy(self) -> int:
        return self.slots - len(self._free)

    def free_count(self) -> int:
        return len(self._free)

    def inflight_payloads(self) -> List[Any]:
        """Every bound payload, in slot order."""
        return [self._payload[s] for s in sorted(self._payload)]

    def _on_device(self, array: np.ndarray) -> torch.Tensor:
        """A small host array on the device, copied without waiting for
        the device (from pinned memory when the device is a card)."""
        x = torch.from_numpy(array)
        if self.device.type == "cuda":
            x = x.pin_memory()
        return x.to(self.device, non_blocking=True)

    # -- device work -------------------------------------------------------

    @torch.inference_mode()
    def admit(self, items: List[Tuple[np.ndarray, Any]]) -> int:
        """Seed up to ``free_count()`` (image row, payload) pairs into free
        slots; returns how many it took (the rest stay with the caller).
        Items go in runs of one kind: a payload carrying a ``context``
        (a handoff grid) seeds from it, others are encoded.  Each chunk
        of at most ``page_width`` items fills the smallest lane width that
        holds it, then one gather seeds the lane."""
        admitted = 0
        free = sorted(self._free)
        cache = self.engine.encode_cache
        self.admitted = []

        def is_ctx(item) -> bool:
            return getattr(item[1], "context", None) is not None

        while admitted < len(items) and free:
            kind = is_ctx(items[admitted])
            run = 1
            while admitted + run < len(items) and is_ctx(items[admitted + run]) == kind:
                run += 1
            chunk = min(run, len(free), self.width)
            lane = next(w for w in self.lane_widths if w >= chunk)
            slot_src = np.zeros((self.slots,), np.int64)
            admit_mask = np.zeros((self.slots,), np.bool_)
            rows, payloads = [], []
            for j in range(chunk):
                image, payload = items[admitted]
                admitted += 1
                s = free.pop(0)
                rows.append(payload.context if kind else image)
                self.admitted.append(None if kind or cache is not None else (lane, j, s))
                slot_src[s] = j
                admit_mask[s] = True
                self._free.discard(s)
                self._payload[s] = payload
                self._mask[s] = True
                payloads.append(payload)
            if kind:
                contexts = self._ctx_lane(lane, rows)
            elif cache is not None:
                contexts = self._encode_lane_cached(lane, rows, payloads)
            else:
                contexts = self._encode_lane(self._stack(lane, rows), payloads)
            self._carry = init_slots(
                self._decoder_params(), self.config, self._carry, contexts,
                self._on_device(slot_src), self._on_device(admit_mask), beam_size=self.beam_size,
            )
        self._tel.gauge(self._occ_gauge, self.occupancy())
        return admitted

    @torch.inference_mode()
    def admit_at(self, image: np.ndarray, payload: Any, lane: int, row: int, slot: int) -> None:
        """Seed one image into ``slot`` from row ``row`` of an encode lane
        ``lane`` wide, zeros in the lane's other rows: a placement that
        ``admitted`` recorded, so an exemplar's replay encodes and seeds its
        image as the capture did (the bf16 encode depends on its width)."""
        if slot not in self._free or not 0 <= row < lane:
            raise ValueError(f"slot pool: cannot place row {row} of a {lane}-wide lane in slot {slot}")
        slot_src = np.zeros((self.slots,), np.int64)
        admit_mask = np.zeros((self.slots,), np.bool_)
        slot_src[slot], admit_mask[slot] = row, True
        images = self._stack(lane, [])
        images[row] = image
        contexts = self._encode_lane(images, [payload])
        self._free.discard(slot)
        self._payload[slot] = payload
        self._mask[slot] = True
        self._carry = init_slots(
            self._decoder_params(), self.config, self._carry, contexts,
            self._on_device(slot_src), self._on_device(admit_mask), beam_size=self.beam_size,
        )
        self._tel.gauge(self._occ_gauge, self.occupancy())

    def _stack(self, lane: int, rows: List[np.ndarray]) -> np.ndarray:
        size = self.config.image_size
        images = np.zeros((lane, size, size, 3), self.engine._image_dtype)
        for j, row in enumerate(rows):
            images[j] = row
        return images

    def _encode_lane(self, images: np.ndarray, payloads: List[Any]) -> torch.Tensor:
        """Encode one lane under this pool's params; with telemetry on,
        wait the encode out, record its window and charge each payload's
        ``cost`` an equal share (the seed consumes the contexts at once,
        so off it stays asynchronous).  Padded lane rows bill nobody but
        feed the lane-fill capacity gauge."""
        t0 = time.perf_counter_ns()
        contexts = self.engine.encode_images(images, self.param_slot)
        if self._tel.enabled:
            if contexts.is_cuda:
                torch.cuda.synchronize(contexts.device)
            dur = time.perf_counter_ns() - t0
            self._tel.record("serve/encode", t0, dur)
            self._tel.record(f"serve/encode_lane{images.shape[0]}", t0, dur)
            share = dur // len(payloads)
            for payload in payloads:
                cost = getattr(payload, "cost", None)
                if cost is not None:
                    cost.add_encode(share)
            self._tel.count("serve/encode_images", len(payloads))
            self._tel.count("serve/encode_lane_slots", images.shape[0])
        return contexts

    def _encode_lane_cached(self, lane: int, rows: List[np.ndarray], payloads: List[Any]) -> torch.Tensor:
        """Admission through the encode cache: plan ring rows for the
        chunk's content keys, encode only the unique misses (at the
        smallest lane that holds them), insert, then gather the whole lane
        from the ring.  A hit row is the exact bits its miss produced;
        only the miss requests split the encode window.  A payload
        without a key (bulk's row numbers) is keyed here by ``zlib.crc32``
        of its row, the digest the server stamps on requests."""
        engine = self.engine
        cache = engine.encode_cache
        gen = engine.param_fingerprint(self.param_slot)
        keys = []
        for row, payload in zip(rows, payloads):
            key = getattr(payload, "key", None)
            if key is None:
                key = zlib.crc32(np.ascontiguousarray(row).tobytes())
            keys.append((key, gen))
        plan = cache.plan(keys)
        try:
            if plan.n_miss:
                enc_lane = next(w for w in self.lane_widths if w >= plan.n_miss)
                images = self._stack(enc_lane, [rows[pos] for pos in plan.miss_pos])
                miss = self._encode_lane(images, [payloads[pos] for pos in plan.miss_pos])
                cache.insert(enc_lane, miss, plan.miss_rows)
            t0 = time.perf_counter_ns()
            contexts = cache.gather(lane, plan.rows)
            if self._tel.enabled:
                # the hit path's own latency probe, not a busy span
                if contexts.is_cuda:
                    torch.cuda.synchronize(contexts.device)
                self._tel.record("serve/cache_gather", t0, time.perf_counter_ns() - t0)
        except Exception:
            # the plan registered the miss keys; their rows hold garbage
            cache.drop(plan.miss_keys)
            raise
        return contexts

    def _ctx_lane(self, lane: int, grids: List[np.ndarray]) -> torch.Tensor:
        """Decode-tier admission: pre-encoded handoff grids (checked at
        ingress) stacked into the lane's context shape; no encode, no
        cache, no encode time charged."""
        engine = self.engine
        batch = np.zeros((lane,) + tuple(engine.ctx_row_shape), engine.ctx_row_dtype)
        for j, grid in enumerate(grids):
            batch[j] = grid
        self._tel.count("serve/context_images", len(grids))
        return torch.from_numpy(batch).to(self.device, non_blocking=True)

    def step(self) -> torch.Tensor:
        """One decode step over the pool: the window at depth 1.  Returns
        the [S] done flags still on the device."""
        return self.multi_step(1)[0]

    @torch.inference_mode()
    def multi_step(self, k: int):
        """Up to ``k`` decode steps, enqueued with no host sync.  Returns
        ``(done, steps_run)`` still on the device: ``done`` [S] flags every
        slot that finished in the window, ``steps_run`` the iterations run
        while a slot was active.  ``k`` must be on the ladder
        (``decode_depths``)."""
        if k not in self.decode_depths:
            raise KeyError(f"decode depth {k} not in ladder {list(self.decode_depths)}")
        generation = self._generation
        carry, done, steps_run = decode_multi_step(
            self._decoder_params(), self.config, self._carry,
            self._on_device(self._mask.copy()), self.eos_id, k=k,
            beam_size=self.beam_size, valid_size=self.valid_size,
        )
        if generation == self._generation:  # else a reset() came in between
            self._carry = carry
        return done, steps_run

    @torch.inference_mode()
    def harvest(self, done: np.ndarray):
        """Drain and free the slots flagged in ``done`` (host bool [S]).

        Returns ``(payloads, words, lengths, scores, steps, alphas)``, one
        row per harvested slot in slot order (``alphas`` None unless
        ``serve_quality`` is on): whole arrays come to the host and are
        sliced there."""
        ids = [int(s) for s in np.nonzero(done)[0] if self._mask[s]]
        out = harvest_slots(self._carry, self._return_alphas)
        words, lengths, scores, steps = (
            x.cpu().numpy() for x in (out.words, out.lengths, out.log_scores, out.steps_run)
        )
        alphas = None if out.alphas is None else out.alphas.cpu().numpy()
        retire = np.zeros((self.slots,), np.bool_)
        payloads = []
        for s in ids:
            retire[s] = True
            payloads.append(self._payload.pop(s))
            self._mask[s] = False
            self._free.add(s)
        self._carry = retire_slots(self._carry, self._on_device(retire))
        self._tel.gauge(self._occ_gauge, self.occupancy())
        return (
            payloads, words[ids], lengths[ids], scores[ids], steps[ids],
            None if alphas is None else alphas[ids],
        )
