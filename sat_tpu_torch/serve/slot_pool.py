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
ready.  The encode cache, the tier handoff and cloned canary/resident
pools are later slices of the port; their knobs raise in
``engine.check_ported``.

The pool owns device state and host bookkeeping (free slots, slot →
payload binding) only; when to admit and step is the
``ContinuousBatcher``'s.  Not thread-safe: one owner thread drives it.
"""

from __future__ import annotations

import sys
import time
from typing import Any, List, Tuple

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

    def __init__(self, engine, pages=None, page_width=None) -> None:
        config = engine.config
        self.engine = engine
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
        self.warm_seconds = 0.0

    # -- startup -----------------------------------------------------------

    @torch.inference_mode()
    def warmup(self) -> None:
        """Run every lane width, a seed, a window and a harvest once on
        zeros (no slot admitted, none active), then start empty."""
        size = self.config.image_size
        t0 = time.perf_counter()
        self.reset()
        nobody = self._on_device(np.zeros((self.slots,), np.bool_))
        for lane in self.lane_widths:
            contexts = self.engine.encode_images(
                np.zeros((lane, size, size, 3), self.engine._image_dtype)
            )
            self._carry = init_slots(
                self.engine.decoder_params, self.config, self._carry, contexts,
                self._on_device(np.zeros((self.slots,), np.int64)), nobody,
                beam_size=self.beam_size,
            )
        self._carry, _, _ = decode_multi_step(
            self.engine.decoder_params, self.config, self._carry, nobody, self.eos_id,
            k=1, beam_size=self.beam_size, valid_size=self.valid_size,
        )
        harvest_slots(self._carry).words.cpu()  # the drain proves the device answers
        self.reset()
        self.warm_seconds = time.perf_counter() - t0
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
        self._carry = init_slot_pool(
            self.config, self.slots, beam_size=self.beam_size, max_len=self.max_len,
            device=self.device,
        )
        self._free = set(range(self.slots))
        self._payload.clear()
        self._mask[:] = False

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
        Each chunk of at most ``page_width`` images is encoded at the
        smallest lane width that holds it, then seeded by one gather."""
        size = self.config.image_size
        admitted = 0
        free = sorted(self._free)
        while admitted < len(items) and free:
            chunk = min(len(items) - admitted, len(free), self.width)
            lane = next(w for w in self.lane_widths if w >= chunk)
            images = np.zeros((lane, size, size, 3), self.engine._image_dtype)
            slot_src = np.zeros((self.slots,), np.int64)
            admit_mask = np.zeros((self.slots,), np.bool_)
            for j in range(chunk):
                image, payload = items[admitted]
                admitted += 1
                s = free.pop(0)
                images[j] = image
                slot_src[s] = j
                admit_mask[s] = True
                self._free.discard(s)
                self._payload[s] = payload
                self._mask[s] = True
            self._carry = init_slots(
                self.engine.decoder_params, self.config, self._carry,
                self.engine.encode_images(images), self._on_device(slot_src),
                self._on_device(admit_mask), beam_size=self.beam_size,
            )
        return admitted

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
        self._carry, done, steps_run = decode_multi_step(
            self.engine.decoder_params, self.config, self._carry,
            self._on_device(self._mask.copy()), self.eos_id, k=k,
            beam_size=self.beam_size, valid_size=self.valid_size,
        )
        return done, steps_run

    @torch.inference_mode()
    def harvest(self, done: np.ndarray):
        """Drain and free the slots flagged in ``done`` (host bool [S]).

        Returns ``(payloads, words, lengths, scores, steps)``, one row per
        harvested slot in slot order: whole arrays come to the host and
        are sliced there."""
        ids = [int(s) for s in np.nonzero(done)[0] if self._mask[s]]
        out = harvest_slots(self._carry)
        words, lengths, scores, steps = (
            x.cpu().numpy() for x in (out.words, out.lengths, out.log_scores, out.steps_run)
        )
        retire = np.zeros((self.slots,), np.bool_)
        payloads = []
        for s in ids:
            retire[s] = True
            payloads.append(self._payload.pop(s))
            self._mask[s] = False
            self._free.add(s)
        self._carry = retire_slots(self._carry, self._on_device(retire))
        return payloads, words[ids], lengths[ids], scores[ids], steps[ids]
