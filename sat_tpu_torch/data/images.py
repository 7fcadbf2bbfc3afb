"""Host-side image decoding and the prefetching batch assembler — the
port's copy of ``sat_tpu.data.images``.

decode → BGR→RGB → ``cv2.resize`` → uint8, exactly as the JAX package's
``ImageLoader``, so the same JPEG yields the same model input row in both
packages.  The float32 mean subtraction runs on the device
(``models.captioner.encode``) when ``device_preprocess`` is on, as in the
JAX package.  ``cv2`` is imported only when an image is decoded.

``PrefetchLoader`` assembles each batch — a gather from the shard cache
(``data.shards``) when one is given, else a live decode in a thread pool
— and keeps up to ``prefetch_depth`` ready batches ahead of the
consumer.  With a run-level ``QuarantineManager`` (``runtime.make_loader``
wires one in) a bad record is ledgered and replaced by a deterministically
chosen healthy row of the same batch; without one, a JPEG that cannot be
decoded raises :class:`PrefetchDecodeError`.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence

import numpy as np

from .. import telemetry
from ..resilience.faultinject import consume_caption_fault, consume_decode_fault
from ..resilience.quarantine import QuarantineManager, SystemicCorruption

# Spatial mean of the Caffe ILSVRC-2012 mean image, in the (B,G,R) order
# of the npy it came from.  The reference subtracts it as-is from the RGB
# image, and so do both packages: pretrained weights were trained so.
ILSVRC_2012_MEAN = np.array([104.00698793, 116.66876762, 122.67891434], np.float32)

# Suffixes cv2.imread is expected to decode; everything else in a walked
# directory (READMEs, sidecar JSONs) is skipped, not an error.
IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def walk_images(root: str) -> List[str]:
    """Every image file under ``root`` (by suffix, case-insensitive), in
    sorted absolute-path order, so the corpus order — and the bulk
    manifest's fingerprint — does not depend on ``os.walk``'s visit order.
    Non-image files are skipped and counted on the
    ``data/skipped_nonimage`` telemetry counter."""
    files: List[str] = []
    skipped = 0
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for name in filenames:
            if name.lower().endswith(IMAGE_SUFFIXES):
                files.append(os.path.abspath(os.path.join(dirpath, name)))
            else:
                skipped += 1
    if skipped:
        telemetry.get().count("data/skipped_nonimage", skipped)
    return sorted(files)


class ImageLoader:
    """raw=True stops at the uint8 RGB row (the device subtracts the
    mean); raw=False returns the float32 mean-subtracted row."""

    def __init__(self, size: int = 224, raw: bool = True):
        self.size = size
        self.raw = raw

    def _finish_decode(self, image: np.ndarray) -> np.ndarray:
        """Shared post-codec tail: BGR → RGB, resize, contiguous uint8."""
        import cv2

        image = image[:, :, ::-1]  # BGR → RGB
        image = cv2.resize(image, (self.size, self.size))
        return np.ascontiguousarray(image)

    def _finish(self, image: np.ndarray) -> np.ndarray:
        """This loader's preprocessing mode over a decoded uint8 row."""
        if self.raw:
            return image
        return image.astype(np.float32) - ILSVRC_2012_MEAN

    def decode_raw(self, data: bytes) -> np.ndarray:
        """Encoded image bytes (JPEG/PNG/...) → [size, size, 3] uint8 RGB.
        Raises ValueError on bytes cv2 cannot decode."""
        import cv2

        try:
            image = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        except cv2.error as e:
            raise ValueError(f"cannot decode image bytes: {e}") from None
        if image is None:
            raise ValueError("cannot decode image bytes (not a JPEG/PNG?)")
        return self._finish_decode(image)

    def load_raw(self, image_file: str) -> np.ndarray:
        """Read and decode a file → [size, size, 3] uint8 RGB: the row the
        shard cache stores.  Raises FileNotFoundError when cv2 cannot read
        or decode it."""
        import cv2

        consume_decode_fault(image_file)  # SAT_FI_BAD_IMAGE_EVERY
        image = cv2.imread(image_file)
        if image is None:
            raise FileNotFoundError(f"cannot decode image: {image_file}")
        return self._finish_decode(image)

    def load_bytes(self, data: bytes) -> np.ndarray:
        return self._finish(self.decode_raw(data))

    def load_image(self, image_file: str) -> np.ndarray:
        return self._finish(self.load_raw(image_file))

    def load_images(self, image_files: Sequence[str]) -> np.ndarray:
        return np.stack([self.load_image(f) for f in image_files])


class PrefetchDecodeError(RuntimeError):
    """A prefetch worker failed to decode an image: names the file and
    its batch coordinates (the codec's error rides ``__cause__``)."""

    def __init__(
        self, image_file: str, batch_index: int, row: int,
        cause: Optional[BaseException] = None,
    ):
        detail = f": {cause}" if cause is not None else ""
        super().__init__(
            f"cannot decode {image_file!r} (batch {batch_index}, row {row}){detail}"
        )
        self.image_file = image_file
        self.batch_index = batch_index
        self.row = row


class PrefetchLoader:
    """Iterates ``dataset``'s batches of file names and yields dicts with
    'images' [B, S, S, 3] (uint8 RGB when the loader is raw, else float32
    mean-subtracted) and 'files' (and a training batch's 'word_idxs' and
    'masks', passed through).  A producer thread assembles each batch and
    keeps up to ``prefetch_depth`` ready batches in a bounded queue; an
    error is raised on the consumer's side.

    Two assembly paths, bitwise the same rows:

    * **live decode** (default): ``num_workers`` threads run the JPEG
      decode;
    * **shard gather** (``shard_cache`` given, see ``data.shards``): one
      fancy-index read per shard out of mmap'd uint8 rows; files absent
      from the cache fall back to live decode per image.

    ``quarantine`` (a ``QuarantineManager``) turns a bad record into a
    ledger line and a substituted row instead of an error: an image that
    does not decode (or whose shard row fails its crc and whose live
    decode fails too), a caption with no in-vocabulary word
    (``caption_all_oov``) or one that fills the whole caption length
    (``caption_overlength``), and every file or batch position the ledger
    already names.  Image entries are keyed by file, caption entries by
    (pass, batch, row): ``pass`` counts this loader's iterations.

    A mesh rank's dataset view (``parallel.data``) yields each global
    batch and names the ``block`` of rows the rank keeps: the whole batch
    is assembled and its bad rows substituted as one process would, then
    the block is kept.  The rank appends to the ledger only the bad rows
    of its own block (each row once across the ranks); the others are
    counted all the same, so every rank's ceiling sees the run's rows."""

    def __init__(
        self,
        dataset,
        image_loader: Optional[ImageLoader] = None,
        num_workers: int = 8,
        prefetch_depth: int = 2,
        shard_cache=None,
        quarantine: Optional[QuarantineManager] = None,
    ):
        self.dataset = dataset
        self.loader = image_loader or ImageLoader()
        self.num_workers = num_workers
        self.prefetch_depth = max(1, prefetch_depth)
        self.shard_cache = shard_cache
        self.quarantine = quarantine
        self._pass = 0
        if shard_cache is not None and shard_cache.image_size != self.loader.size:
            raise ValueError(
                f"shard cache rows are {shard_cache.image_size}px but the loader "
                f"resizes to {self.loader.size}px — the cache was opened for a "
                "different preprocessing"
            )

    def _decode_batch(self, batch, pool: ThreadPoolExecutor, pass_idx: int, batch_idx: int) -> dict:
        with telemetry.span("data/decode_batch"):
            return self._assemble(batch, pool, pass_idx, batch_idx)

    def _assemble(self, batch, pool: ThreadPoolExecutor, pass_idx: int, batch_idx: int) -> dict:
        out = {}
        if isinstance(batch, tuple):  # training: (files, word_idxs, masks)
            batch, word_idxs, masks = batch
            out = {"word_idxs": np.asarray(word_idxs, np.int32), "masks": np.asarray(masks, np.float32)}
        files = [str(f) for f in batch]
        q = self.quarantine
        # (row, file, reason, exc, kind): every row that must not be used
        # as-is, from the ledger replay, the gather, the live decode and
        # the caption scan below
        bad: List[tuple] = []
        flagged: set = set()
        if q is not None:
            q.note_rows(len(files))
            # files the ledger names are substituted without a decode: a
            # file repaired since the ledger was written must not change a
            # replay
            for i, f in enumerate(files):
                if q.known_bad_file(f):
                    bad.append((i, f, "replayed_ledger", None, "image"))
                    flagged.add(i)
        if self.shard_cache is not None:
            gather_bad = None if q is None else []
            raw = self.shard_cache.gather(files, fallback=self.loader.load_raw, bad_rows=gather_bad)
            for i, f, reason, exc in gather_bad or ():
                if i not in flagged:
                    bad.append((i, f, reason, exc, "image"))
                    flagged.add(i)
            # elementwise the same op the live path applies per image
            out["images"] = raw if self.loader.raw else raw.astype(np.float32) - ILSVRC_2012_MEAN
        else:
            S = self.loader.size
            images = np.zeros((len(files), S, S, 3), np.uint8 if self.loader.raw else np.float32)

            def load_one(i):
                if i in flagged:
                    return i, None, None
                try:
                    return i, self.loader.load_image(files[i]), None
                except Exception as e:  # quarantined, or re-raised with the file named
                    return i, None, e

            for i, img, exc in pool.map(load_one, range(len(files))):
                if img is not None:
                    images[i] = img
                elif exc is not None:
                    if q is None:
                        raise PrefetchDecodeError(files[i], batch_idx, i, exc) from exc
                    bad.append((i, files[i], "decode_failed", exc, "image"))
                    flagged.add(i)
            out["images"] = images
        out["files"] = files
        if "word_idxs" in out:
            for i in range(len(files)):
                if consume_caption_fault():  # SAT_FI_BAD_CAPTION_AT
                    out["word_idxs"][i] = 0
                    out["masks"][i] = 0.0
            if q is not None:
                masks = out["masks"]
                cap = masks.shape[1] if masks.ndim == 2 else 0
                for i in range(len(files)):
                    if i in flagged:
                        continue
                    n_tok = float(masks[i].sum())
                    if q.known_bad_pos(pass_idx, batch_idx, i):
                        reason = "replayed_ledger"
                    elif n_tok == 0:
                        reason = "caption_all_oov"
                    elif cap and n_tok >= cap:
                        reason = "caption_overlength"
                    else:
                        continue
                    bad.append((i, files[i], reason, None, "caption"))
                    flagged.add(i)
        block = getattr(self.dataset, "block", None)
        if bad:
            self._quarantine_and_substitute(out, bad, len(files), pass_idx, batch_idx, block)
        if block is not None:
            out = {k: v[block[0]:block[1]] for k, v in out.items()}
        return out

    def _quarantine_and_substitute(self, out, bad, n_rows, pass_idx, batch_idx, block=None) -> None:
        """Ledger every newly bad row (only ``block``'s rows, when given),
        then overwrite each bad row wholesale with a deterministically
        chosen healthy row of the same batch: the geometry never changes,
        and a replay with the same ledger substitutes identically."""
        q = self.quarantine
        bad_set = {b[0] for b in bad}
        healthy = [i for i in range(n_rows) if i not in bad_set]
        for i, f, reason, exc, kind in sorted(bad, key=lambda b: b[0]):
            pos = (pass_idx, batch_idx, i) if kind == "caption" else None
            if reason != "replayed_ledger":
                own = block is None or block[0] <= i < block[1]
                q.quarantine(f, reason, kind=kind, pos=pos, exc=exc, record=own)  # may raise SystemicCorruption
            if not healthy:
                raise SystemicCorruption(
                    f"every row of batch {batch_idx} is quarantined (last: {f!r}, "
                    f"{reason}) — no healthy row to substitute; the input data is "
                    "systemically corrupt"
                )
            key = f"image:{f}" if kind == "image" else f"caption:{pass_idx}:{batch_idx}:{i}"
            j = healthy[QuarantineManager.substitute_index(key, len(healthy))]
            for k in ("images", "word_idxs", "masks"):
                if k in out:
                    out[k][i] = out[k][j]
            out["files"][i] = out["files"][j]

    def __iter__(self) -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        sentinel = object()
        stop = threading.Event()
        error: List[BaseException] = []
        pass_idx = self._pass
        self._pass += 1

        def put(item) -> bool:
            """Bounded put that gives up once the consumer went away, so an
            abandoned iterator cannot pin the thread."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for batch_idx, batch in enumerate(self.dataset):
                        if not put(self._decode_batch(batch, pool, pass_idx, batch_idx)):
                            return
            except BaseException as e:  # re-raised on the consumer side
                error.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                # depth after the take: 0 = the consumer outran the producer
                telemetry.get().gauge("data/prefetch_qsize", q.qsize())
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()
            t.join(timeout=10)
