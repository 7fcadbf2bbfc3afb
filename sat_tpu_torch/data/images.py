"""Host-side image decoding and the prefetching batch assembler — the
port's copy of ``sat_tpu.data.images`` (live decode only).

decode → BGR→RGB → ``cv2.resize`` → uint8, exactly as the JAX package's
``ImageLoader``, so the same JPEG yields the same model input row in both
packages.  The float32 mean subtraction runs on the device
(``models.captioner.encode``) when ``device_preprocess`` is on, as in the
JAX package.  ``cv2`` is imported only when an image is decoded.

``PrefetchLoader`` decodes each batch in a thread pool and keeps up to
``prefetch_depth`` ready batches ahead of the consumer.  The JAX
package's shard-cache gather and its quarantine (substitute a bad JPEG
and log it) are not ported: a JPEG that cannot be decoded raises
:class:`PrefetchDecodeError`.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence

import numpy as np

# Spatial mean of the Caffe ILSVRC-2012 mean image, in the (B,G,R) order
# of the npy it came from.  The reference subtracts it as-is from the RGB
# image, and so do both packages: pretrained weights were trained so.
ILSVRC_2012_MEAN = np.array([104.00698793, 116.66876762, 122.67891434], np.float32)


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
        """Read and decode a file → [size, size, 3] uint8 RGB.  Raises
        FileNotFoundError when cv2 cannot read or decode it."""
        import cv2

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
    'masks', passed through).  A producer thread decodes each batch
    in a pool of ``num_workers`` threads and keeps up to
    ``prefetch_depth`` ready batches in a bounded queue; a decode error
    is raised on the consumer's side."""

    def __init__(
        self,
        dataset,
        image_loader: Optional[ImageLoader] = None,
        num_workers: int = 8,
        prefetch_depth: int = 2,
    ):
        self.dataset = dataset
        self.loader = image_loader or ImageLoader()
        self.num_workers = num_workers
        self.prefetch_depth = max(1, prefetch_depth)

    def _decode_batch(self, batch, pool: ThreadPoolExecutor, batch_idx: int) -> dict:
        out = {}
        if isinstance(batch, tuple):  # training: (files, word_idxs, masks)
            batch, word_idxs, masks = batch
            out = {"word_idxs": np.asarray(word_idxs, np.int32), "masks": np.asarray(masks, np.float32)}
        files = [str(f) for f in batch]
        S = self.loader.size
        images = np.zeros((len(files), S, S, 3), np.uint8 if self.loader.raw else np.float32)

        def load_one(i):
            try:
                return i, self.loader.load_image(files[i]), None
            except Exception as e:  # re-raised below with the file named
                return i, None, e

        for i, img, exc in pool.map(load_one, range(len(files))):
            if exc is not None:
                raise PrefetchDecodeError(files[i], batch_idx, i, exc) from exc
            images[i] = img
        return {"images": images, "files": files, **out}

    def __iter__(self) -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        sentinel = object()
        stop = threading.Event()
        error: List[BaseException] = []

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
                        if not put(self._decode_batch(batch, pool, batch_idx)):
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
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()
            t.join(timeout=10)
