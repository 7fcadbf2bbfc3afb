"""Host-side image decoding for the serve path — the port's copy of the
decode half of ``sat_tpu.data.images``.

decode → BGR→RGB → ``cv2.resize`` → uint8, exactly as the JAX package's
``ImageLoader.decode_raw``, so the same JPEG yields the same model input
row in both packages.  The float32 mean subtraction runs on the device
(``models.captioner.encode``) when ``device_preprocess`` is on, as in the
JAX package.  ``cv2`` is imported only when an image is decoded.
"""

from __future__ import annotations

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
        image = image[:, :, ::-1]  # BGR → RGB
        image = cv2.resize(image, (self.size, self.size))
        return np.ascontiguousarray(image)

    def load_bytes(self, data: bytes) -> np.ndarray:
        image = self.decode_raw(data)
        if self.raw:
            return image
        return image.astype(np.float32) - ILSVRC_2012_MEAN
