"""Feature-grid handoff format for encode/decode tier disaggregation.

The port's copy of ``sat_tpu.serve.handoff``.

An encode-tier replica answers ``POST /encode`` with one preprocessed
image's encoder context grid; a decode-tier replica accepts that grid on
``POST /caption`` (content type below) and seeds a decode slot from it,
skipping its own encode lane.  The wire format keeps the router jax-free
and the decode side paranoid:

    {"magic": "sat-grid1", "dtype": "float32", "shape": [196, 512],
     "crc32c": <int>, "step": <int>}\\n<raw row-major grid bytes>

* the JSON header line pins dtype + shape so the decode replica can
  validate the aval against its own warmed executables BEFORE touching
  device memory (shape drift = different params geometry = reject);
* ``crc32c`` covers the payload bytes with the same Castagnoli digest
  the integrity plane uses — a flipped bit in transit is a 400, not a
  silently wrong caption;
* ``step`` carries the encoder's model step so a decode replica serving
  a different promote generation can refuse a stale grid.

Deliberately jax-free (numpy only): the router forwards these blobs and
the chaos/bench harnesses craft corrupt ones without importing jax.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from ..utils.summary import crc32c

# content type for a grid-carrying request/response body
GRID_CONTENT_TYPE = "application/x-sat-grid"

_MAGIC = "sat-grid1"
# grids are small (a few hundred KB); a multi-MB header line means a
# corrupt or hostile frame, not a bigger model
_MAX_HEADER_BYTES = 4096


class HandoffError(ValueError):
    """Malformed/corrupt grid frame — maps to HTTP 400 at the server."""


def encode_grid(grid: np.ndarray, step: Optional[int] = None) -> bytes:
    """Serialize one context grid ``[N, D]`` (any rank works) into a
    self-describing frame: header line + raw bytes."""
    arr = np.ascontiguousarray(grid)
    payload = arr.tobytes()
    header = {
        "magic": _MAGIC,
        "dtype": arr.dtype.name,
        "shape": list(arr.shape),
        "crc32c": crc32c(payload),
    }
    if step is not None:
        header["step"] = int(step)
    return json.dumps(header, sort_keys=True).encode("utf-8") + b"\n" + payload


def decode_grid(data: bytes) -> Tuple[np.ndarray, Dict[str, Any]]:
    """Parse and verify a grid frame; returns ``(grid, header)``.

    Raises :class:`HandoffError` on any malformation: missing/oversized
    header, wrong magic, bad dtype, byte-count/shape mismatch, or crc32c
    mismatch.  The returned array is read-only (it aliases ``data``)."""
    nl = data.find(b"\n", 0, _MAX_HEADER_BYTES)
    if nl < 0:
        raise HandoffError("grid frame: no header line within bound")
    try:
        header = json.loads(data[:nl].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise HandoffError(f"grid frame: unparseable header ({exc})") from exc
    if not isinstance(header, dict) or header.get("magic") != _MAGIC:
        raise HandoffError("grid frame: bad magic")
    try:
        dtype = np.dtype(str(header["dtype"]))
        shape = tuple(int(d) for d in header["shape"])
        want_crc = int(header["crc32c"])
    except (KeyError, TypeError, ValueError) as exc:
        raise HandoffError(f"grid frame: bad header field ({exc})") from exc
    if any(d <= 0 for d in shape):
        raise HandoffError(f"grid frame: non-positive dim in shape {shape}")
    payload = data[nl + 1:]
    want_bytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if len(payload) != want_bytes:
        raise HandoffError(
            f"grid frame: payload is {len(payload)} bytes, "
            f"shape {shape}/{dtype.name} needs {want_bytes}"
        )
    got_crc = crc32c(payload)
    if got_crc != want_crc:
        raise HandoffError(
            f"grid frame: crc32c mismatch (header {want_crc:#010x}, "
            f"payload {got_crc:#010x})"
        )
    return np.frombuffer(payload, dtype=dtype).reshape(shape), header


def check_aval(
    grid: np.ndarray, shape: Sequence[int], dtype
) -> None:
    """Reject a grid whose aval doesn't match the decode side's warmed
    context row (``HandoffError`` → HTTP 400): seeding a slot from a
    mis-shaped grid would either recompile or silently misdecode."""
    want = tuple(int(d) for d in shape)
    if tuple(grid.shape) != want or grid.dtype != np.dtype(dtype):
        raise HandoffError(
            f"grid aval mismatch: got {tuple(grid.shape)}/{grid.dtype.name}, "
            f"this replica decodes {want}/{np.dtype(dtype).name}"
        )
