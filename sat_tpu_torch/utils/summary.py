"""Training observability: TensorBoard-compatible event files + JSONL — the
port's copy of ``sat_tpu.utils.summary``, with ``variable_stats`` reduced
on the tensors' device by torch.

The reference writes TF summaries every step — scalar losses/accuracy,
per-trainable-variable mean/std/min/max/histogram, and attention-map stats
(the reference's model.py:515-543, written at base_model.py:46-47,63).

This module reproduces that capability with zero TensorFlow: a
``SummaryWriter`` that emits the TFRecord/Event wire format directly
(varint-encoded protobuf + masked CRC32C framing), so standard TensorBoard
reads our logs, and mirrors every scalar into a ``metrics.jsonl`` for
dependency-free analysis.  Per-variable summaries carry both the
mean/std/min/max scalar family and a true HistogramProto (TensorBoard's
histogram tab), bucketed with TF's exponential bucket scheme.
"""

from __future__ import annotations

import json
import os
import struct
import sys
import time
from typing import Any, Dict, Mapping, Optional

import numpy as np

from ..telemetry import run_id

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) — TFRecord framing requires it; stdlib zlib.crc32 is
# the wrong polynomial.  Table-driven, reflected, poly 0x82F63B78.
#
# Two implementations, bitwise-identical: the per-byte scalar loop (the
# oracle, and the fast path for short frames — every Event's 8-byte length
# header goes through here) and a numpy lane-parallel path for large
# payloads (per-variable HistogramProto frames reach hundreds of KB;
# the Python loop costs ~300 ms/MB, the vector path ~3 ms/MB).
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)

_CRC_TABLE_NP = np.array(_CRC_TABLE, dtype=np.uint32)

# CRC state transition is GF(2)-affine in the state: processing k zero
# bytes maps state s -> M_k @ s for a 32×32 bit-matrix M_k.  A matrix is
# stored as 32 uint32 columns (column b = image of basis bit 1<<b); the
# one-zero-byte matrix follows directly from the table recurrence
# s' = T[s & 0xFF] ^ (s >> 8) applied to each basis vector.
_ADV1 = np.array(
    [_CRC_TABLE[(1 << b) & 0xFF] ^ ((1 << b) >> 8) for b in range(32)],
    dtype=np.uint32,
)


def _gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Compose two 32-column GF(2) matrices: out = a @ b (b applied first)."""
    out = np.zeros(32, np.uint32)
    for col in range(32):
        v = int(b[col])
        acc = 0
        while v:
            low = v & -v
            acc ^= int(a[low.bit_length() - 1])
            v ^= low
        out[col] = acc
    return out


def _matvec_vec(m: np.ndarray, states: np.ndarray) -> np.ndarray:
    """Apply one GF(2) matrix to many uint32 states at once (32 numpy ops)."""
    out = np.zeros_like(states)
    for b in range(32):
        out ^= np.where((states >> np.uint32(b)) & np.uint32(1), m[b], np.uint32(0))
    return out


def _crc32c_scalar(data: bytes, crc: int = 0xFFFFFFFF) -> int:
    """The reference per-byte loop (no final xor; callers apply it)."""
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc


_CRC_VECTOR_MIN = 4096    # below this the scalar loop wins (setup cost)


def crc32c(data: bytes) -> int:
    if len(data) < _CRC_VECTOR_MIN:
        return _crc32c_scalar(data) ^ 0xFFFFFFFF

    # Split into K equal byte-columns processed as K independent CRC
    # lanes in lockstep (the classic interleaved/chunked scheme): lane 0
    # starts from the real init state, others from 0, so by table
    # linearity (T[a^b] = T[a]^T[b]) the concatenation identity
    #   crc(A||B) = advance(crc(A), len(B)) ^ crc_zero_init(B)
    # lets a log2(K) tree of zero-advance matrices stitch the lanes back
    # into the exact serial result.  K scales with the payload (bounded
    # Python-level row loop, ~256 iterations) — the stitch is only
    # log2(K) rounds, so wide is cheap.
    K = 1 << max(8, min(16, (len(data) // 256).bit_length() - 1))
    rows = len(data) // K
    chunk = rows * K
    cols = np.frombuffer(data[:chunk], np.uint8).reshape(K, rows)
    states = np.zeros(K, np.uint32)
    states[0] = 0xFFFFFFFF
    for j in range(rows):
        states = _CRC_TABLE_NP[(states ^ cols[:, j]) & np.uint32(0xFF)] ^ (
            states >> np.uint32(8)
        )
    # stitch: at each level pair adjacent lanes, advancing the left lane
    # over the right lane's span (doubling each round)
    adv = _ADV1
    span = rows
    # advance-by-`rows` matrix = _ADV1 composed rows times (square-and-
    # multiply over the bits of `rows`)
    adv_span = None
    bit_m = _ADV1
    r = rows
    while r:
        if r & 1:
            adv_span = bit_m if adv_span is None else _gf2_matmul(bit_m, adv_span)
        r >>= 1
        if r:
            bit_m = _gf2_matmul(bit_m, bit_m)
    while states.size > 1:
        left, right = states[0::2], states[1::2]
        states = _matvec_vec(adv_span, left) ^ right
        if states.size > 1:
            adv_span = _gf2_matmul(adv_span, adv_span)
        span *= 2
    crc = int(states[0])
    # serial tail for the remainder bytes
    return _crc32c_scalar(data[chunk:], crc) ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire encoding for tensorboard Event/Summary messages.
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_len(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _encode_value(tag: str, value: float) -> bytes:
    # Summary.Value { string tag = 1; float simple_value = 2; }
    return _field_len(1, tag.encode("utf-8")) + b"\x15" + struct.pack(
        "<f", float(value)
    )


def _encode_event(
    wall_time: float,
    step: int,
    scalars: Optional[Mapping[str, float]] = None,
    file_version: Optional[str] = None,
    summary_bytes: Optional[bytes] = None,
) -> bytes:
    # Event { double wall_time = 1; int64 step = 2;
    #         string file_version = 3; Summary summary = 5; }
    out = b"\x09" + struct.pack("<d", wall_time) + b"\x10" + _varint(int(step))
    if file_version is not None:
        out += _field_len(3, file_version.encode("utf-8"))
    summary = summary_bytes or b""
    if scalars:
        summary += b"".join(
            _field_len(1, _encode_value(tag, v)) for tag, v in scalars.items()
        )
    if summary:
        out += _field_len(5, summary)
    return out


# ---------------------------------------------------------------------------
# HistogramProto — TensorBoard's histogram tab (the reference logs one per
# trainable variable, the reference's model.py:527).  Buckets follow TF's
# exponential scheme: ±1e-12·1.1^k up to ±1e20, plus 0 and ±float-max, so
# standard TensorBoard renders our histograms identically.
# ---------------------------------------------------------------------------


def _make_bucket_limits():
    pos = []
    v = 1e-12
    while v < 1e20:
        pos.append(v)
        v *= 1.1
    fmax = float(np.finfo(np.float64).max)
    return [-fmax] + [-x for x in reversed(pos)] + [0.0] + pos + [fmax]


BUCKET_LIMITS = np.asarray(_make_bucket_limits())


def _packed_doubles(field: int, values) -> bytes:
    payload = struct.pack(f"<{len(values)}d", *[float(v) for v in values])
    return _field_len(field, payload)


def _encode_histo(
    lo: float, hi: float, num: float, total: float, sumsq: float, counts
) -> bytes:
    """HistogramProto{min=1,max=2,num=3,sum=4,sum_squares=5,
    bucket_limit=6,bucket=7} with zero-run trimming (empty leading/trailing
    buckets dropped, like TF's proto compression)."""
    counts = np.asarray(counts)
    nz = np.flatnonzero(counts)
    if len(nz):
        s, e = int(nz[0]), int(nz[-1]) + 1
    else:
        s, e = 0, 1
    out = (
        b"\x09" + struct.pack("<d", float(lo))
        + b"\x11" + struct.pack("<d", float(hi))
        + b"\x19" + struct.pack("<d", float(num))
        + b"\x21" + struct.pack("<d", float(total))
        + b"\x29" + struct.pack("<d", float(sumsq))
    )
    out += _packed_doubles(6, BUCKET_LIMITS[s:e])
    out += _packed_doubles(7, counts[s:e])
    return out


def _histo_from_array(values) -> bytes:
    x = np.asarray(values, dtype=np.float64).ravel()
    # ±inf land in the outermost buckets; NaNs are dropped entirely (from
    # num/sum/min/max too) so the proto stays internally consistent even
    # for a diverged run — the case this summary exists to debug.
    x = x[~np.isnan(x)]
    x = np.clip(x, BUCKET_LIMITS[0], BUCKET_LIMITS[-1])
    counts = np.bincount(
        np.searchsorted(BUCKET_LIMITS, x, side="left"),
        minlength=len(BUCKET_LIMITS),
    )
    return _encode_histo(
        x.min() if x.size else 0.0,
        x.max() if x.size else 0.0,
        x.size,
        x.sum(),
        (x * x).sum(),
        counts,
    )


def _encode_histo_value(tag: str, histo: bytes) -> bytes:
    # Summary.Value { string tag = 1; HistogramProto histo = 5; }
    return _field_len(1, tag.encode("utf-8")) + _field_len(5, histo)


def _frame_record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


def _reduce_stats(x):
    """(mean, std, min, max, histo min, histo max, sum, sum of squares,
    count, bucket counts) of one tensor, reduced and bucketed on its
    device so only scalars and ~1.5k counts cross to the host.  Like
    :func:`_histo_from_array`, ±inf land in the outermost buckets and NaNs
    drop from the histogram and its moments."""
    import torch

    f32max = float(np.finfo(np.float32).max)
    limits = torch.as_tensor(
        np.clip(BUCKET_LIMITS, -f32max, f32max), dtype=torch.float32, device=x.device
    )
    x = x.detach().float()
    flat = x.reshape(-1)
    finite = ~torch.isnan(flat)
    clipped = torch.clamp(flat, limits[0], limits[-1])
    idx = torch.clamp(torch.searchsorted(limits, clipped, side="left"), max=len(limits) - 1)
    counts = torch.zeros(len(limits), device=x.device).index_add_(0, idx, finite.float())
    clean = torch.where(finite, clipped, torch.zeros_like(clipped))
    kept = clipped[finite]
    any_f = kept.numel() > 0
    stats = (
        x.mean(), x.std(correction=0), x.min(), x.max(),
        kept.min() if any_f else clean.new_zeros(()), kept.max() if any_f else clean.new_zeros(()),
        clean.sum(), (clean * clean).sum(), finite.sum().float(),
    )
    return [float(v) for v in torch.stack(stats).cpu()] + [counts.cpu().numpy()]


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


class SummaryWriter:
    """Writes ``events.out.tfevents.<ts>.<host>`` + ``metrics.jsonl`` under
    ``log_dir``.  Usage: ``writer.scalars(step, {...})`` per step, plus
    ``writer.variable_stats(step, params)`` for the per-variable summaries
    the reference logs (model.py:527-535)."""

    def __init__(self, log_dir: str, filename_suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        ts = int(time.time())
        host = os.uname().nodename if hasattr(os, "uname") else "host"
        self._event_path = os.path.join(
            log_dir, f"events.out.tfevents.{ts}.{host}{filename_suffix}"
        )
        self._jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        self._events = open(self._event_path, "ab")
        self._jsonl = open(self._jsonl_path, "a")
        self._closed = False
        self._degraded = False
        self._write_events(
            _frame_record(
                _encode_event(time.time(), 0, file_version="brain.Event:2")
            )
        )

    # Observability must degrade, never kill training: once the loop is
    # unwinding (exception, SIGTERM teardown, disk full) a failing event
    # write would mask the real outcome with a logging traceback.  The
    # first failure warns and the writer goes quiet; close() is idempotent
    # because both the with-block AND an outer ExitStack may reach it.
    def _write_events(self, data: bytes) -> None:
        if self._closed or self._degraded:
            return
        try:
            self._events.write(data)
        except (OSError, ValueError) as e:
            self._degrade("event file", e)

    def _write_jsonl(self, line: str) -> None:
        if self._closed or self._degraded:
            return
        try:
            self._jsonl.write(line)
        except (OSError, ValueError) as e:
            self._degrade("metrics.jsonl", e)

    def _degrade(self, what: str, exc: BaseException) -> None:
        if self._degraded:  # warn once; later failures are the same story
            return
        self._degraded = True
        print(
            f"sat_tpu_torch: summary writer disabled — {what} write failed: {exc}",
            file=sys.stderr,
            flush=True,
        )

    def scalars(self, step: int, values: Mapping[str, float]) -> None:
        clean: Dict[str, float] = {}
        # tfevents can only carry finite floats, but a diverged run must
        # still leave a trace: non-finite values go to metrics.jsonl as
        # strings ("nan"/"inf") so the failure is visible post-hoc.
        record: Dict[str, Any] = {}
        for tag, v in values.items():
            v = float(np.asarray(v))
            if np.isfinite(v):
                clean[tag] = v
                record[tag] = v
            else:
                record[tag] = repr(v)
        if not record:
            return
        if clean:
            self._write_events(
                _frame_record(_encode_event(time.time(), step, clean))
            )
        # Every row carries wall-clock + monotonic stamps and the process
        # run id so post-hoc joins against telemetry.jsonl/heartbeat.json
        # key on (run_id, time), never on file mtimes.
        self._write_jsonl(
            json.dumps(
                {
                    "step": int(step),
                    "wall_time": round(time.time(), 6),
                    "mono_ns": time.perf_counter_ns(),
                    "run_id": run_id(),
                    **record,
                }
            )
            + "\n"
        )

    def histograms(self, step: int, values: Mapping[str, Any]) -> None:
        """True HistogramProto summaries (reference model.py:527) for
        host-side arrays; one event carrying every tag."""
        summary = b"".join(
            _field_len(1, _encode_histo_value(tag, _histo_from_array(v)))
            for tag, v in values.items()
        )
        self._write_events(
            _frame_record(
                _encode_event(time.time(), step, summary_bytes=summary)
            )
        )

    def variable_stats(self, step: int, tree, prefix: str = "params", max_vars: int = 0) -> None:
        """Per-variable mean/std/min/max scalars and histograms — the
        reference's variable_summary for every trainable (model.py:516-527).
        ``tree``: nested dicts of tensors (the port's params), named by
        their dict path."""
        leaves = []

        def walk(node, path):
            for key, value in node.items():
                if isinstance(value, dict):
                    walk(value, f"{path}/{key}")
                else:
                    leaves.append((f"{path}/{key}", value))

        walk(tree, prefix)
        if max_vars:
            leaves = leaves[:max_vars]
        stats = {}
        histo_summary = b""
        for name, leaf in leaves:
            mean, std, lo, hi, hlo, hhi, total, sumsq, num, counts = _reduce_stats(leaf)
            stats[f"{name}/mean"] = mean
            stats[f"{name}/std"] = std
            stats[f"{name}/min"] = lo
            stats[f"{name}/max"] = hi
            histo = _encode_histo(hlo, hhi, num, total, sumsq, counts)
            histo_summary += _field_len(1, _encode_histo_value(name, histo))
        self.scalars(step, stats)
        self._write_events(
            _frame_record(_encode_event(time.time(), step, summary_bytes=histo_summary))
        )

    def flush(self) -> None:
        if self._closed:
            return
        try:
            self._events.flush()
            self._jsonl.flush()
        except (OSError, ValueError) as e:
            self._degrade("flush", e)

    def close(self) -> None:
        if self._closed:
            return
        self.flush()
        self._closed = True
        try:
            self._events.close()
            self._jsonl.close()
        except (OSError, ValueError) as e:
            self._degrade("close", e)

    def __enter__(self) -> "SummaryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
