"""Peaks of the card and the work of the model, counted from shapes.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense
rates.  Operation counts are the benchmark's own: 2 per multiply-add of
each conv and matmul, and the attention kernel's elementwise work, so a
share of a peak computed from them can be checked by hand.
"""

from __future__ import annotations

from typing import Dict, Tuple

from .reference.shapes import VGG_LAYERS, resnet_blocks

HBM_BYTES_PER_S = 3.35e12   # device memory rate
FP32_FLOPS = 67e12          # float32 outside the tensor cores
BF16_FLOPS = 989e12         # bfloat16 on the tensor cores, dense


def attention_bound_s(rows: int, N: int, da: int, D: int) -> Tuple[float, str]:
    """The least time of one launch of the fused attention kernel (B1) over
    ``rows`` rows: each input read once (t1 [rows, N, da], t2 [rows, da],
    w2 [da], contexts [rows, N, D]), each output written once (context
    [rows, D], alpha [rows, N]), all float32, over the memory rate; its
    float32 operations over the float32 rate.  Returns (seconds, "bytes"
    or "operations")."""
    nbytes = 4 * (rows * N * da + rows * da + da + rows * N * D + rows * D + rows * N)
    flops = rows * N * (3 * da + 2 * D) + 4 * rows * N
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _out(n: int, stride: int) -> int:
    return -(-n // stride)


def cnn_flops(cfg: Dict, batch: int) -> float:
    """Operations of the encoder's convs over ``batch`` images."""
    s = cfg["image_size"]
    total = 0
    if cfg["cnn"] == "vgg16":
        cin = 3
        for _, cout, pool in VGG_LAYERS:
            total += 2 * s * s * 9 * cin * cout
            cin = cout
            if pool:
                s = _out(s, 2)
        return float(total * batch)
    h = _out(_out(s, 2), 2)  # conv1 at stride 2, then the 3x3/2 max pool
    total += 2 * _out(s, 2) ** 2 * 7 * 7 * 3 * 64
    cin = 64
    for _, _, width, stride, projection in resnet_blocks():
        out = _out(h, stride)
        if projection:
            total += 2 * out * out * cin * 4 * width
        total += 2 * out * out * (cin * width + 9 * width * width + width * 4 * width)
        h, cin = out, 4 * width
    return float(total * batch)


def decoder_init_flops(cfg: Dict, batch: int) -> float:
    """The initializer MLP and the hoisted attention features t1 of a batch."""
    N, D, H = cfg["num_ctx"], cfg["dim_ctx"], cfg["num_lstm_units"]
    da, di = cfg["dim_attend_layer"], cfg["dim_initialize_layer"]
    return float(batch * (2 * 2 * (D * di + di * H) + 2 * N * D * da))


def decoder_step_flops(cfg: Dict, rows: int) -> float:
    """One decode step over ``rows`` beam rows: t2, the attention (B1's
    elementwise work and its two products), the LSTM and the decode MLP."""
    N, D, H, E = cfg["num_ctx"], cfg["dim_ctx"], cfg["num_lstm_units"], cfg["dim_embedding"]
    da, dd, V = cfg["dim_attend_layer"], cfg["dim_decode_layer"], cfg["vocabulary_size"]
    per_row = (2 * H * da + N * (3 * da + 2 * D) + 4 * N
               + 2 * (D + E + H) * 4 * H + 2 * (H + D + E) * dd + 2 * dd * V)
    return float(rows * per_row)


def offline_batch_flops(cfg: Dict, batch: int, steps: int) -> float:
    """An offline batch: encode, initialize, then ``steps`` beam steps."""
    rows = batch * cfg["beam_size"]
    return (cnn_flops(cfg, batch) + decoder_init_flops(cfg, batch)
            + steps * decoder_step_flops(cfg, rows))


def train_step_flops(cfg: Dict, batch: int) -> float:
    """A training step with the CNN frozen: the encoder forward, then the
    teacher-forced decoder's forward over T steps (the attention features
    t1 recomputed every step from dropped-out contexts) and its backward,
    counted as twice the forward."""
    N, D, da = cfg["num_ctx"], cfg["dim_ctx"], cfg["dim_attend_layer"]
    H, di, T = cfg["num_lstm_units"], cfg["dim_initialize_layer"], cfg["max_caption_length"]
    forward = (batch * 2 * 2 * (D * di + di * H)
               + T * (batch * 2 * N * D * da + decoder_step_flops(cfg, batch)))
    return cnn_flops(cfg, batch) + 3.0 * forward
