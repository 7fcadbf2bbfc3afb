"""The whole train step's share of the card's bf16 peak: the window's
operations (encoder forward, decoder forward and backward; the benchmark's
own counts from shapes) over the window's length times 989 TFLOP/s."""

from capbench.roofline import BF16_FLOPS


def read(rec):
    return 100.0 * rec["flops"] / (rec["window_s"] * BF16_FLOPS) if rec.get("flops") else None
