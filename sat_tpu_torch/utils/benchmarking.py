"""Shared measurement core — the port of ``sat_tpu.utils.benchmarking``.

One implementation of the eval-decode benchmark, used by every vehicle
that reports ``eval_images_per_sec`` (``tools.bench_eval``,
``tools.bench_eval_ab``, ``tools.bench_early_exit`` through bench_eval),
and one of the kernel timing (``tools.bench_attend`` and
``chip_smoke.py``), so that two vehicles differ only in what they
measure, never in how.

* :func:`make_chained_decode` returns a decode whose output carries a
  score-derived term too small to move a float32 pixel: each timed call
  consumes the previous call's images, so a window of calls is one
  dependent chain.
* :func:`time_decode_windows` times windows of such calls with one host
  sync a window (``torch.cuda.synchronize`` on the card), never one a
  call.  The first call is timed apart: it holds the kernel build and
  cuDNN's choice of algorithms.
* :func:`time_ms` times one kernel call by CUDA events, the L2 cache
  flushed before each; :func:`attention_bound_ms` and
  :func:`masked_bound_ms` are the least time the card could take for the
  same work (each input read once and each output written once at the
  H100's memory rate, the float32 operations at its float32 rate).

Importing this module loads no torch: the functions take it when called.
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (NVIDIA data sheet)
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores


def make_chained_decode(
    config,
    eos: int,
    beam_size: int,
    valid_size: Optional[int] = None,
    early_exit: bool = True,
) -> Callable:
    """``(params, images) -> (BeamResult, chained_images)``: encode, the
    beam search (B1 once a decode step on the card), then ``images +
    1e-30 * log_scores.sum()``.  ``params`` is the decoding copy
    (``train.checkpoint.compute_params``, or a quantized encoder's tree)."""
    import torch

    from ..models.captioner import encode
    from ..ops.beam_search import beam_search

    @torch.inference_mode()
    def decode(params: Dict[str, Any], images):
        contexts = encode(params, config, images)
        out = beam_search(
            params["decoder"], config, contexts, eos,
            beam_size=beam_size, valid_size=valid_size, early_exit=early_exit,
        )
        # serializing dependency for chained timing (see module docstring)
        return out, images + 1e-30 * out.log_scores.sum()

    return decode


def _sync(x) -> None:
    import torch

    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def time_decode_windows(
    decode: Callable,
    params: Dict[str, Any],
    images,
    iters: int,
    windows: int = 1,
) -> Tuple[float, List[float], Any]:
    """The first call, then ``windows`` timed windows of ``iters`` chained
    batches, one sync at the end of each.

    Returns (compile_s, each window's mean batch ms, final chained images).
    ``compile_s`` is the first call's seconds: the kernel build, lazy CUDA
    and cuDNN set-up and the choice of convolution algorithms."""
    t0 = time.perf_counter()
    out, images_c = decode(params, images)
    _sync(out.log_scores)
    compile_s = time.perf_counter() - t0

    windows_ms: List[float] = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            out, images_c = decode(params, images_c)
        _sync(out.log_scores)
        # raw ms: callers derive images/sec, so rounding happens only when
        # a row is written
        windows_ms.append(1e3 * (time.perf_counter() - t0) / iters)
    return compile_s, windows_ms, images_c


def time_ms(fn: Callable, flush, reps: int = 60, warm: int = 10, read_flush: bool = False) -> float:
    """Median device time of ``reps`` single calls of ``fn``, by CUDA
    events, with the L2 cache flushed before each (the decode loop streams
    t1 and contexts back from device memory every step).  A spin kernel
    ahead of each call keeps the card busy while the host enqueues it, so
    the host's launch overhead stays out of the interval.  The flush
    writes ``flush`` (a CUDA tensor larger than L2), leaving dirty lines
    the timed call writes back; with ``read_flush`` it reads it instead."""
    import torch

    for _ in range(warm):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        torch.cuda._sleep(1_000_000)  # ~0.5 ms of spinning
        flush.max() if read_flush else flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def _bound(nbytes: float, flops: float) -> Tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def attention_bound_ms(B: int, N: int, da: int, D: int) -> Tuple[float, str]:
    """B1's least time: each input read once, each output written once,
    over the memory rate; the float32 flops over the float32 rate.
    Returns (ms, "bytes" or "operations")."""
    nbytes = 4 * (B * N * da + B * da + da + B * N * D + B * D + B * N)
    flops = B * N * (3 * da + 2 * D) + 4 * B * N
    return _bound(nbytes, flops)


def masked_bound_ms(B: int, live: int, N: int, da: int, D: int) -> Tuple[float, str]:
    """B2's least time: only live rows' inputs must be read (dead rows are
    never touched), every row's outputs written; only live rows' flops.
    Returns (ms, "bytes" or "operations")."""
    nbytes = 4 * (live * (N * da + da + N * D) + da + B * (D + N)) + B
    flops = live * (N * (3 * da + 2 * D) + 4 * N)
    return _bound(nbytes, flops)


def attention_inputs(B: int, N: int, da: int, D: int, generator, device="cuda"):
    """Inputs shaped like the decode path's: tanh features, a small w2,
    non-negative (post-relu) contexts."""
    import torch

    t1 = torch.tanh(torch.randn((B, N, da), generator=generator, device=device))
    t2 = torch.tanh(torch.randn((B, da), generator=generator, device=device))
    w2 = (torch.rand((da, 1), generator=generator, device=device) - 0.5) * 0.16
    ctx = torch.relu(torch.randn((B, N, D), generator=generator, device=device))
    return t1, t2, w2, ctx
