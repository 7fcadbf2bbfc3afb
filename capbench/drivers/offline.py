"""Offline captioning: batches of seed-made images through the program's
batch decode entry, ``runtime.decode_batch`` (encode, then the monolithic
beam search with the fused attention kernel once a step).

Traffic parameters: ``batch`` images a batch, a ``ring`` of that many
distinct batches resident on the device, ``warm_batches`` run in set-up,
``trace_batches`` profiled after the window of a traced run, and
``check_images`` sampled for the comparison.

The window runs whole batches until ``--seconds`` have passed and ends on
a device sync; ``captions_per_s`` is every caption of the window over its
length.  The harness wraps ``runtime.encode`` to keep the contexts each
ring slot last produced (and, in a traced run, to time the encode by CUDA
events); the captions of each slot's last batch and those contexts are
what the comparison judges, once the window has closed and the program's
state is freed.

Controls, which have to come out not correct (``capbench.readings``
only): ``variant="int8"`` swaps in the program's own int8 encoder
(``encoder_quant``); ``variant="fp8"`` puts the reference, computed in
float8, in the program's place.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import torch

from .. import compare, inputs, roofline
from ..bench import Cell, program_config
from ..trace import segment


class _EncodeProbe:
    """``runtime.encode`` wrapped: keeps the contexts per ring slot and, when
    ``timing``, CUDA events around each call."""

    def __init__(self, runtime, timing: bool):
        self.runtime, self.inner, self.timing = runtime, runtime.encode, timing
        self.slot, self.contexts, self.events = 0, {}, []

    def __call__(self, params, config, images):
        if self.timing:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.inner(params, config, images)
            end.record()
            self.events.append((start, end))
        else:
            out = self.inner(params, config, images)
        self.contexts[self.slot] = out
        return out

    def __enter__(self):
        self.runtime.encode = self
        return self

    def __exit__(self, *exc):
        self.runtime.encode = self.inner


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _int8_params(params32, stats, config, ring, device):
    from sat_tpu_torch.nn.quant import quantize_encoder
    from sat_tpu_torch.data.images import ILSVRC_2012_MEAN

    calib = [(ring[0, :8].float().cpu().numpy() - ILSVRC_2012_MEAN)]
    return quantize_encoder({"cnn": params32["cnn"], "batch_stats": stats}, config, batches=calib, device=device)


def _fp8_reference(cfg, flat, probe):
    """The reference in the program's place, every conv and matmul operand
    rounded to float8 e4m3: the control of the decoder's numbers."""
    from types import SimpleNamespace

    from ..reference import model as ref

    dec = ref.Decoder(cfg, flat, ref.fp8_e4m3)

    def decode(images):
        ref.no_tf32()
        contexts = ref.encode(cfg, flat, images, ref.fp8_e4m3)
        probe.contexts[probe.slot] = contexts
        words, scores, lengths = ref.beam_search(dec, contexts, cfg["beam_size"], cfg["max_caption_length"],
                                                 cfg["eos_id"])
        return SimpleNamespace(words=words, log_scores=scores, lengths=lengths)

    return decode


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        variant: str = "") -> Dict[str, Any]:
    from sat_tpu_torch import runtime
    from sat_tpu_torch.ops.fused_attend import fused_attend
    from sat_tpu_torch.train.checkpoint import batch_stats_from_flat, compute_params, params_from_flat

    cfg, traffic = cell.config, cell.traffic
    config = program_config(cfg, **({"encoder_quant": "int8"} if variant == "int8" else {}))
    B, R, S = traffic["batch"], traffic["ring"], cfg["image_size"]
    eos, V = cfg["eos_id"], cfg["vocabulary_size"]

    flat = inputs.make_weights(cfg, seed, device)
    host = {k: v.cpu() for k, v in flat.items()}
    params32 = params_from_flat(host, config, device)
    stats = batch_stats_from_flat(host, config, device)
    del host
    ring = inputs.make_images(R * B, S, seed, device).view(R, B, S, S, 3)
    params = compute_params(params32, config, stats)
    if variant == "int8":
        params = {"decoder": params["decoder"], "qcnn": _int8_params(params32, stats, config, ring, device)}
    del params32, stats

    results: Dict[int, Any] = {}
    with _EncodeProbe(runtime, timing=trace and device.type == "cuda") as probe:
        def batch(i: int):
            probe.slot = i % R
            results[i % R] = decode(ring[i % R])

        def decode(images):
            return runtime.decode_batch(params, config, images, eos, V)

        if variant == "fp8":
            decode = _fp8_reference(cfg, flat, probe)

        for i in range(traffic["warm_batches"]):
            batch(i)
        _sync(device)
        probe.events.clear()
        results.clear()
        probe.contexts.clear()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t_start

        n, launched, ends = 0, fused_attend.launches, []
        t0 = time.perf_counter()
        while True:
            batch(n)
            n += 1
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        _sync(device)
        window_s = time.perf_counter() - t0
        steps = fused_attend.launches - launched
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        judged, contexts = dict(results), dict(probe.contexts)

        record: Dict[str, Any] = {"window_s": window_s, "batches": n, "batch": B, "steps": steps, "ends": ends,
                                  "config": cfg, "flops": n * roofline.offline_batch_flops(cfg, B, steps / n)}
        if trace and device.type == "cuda":
            record["encode_s"] = [s.elapsed_time(e) * 1e-3 for s, e in probe.events]
            probe.timing = False
            launched = fused_attend.launches

            def work():
                for i in range(n, n + traffic["trace_batches"]):
                    batch(i)
                _sync(device)

            summary = segment(work)
            summary["steps"] = (fused_attend.launches - launched) // 2
            record["trace_batches"] = traffic["trace_batches"]
            record["trace"] = summary

    # the comparison: a seed-drawn sample of the images of each slot's last batch in the window
    slots = sorted(judged)
    per_slot = traffic["check_images"] // len(slots)
    pick = torch.randperm(B, generator=torch.Generator().manual_seed(seed % (2 ** 63)))[:per_slot].to(device)
    sample = {
        "images": torch.cat([ring[s][pick] for s in slots]),
        "contexts": torch.cat([contexts[s][pick] for s in slots]),
        "words": torch.cat([judged[s].words[pick] for s in slots]),
        "scores": torch.cat([judged[s].log_scores[pick] for s in slots]),
        "lengths": torch.cat([judged[s].lengths[pick] for s in slots]),
    }
    del params, ring, results, judged, contexts, probe
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings, per_image = compare.caption_checks(cfg, flat, sample["images"], sample["words"], sample["scores"],
                                                 sample["lengths"], contexts=sample["contexts"])
    checks, failed = compare.judge(readings, per_image, cell.limits)
    _sync(device)
    return {
        "check_s": time.perf_counter() - t_check,
        "metrics": {"setup_s": setup_s, "captions_per_s": n * B / window_s},
        "record": record,
        "attempted": n * B,
        "failed": failed,
        "checks": checks,
        "memory_peak_bytes": peak,
        "readings": readings,
    }
