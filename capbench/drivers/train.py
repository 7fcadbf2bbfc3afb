"""Training: the program's train step (``train.step.make_train_step`` over
``state_from_params``, the CNN frozen as the configuration states) on a
ring of ``ring`` device-resident batches of ``batch`` seed-made pairs:
images, and captions of ``min_words`` to ``max_words`` words plus the end
token, masked to T.  Dropout runs as the configuration states, its masks
drawn from one seed-made generator on the card.

Set-up builds the train state and the step once, and drives them from the
seed through their first ``check_steps`` steps, through the window's own
call, on the ring's first batches (rows that all differ); the window then
goes on stepping the same state until ``--seconds`` have passed and ends
on a device sync.  ``train_pairs_per_s`` is every pair stepped in the
window over its length.

The comparison, once the window has closed and the program's state is
freed: the reference follows the first three steps from the same weights,
batches and dropout generator, in float32.  Numbers, each the worst over
steps or leaves (a leaf's gap measured against the larger of the
reference's norm of that leaf and of the median leaf):

* ``loss_err``: relative gap of each step's loss;
* ``grad_err``: gap of each leaf's first gradient as the optimizer got it
  (clipped), read from Adam's first moment after step 1;
* ``change_err``: gap of each leaf's change over the three steps; leaves
  whose reference gradient lies under a thousandth of the median leaf's
  (moved by round-off alone under Adam) are left out.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import torch

from .. import inputs, roofline
from ..bench import Cell, program_config
from ..reference import model as ref
from ..trace import segment

DROPOUT_STREAM = 3
CAPTION_STREAM = 4


def make_batches(cfg: Dict, traffic: Dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    R, B, T, V, eos = traffic["ring"], traffic["batch"], cfg["max_caption_length"], cfg["vocabulary_size"], cfg["eos_id"]
    images = inputs.make_images(R * B, cfg["image_size"], seed, device).view(R, B, *([cfg["image_size"]] * 2), 3)
    g = inputs.generator(seed, CAPTION_STREAM, device)
    words = torch.randint(1, V - 1, (R, B, T), generator=g, device=device)
    words = torch.where(words >= eos, words + 1, words)  # any word but the end token
    length = torch.randint(traffic["min_words"], traffic["max_words"] + 1, (R, B, 1), generator=g, device=device)
    t = torch.arange(T, device=device)
    words = torch.where(t == length, torch.full_like(words, eos), torch.where(t < length, words, 0))
    masks = (t <= length).float()
    return [{"images": images[r], "word_idxs": words[r], "masks": masks[r]} for r in range(R)]


def _named(tree, prefix: str):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _named(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


def _leaf_gap(got: Dict[str, float], want: Dict[str, float], names) -> float:
    """The worst leaf's gap of norms against the larger of its reference
    norm and the median leaf's."""
    med = sorted(want.values())[len(want) // 2]
    return max(abs(got[n] - want[n]) / max(want[n], med) for n in names)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        variant: str = "") -> Dict[str, Any]:
    from sat_tpu_torch.train import step as program_step
    from sat_tpu_torch.train.checkpoint import batch_stats_from_flat, params_from_flat

    cfg, traffic = cell.config, cell.traffic
    config = program_config(cfg)
    B, checks_n = traffic["batch"], traffic["check_steps"]
    flat = inputs.make_weights(cfg, seed, device)
    host = {k: v.cpu() for k, v in flat.items()}
    params = params_from_flat(host, config, device)
    state = program_step.state_from_params(params, config, batch_stats=batch_stats_from_flat(host, config, device))
    del host, params
    batches = make_batches(cfg, traffic, seed, device)
    generator = inputs.generator(seed, DROPOUT_STREAM, device)
    train_step = program_step.make_train_step(config)
    if variant == "half":  # the fault: half of each batch left out, the mean taken over the rest
        inner = program_step.compute_loss
        program_step.compute_loss = lambda p, c, batch, *a, **k: inner(
            p, c, {key: v[: v.shape[0] // 2] for key, v in batch.items()}, *a, **k)

    losses, grad1 = [], {}
    for s in range(checks_n):
        state, metrics = train_step(state, batches[s % len(batches)], generator)
        losses.append(metrics["total_loss"])
        if s == 0:
            mu = state.opt_state[-1][0]["mu"]
            grad1 = {n: v.norm() / (1.0 - cfg["beta1"]) for n, v in _named(mu, "params/")}
    change = {n: (v.detach() - flat[n]).norm() for n, v in _named({"decoder": state.params["decoder"]}, "params/")}
    _sync(device)
    program = {"losses": [float(x) for x in losses], "grad1": {n: float(v) for n, v in grad1.items()},
               "change": {n: float(v) for n, v in change.items()}}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    n, t0 = 0, time.perf_counter()
    while True:
        state, _ = train_step(state, batches[(checks_n + n) % len(batches)], generator)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    record: Dict[str, Any] = {"window_s": window_s, "steps": n, "batch": B, "config": cfg,
                              "flops": n * roofline.train_step_flops(cfg, B)}
    if trace and device.type == "cuda":
        def work():
            nonlocal state
            for i in range(traffic["trace_steps"]):
                state, _ = train_step(state, batches[i % len(batches)], generator)
            _sync(device)

        summary = segment(work)
        summary["steps"] = traffic["trace_steps"]
        record["trace"] = summary
    if variant == "half":
        program_step.compute_loss = inner
    del state, train_step, generator
    if device.type == "cuda":
        torch.cuda.empty_cache()

    want = reference_steps(cfg, flat, batches[:checks_n], seed, device)
    if variant == "fp8":  # the control: the reference in the program's place, in float8
        program = reference_steps(cfg, flat, batches[:checks_n], seed, device, ref.fp8_e4m3)
    readings = compare_steps(program, want)
    checks = {k: {"value": v if v == v else float("inf"), "limit": float(cell.limits[k])} for k, v in readings.items()}
    return {
        "metrics": {"setup_s": setup_s, "train_pairs_per_s": n * B / window_s},
        "record": record,
        "attempted": n * B,
        "failed": sum(1 for c in checks.values() if not c["value"] <= c["limit"]),
        "checks": checks,
        "memory_peak_bytes": peak,
        "readings": readings,
    }


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reference_steps(cfg: Dict, flat: Dict[str, torch.Tensor], batches, seed: int, device, rnd=None
                    ) -> Dict[str, Any]:
    """The reference's losses, first clipped gradient norms and changes over
    ``len(batches)`` steps from ``flat``, dropout drawn from the run's
    generator stream in the program's order."""
    ref.no_tf32()
    names = [n for n in flat if n.startswith("params/decoder/")]
    leaves = [flat[n].detach().clone().requires_grad_(True) for n in names]
    work = {**flat, **dict(zip(names, leaves))}
    dec = ref.Decoder(cfg, work, rnd or (lambda t: t))
    opt = ref.Adam(leaves, cfg["initial_learning_rate"], cfg["beta1"], cfg["beta2"], cfg["epsilon"],
                   cfg["clip_gradients"])
    generator = inputs.generator(seed, DROPOUT_STREAM, device)
    out: Dict[str, Any] = {"losses": []}
    for s, batch in enumerate(batches):
        with torch.no_grad():
            contexts = ref.encode(cfg, flat, batch["images"], rnd or (lambda t: t))
        loss = ref.train_loss(dec, contexts, batch["word_idxs"], batch["masks"], generator)
        grads = torch.autograd.grad(loss, leaves)
        clipped = opt.step(leaves, list(grads))
        out["losses"].append(float(loss.detach()))
        if s == 0:
            out["grad1"] = {n: float(g.norm()) for n, g in zip(names, clipped)}
        del loss, grads, clipped, contexts
    out["change"] = {n: float((p.detach() - flat[n]).norm()) for n, p in zip(names, leaves)}
    return out


def compare_steps(got: Dict[str, Any], want: Dict[str, Any]) -> Dict[str, float]:
    names = list(want["grad1"])
    med = sorted(want["grad1"].values())[len(names) // 2]
    moved = [n for n in names if want["grad1"][n] >= 1e-3 * med]
    return {
        "loss_err": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])),
        "grad_err": _leaf_gap(got["grad1"], want["grad1"], names),
        "change_err": _leaf_gap(got["change"], want["change"], moved),
    }
