"""Train, eval and test runtimes — the port of ``sat_tpu.runtime``.

* ``train``: the epoch × batch loop over ``prepare_train_data``, one
  ``train.step`` a batch with its dropout generator keyed on (seed + 1,
  global step), mid-epoch resume by ``DataSet.seek``, metrics every
  ``log_every`` steps (the loop's one host sync) into ``metrics.jsonl``
  and tfevents, checkpoints every ``save_period`` steps through the
  async writer, the anomaly sentinel (warn, skip, rollback to
  ``LAST_GOOD``), graceful SIGTERM/SIGINT, the progress watchdog and
  the ``SAT_FI_*`` fault hooks (kill, wedge, slow, NaN poison; the
  checkpoint corruption hook sits in the checkpoint writer);
* ``evaluate``: beam-search every image of the eval split, write
  ``results.json`` and score it with BLEU-1..4, METEOR, ROUGE-L and CIDEr;
  ``evaluate_sweep`` scores every checkpoint under ``save_dir``;
* ``test``: caption every JPEG of a directory into ``results.csv`` and
  captioned JPEGs;
* with ``save_attention_maps``, eval and test also write per-image
  attention panels and ``attn.jsonl`` / ``attn.html``.

All three phases build their feed with :func:`make_loader`: the shard
cache per ``shard_cache`` (``data.shards``), the prefetching loader, and
the run's quarantine (a bad JPEG or caption is ledgered to
``quarantine.jsonl`` and replaced by a healthy row of its batch; see
``resilience.quarantine``).

``decode_dataset`` drives eval and test: the prefetching loader, a
host→device feed one batch ahead (pinned host batches, ``non_blocking``
copies), then per batch ``captioner.encode`` and the monolithic
``beam_search`` (whose attention step is the CUDA ``fused_attend`` on the
card).  Batch n+1 is dispatched before batch n is drained, as in the JAX
package; here the search syncs with the host once a step, so the two do
not overlap yet.  Entry points run on the card unless the caller passes
``device="cpu"``.

Both CNNs run in every phase.  A ``model_file`` ending in ``.npy`` is a
checkpoint written by the reference itself, imported by name
(``train.checkpoint.import_reference_checkpoint``); training imports a
pretrained CNN with ``load_cnn`` from ``cnn_model_file``, as the JAX
package does (eval and test ignore it there too).  ``encoder_quant``
acts only where a serve engine is built (serve, bulk): train, eval and
test encode in full precision, as in the JAX package.

Not ported yet, and raising ``NotImplementedError`` (:func:`check_ported`,
:func:`check_train_ported`): mesh and context-parallel runs,
``telemetry``, ``blackbox`` and the profiler window (``profile_dir``);
for training also ``remat_decoder``, ``remat_cnn``, ``diag_level`` and
``fleet_telemetry``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import Config
from .data.dataset import DataSet, prepare_eval_data, prepare_test_data, prepare_train_data
from .data.images import ImageLoader, PrefetchLoader
from .data.shards import resolve_shard_cache
from .data.vocabulary import Vocabulary, vocab_fingerprint
from .device import resolve_device
from .evalcap.eval import CocoEvalCap
from .models.captioner import encode, init_variables
from .ops.beam_search import BeamResult, beam_search
from .resilience import lineage, retry
from .resilience.faultinject import FaultPlan
from .resilience.lineage import CheckpointWriteError
from .resilience.preempt import GracefulShutdown
from .resilience.quarantine import QuarantineManager, ledger_path_for
from .resilience.sentinel import AnomalySentinel
from .resilience.watchdog import Watchdog, deadlines_from_config
from .train.checkpoint import (
    AsyncCheckpointWriter, ServingState, apply_cnn_import, check_vocab, compute_params,
    import_reference_checkpoint, load_flat, restore_checkpoint, save_checkpoint, state_from_flat,
    to_device, walk_back,
)
from .train.step import TrainState, create_train_state, make_train_step, step_generator
from .utils.fileio import atomic_write
from .utils.progress import Progress, track
from .utils.summary import SummaryWriter


def check_ported(config: Config) -> None:
    """Raise on eval/test (and train) knobs whose subsystem is not ported yet."""
    if int(np.prod(config.mesh_shape)) > 1 or config.context_parallel > 1:
        raise NotImplementedError(
            f"mesh and context-parallel runs (mesh_shape={tuple(config.mesh_shape)}, "
            f"context_parallel={config.context_parallel}) are not ported to sat_tpu_torch "
            "yet (only one device)"
        )
    # the other telemetry knobs act only with telemetry on, in both packages
    unported = {
        "telemetry": (config.telemetry, (False,)),
        "blackbox": (config.blackbox, (False,)),
        "profile_dir": (config.profile_dir, ("",)),
    }
    for name, (value, ported) in unported.items():
        if value not in ported:
            raise NotImplementedError(
                f"{name}={value!r} is not ported to sat_tpu_torch yet (only "
                f"{' or '.join(repr(p) for p in ported)})"
            )


def check_train_ported(config: Config) -> None:
    """Raise on train knobs whose subsystem is not ported yet.

    ``rng_impl`` is accepted and has no effect: it picks JAX's random-bit
    generator, and torch draws dropout masks with its own (Philox on the
    card), so the port's masks never equal the JAX package's bits."""
    check_ported(config)
    if config.remat_decoder or config.remat_cnn:
        raise NotImplementedError(
            f"remat_decoder={config.remat_decoder}, remat_cnn={config.remat_cnn}: "
            "rematerialization is not ported to sat_tpu_torch yet"
        )
    unported = {
        "diag_level": (config.diag_level, "off"),
        "fleet_telemetry": (config.fleet_telemetry, False),
    }
    for name, (value, ported) in unported.items():
        if value != ported:
            raise NotImplementedError(
                f"{name}={value!r} is not ported to sat_tpu_torch yet (only {ported!r})"
            )


# ---------------------------------------------------------------------------
# input feed
# ---------------------------------------------------------------------------


# One QuarantineManager per ledger path, i.e. per run: the systemic-
# corruption ceiling is a run-level judgement, so the train and eval
# loaders of one run share the bookkeeping.
_QUARANTINES: Dict[str, QuarantineManager] = {}


def _quarantine_for(config: Config) -> QuarantineManager:
    path = ledger_path_for(config)
    q = _QUARANTINES.get(path)
    if q is None:
        q = QuarantineManager(path, max_fraction=config.quarantine_max_fraction)
        _QUARANTINES[path] = q
    return q


def make_loader(config: Config, dataset: DataSet) -> PrefetchLoader:
    """The host-side input pipeline of a dataset: the shard cache resolved
    per ``config.shard_cache`` (``data.shards``: build-or-load for "on",
    an existing valid cache for "auto", live JPEG decode when none), the
    prefetching loader ``prefetch_depth`` batches ahead, and the run's
    quarantine."""
    return PrefetchLoader(
        dataset,
        ImageLoader(size=config.image_size, raw=config.device_preprocess),
        num_workers=config.num_data_workers,
        prefetch_depth=config.prefetch_depth,
        shard_cache=resolve_shard_cache(config, dataset.image_files),
        quarantine=_quarantine_for(config),
    )


def device_prefetch(loader, device: torch.device):
    """Host→device feed one batch ahead: the copy of batch k+1 is enqueued
    before batch k is handed on.  On the card each host batch is pinned
    and copied with ``non_blocking``, so the copy overlaps the device's
    work on the batch before it.  Every array ('images', and a training
    batch's 'word_idxs' and 'masks') becomes a device tensor; 'files'
    passes through."""
    pin = device.type == "cuda"

    def move(value):
        t = torch.from_numpy(value)
        if pin:
            t = t.pin_memory()
        return t.to(device, non_blocking=pin)

    def put(batch):
        return {k: move(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}

    pending = None
    it = iter(loader)
    try:
        for batch in it:
            ready, pending = pending, put(batch)
            if ready is not None:
                yield ready
        if pending is not None:
            yield pending
    finally:
        it.close()


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------


def setup_state(
    config: Config,
    load: bool = False,
    model_file: Optional[str] = None,
    device=None,
) -> ServingState:
    """Decoding params on ``device`` (the card unless "cpu").

    An explicit ``model_file`` is loaded as-is (a reference ``.npy`` is
    imported over a random initialization from ``config.seed``); with
    ``load`` the newest checkpoint under ``save_dir`` that verifies and
    loads; with neither, that random initialization.  The configured
    vocabulary must match the one the checkpoint's sidecar attests."""
    dev = resolve_device(device)
    if not (load or model_file) or _is_reference(model_file):
        params, batch_stats = init_variables(config, torch.Generator().manual_seed(config.seed), dev)
        state = ServingState(params=params, step=0, batch_stats=batch_stats)
        if not model_file:
            return state
        state, count = import_reference_checkpoint(state, model_file)
        _check_count(count, model_file)
        print(f"{count} tensors loaded from checkpoint (step {state.step}).")
        return state
    expect = vocab_fingerprint(config.vocabulary_file, config.vocabulary_size)
    if model_file:
        check_vocab(model_file, expect)
        flat, source = load_flat(model_file), model_file
    else:
        flat, source = walk_back(config.save_dir, expect)
    state = state_from_flat(flat, config, dev, source)
    print(f"checkpoint {source} loaded (step {state.step}).")
    return state


def _is_reference(model_file: Optional[str]) -> bool:
    """A checkpoint the reference itself wrote (its flat ``.npy``)."""
    return bool(model_file) and model_file.endswith(".npy")


def _check_count(count: int, source: str) -> None:
    if count == 0:
        raise ValueError(f"checkpoint {source} restored 0 tensors")


def setup_train_state(
    config: Config,
    load: bool = False,
    model_file: Optional[str] = None,
    load_cnn: bool = False,
    cnn_model_file: Optional[str] = None,
    seed: Optional[int] = None,
    device=None,
) -> TrainState:
    """A train state on ``device`` (the card unless "cpu"): parameters drawn
    from ``seed`` (default ``config.seed``) and fresh slots; then, with
    ``load`` or ``model_file``, a checkpoint restored over them (the
    vocabulary fingerprint checked; a reference ``.npy`` imported at step
    0; a file that loads no tensor raises); then, with ``load_cnn``, the
    pretrained CNN of ``cnn_model_file`` imported over the CNN."""
    dev = resolve_device(device)
    seed = config.seed if seed is None else seed
    state = create_train_state(config, torch.Generator().manual_seed(seed), dev)
    if load or model_file:
        if _is_reference(model_file):
            state, count = import_reference_checkpoint(state, model_file)
        else:
            state, count = restore_checkpoint(
                state, model_file=model_file, save_dir=config.save_dir,
                expect_vocab=vocab_fingerprint(config.vocabulary_file, config.vocabulary_size),
            )
        _check_count(count, model_file or config.save_dir)
        print(f"{count} tensors loaded from checkpoint (step {state.step}).")
    if load_cnn and cnn_model_file:
        state, count = apply_cnn_import(state, cnn_model_file)
        print(f"{count} pretrained CNN tensors loaded.")
    return state


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def _watched_iter(it, wd: Watchdog, name: str):
    """Every fetch from ``it`` inside a watchdog phase guard, so a feed
    that stops producing trips the ``data_wait`` deadline."""
    it = iter(it)
    while True:
        with wd.phase(name):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item


def _fetch(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The metrics as host floats, in one device→host copy."""
    keys = list(metrics)
    values = torch.stack([metrics[k].float() for k in keys]).cpu().tolist()
    return dict(zip(keys, values))


def train(
    config: Config,
    state: Optional[TrainState] = None,
    dataset: Optional[DataSet] = None,
    seed: Optional[int] = None,
    device=None,
) -> TrainState:
    """The epoch × batch training loop; returns the final state.

    ``seed`` (default ``config.seed``) drives the batch order, the
    parameter init of a fresh state and the dropout masks: step ``s``
    draws its masks from ``step_generator(seed, s)``, so a run resumed
    from a checkpoint of step ``s`` replays the batches and masks of the
    uninterrupted run.  The final checkpoint is saved after the loop and
    must verify (``CheckpointWriteError`` otherwise)."""
    check_train_ported(config)
    dev = resolve_device(device)
    if seed is None:
        seed = config.seed
    if dataset is None:
        dataset = prepare_train_data(config if seed == config.seed else config.replace(seed=seed))
    if dataset.count == 0:
        raise ValueError(
            "training dataset is empty after preparation — every caption was filtered out "
            "(max_caption_length and vocabulary filters) or the caption file has none"
        )
    if state is None:
        state = setup_train_state(config, seed=seed, device=dev)
    train_step = make_train_step(config)
    loader = make_loader(config, dataset)
    retry.configure(config.io_retries, config.io_retry_base_s)
    sentinel = AnomalySentinel(config.anomaly_policy, config.anomaly_spike_factor)
    plan = FaultPlan.from_env()
    async_writer = AsyncCheckpointWriter() if config.async_checkpoint else None
    ckpt_save = async_writer.save if async_writer else save_checkpoint
    wd = Watchdog(
        deadlines_from_config(config),
        poll_s=config.watchdog_interval or 1.0,
        grace_s=config.watchdog_grace_s,
        dump_path=os.path.join(
            config.telemetry_dir or os.path.join(config.summary_dir, "telemetry"),
            "watchdog_stacks.txt",
        ),
        pre_abort=async_writer.flush if async_writer else None,
    )
    step = state.step
    stopped = False
    final_path: Optional[str] = None
    # the ExitStack drains the async writer last (after the summary writer
    # closes), on success and on exception alike
    with contextlib.ExitStack() as stack, SummaryWriter(config.summary_dir) as writer, \
            GracefulShutdown() as shutdown:
        if async_writer:
            stack.callback(async_writer.close)
        if config.watchdog_interval > 0:
            # stops before the writer drains, so a slow drain is no wedge
            stack.callback(wd.stop)
            wd.start()
        while True:  # re-entered only by a sentinel rollback
            rollback = False
            # batch order is a function of (seed, epoch), so the global
            # step is the cursor: resume exactly where the checkpoint was
            start_epoch, skip_batches = divmod(step, dataset.num_batches)
            if start_epoch < config.num_epochs:
                dataset.seek(start_epoch, skip_batches)
            for epoch in range(start_epoch, config.num_epochs):
                bar = Progress(
                    dataset.num_batches, desc=f"epoch {epoch + 1}/{config.num_epochs}",
                    initial=skip_batches if epoch == start_epoch else 0,
                )
                feed = device_prefetch(loader, dev)
                try:
                    for batch in _watched_iter(feed, wd, "data_wait"):
                        with wd.phase("step"):
                            if config.max_steps and step >= config.max_steps:
                                stopped = True
                                break
                            plan.maybe_kill(step)  # injected preemption (inert unarmed)
                            plan.maybe_wedge(step)  # injected silent hang
                            plan.maybe_slow(step)  # injected slow-but-alive step
                            if shutdown.stop_requested:
                                stopped = True
                                break
                            with wd.phase("dispatch"):
                                state, metrics = train_step(state, batch, step_generator(seed, step, dev))
                            step += 1
                            # injected NaN update (inert unarmed): poisons params and metrics
                            state, metrics = plan.maybe_poison(step, state, metrics)
                            if step % config.log_every == 0:
                                host = _fetch(metrics)  # the loop's one host sync
                                writer.scalars(step, host)
                                if sentinel.check(step, host) == "rollback":
                                    rollback = True
                                    break
                            if config.var_summary_period and step % config.var_summary_period == 0:
                                writer.variable_stats(step, state.params)
                            if config.save_period and step % config.save_period == 0 and not sentinel.suppress_save:
                                with wd.phase("checkpoint"):
                                    ckpt_save(state, config, healthy=sentinel.healthy)
                            bar.update()
                finally:
                    feed.close()
                bar.close()
                if stopped or rollback:
                    break
                print(f"epoch {epoch + 1}/{config.num_epochs} done (step {step})")
            if rollback:
                if async_writer:
                    # the save that blessed LAST_GOOD may still be queued
                    async_writer.flush()
                restored = _restore_last_good(state, config, step)
                if restored is None:
                    sentinel.policy = "warn"  # nothing to roll back to
                else:
                    state = restored
                    sentinel.note_rolled_back()
                continue
            break
        if sentinel.suppress_save:
            print(
                "sat_tpu_torch: final checkpoint suppressed — metrics were anomalous under "
                f"anomaly_policy=skip ({sentinel.last_reason})",
                file=sys.stderr, flush=True,
            )
        else:
            # a second (force-kill) signal waits until the final write
            # has landed and verified
            with shutdown.defer():
                final_path = ckpt_save(state, config, healthy=sentinel.healthy)
                if async_writer:
                    async_writer.flush()
        if shutdown.stop_requested:
            print(
                f"sat_tpu_torch: stopped on {shutdown.signal_name} at step {step}; final "
                "checkpoint flushed — relaunch with --load to resume",
                file=sys.stderr, flush=True,
            )
    if final_path is not None:
        ok, reason = lineage.verify_checkpoint(final_path)
        if not ok:
            raise CheckpointWriteError(f"final checkpoint {final_path} did not land: {reason}")
    return state


def _restore_last_good(state: TrainState, config: Config, step: int) -> Optional[TrainState]:
    """Sentinel rollback: the newest verifiable ``LAST_GOOD`` checkpoint
    loaded into the (poisoned) state, keeping the loop's step, so the
    loader moves past the poison step instead of replaying it (the same
    masks would reproduce the same divergence).  None when nothing
    verifiable exists."""
    path = lineage.last_good_checkpoint(config.save_dir)
    if path is None:
        print(
            "sat_tpu_torch: rollback requested but save_dir holds no verifiable LAST_GOOD "
            f"checkpoint ({config.save_dir})",
            file=sys.stderr, flush=True,
        )
        return None
    restored, count = restore_checkpoint(state, model_file=path)
    if count == 0:
        print(f"sat_tpu_torch: rollback restore from {path} loaded 0 tensors", file=sys.stderr, flush=True)
        return None
    print(
        f"sat_tpu_torch: rolled back to {path} (step {restored.step}); resuming forward at "
        f"step {step}, skipping the poison window",
        file=sys.stderr, flush=True,
    )
    return restored._replace(step=step)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def _eos_id(vocabulary: Vocabulary) -> int:
    """Vocabulary index of the '.' terminator."""
    return vocabulary.word2idx["."]


@torch.inference_mode()
def decode_batch(
    params: Dict[str, Any],
    config: Config,
    images: torch.Tensor,
    eos_id: int,
    valid_size: int,
    return_alphas: bool = False,
) -> BeamResult:
    """One batch [B, S, S, 3] on the params' device: encode, then the
    monolithic beam search at ``config.beam_size``.  ``params`` is the
    :func:`compute_params` copy."""
    contexts = encode(params, config, images)
    return beam_search(
        params["decoder"], config, contexts, eos_id,
        beam_size=config.beam_size, valid_size=valid_size, return_alphas=return_alphas,
    )


def decode_dataset(
    config: Config,
    state: ServingState,
    dataset: DataSet,
    vocabulary: Vocabulary,
    device=None,
) -> List[Dict[str, Any]]:
    """Beam-search every image; returns [{image_id, image_file, caption,
    prob}] (plus 'words' and 'alphas' [len, N] with
    ``save_attention_maps``), with last-batch padding dropped and each
    image id kept once."""
    check_ported(config)
    dev = resolve_device(device)
    params = compute_params(to_device(state.params, dev), config, to_device(state.batch_stats, dev))
    eos = _eos_id(vocabulary)
    valid_size = len(vocabulary.words)

    results: List[Dict[str, Any]] = []
    seen = set()
    emitted = 0

    def drain(out: BeamResult, files) -> None:
        nonlocal emitted
        words = out.words[:, 0].cpu().numpy()          # best caption per image
        lengths = out.lengths[:, 0].cpu().numpy()
        scores = out.log_scores[:, 0].cpu().numpy()
        alphas = out.alphas[:, 0].cpu().numpy() if out.alphas is not None else None
        for i, image_file in enumerate(files):
            if emitted >= dataset.count:                # fake_count padding
                break
            # eval/test DataSets are unshuffled: batch order is image_ids order
            image_id = int(dataset.image_ids[emitted])
            emitted += 1
            if image_id in seen:
                continue
            seen.add(image_id)
            length = max(1, int(lengths[i]))
            row = {
                "image_id": image_id,
                "image_file": str(image_file),
                "caption": vocabulary.get_sentence(words[i, :length]),
                "prob": float(np.exp(scores[i])),
            }
            if alphas is not None:
                row["words"] = [vocabulary.words[w] for w in words[i, :length]]
                row["alphas"] = alphas[i, :length]      # [len, N]
            results.append(row)

    # batch n+1 is dispatched before batch n is drained
    prev: Optional[Tuple[BeamResult, List[str]]] = None
    feed = device_prefetch(make_loader(config, dataset), dev)
    try:
        for batch in track(feed, dataset.num_batches, desc="decode"):
            out = decode_batch(
                params, config, batch["images"], eos, valid_size,
                return_alphas=config.save_attention_maps,
            )
            if prev is not None:
                drain(*prev)
            prev = (out, batch["files"])
    finally:
        feed.close()
    if prev is not None:
        drain(*prev)
    return results


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------


def _render_attention_panel(
    image_file: str,
    words: List[str],
    alphas: np.ndarray,
    out_file: str,
) -> None:
    """Per-word attention figure: the image, then one tile per generated
    word with its soft-attention map α upsampled from the context grid
    and overlaid.  alphas: [len(words), N], N a square grid (196 → 14×14).
    Composited with cv2, as the JAX package does."""
    import cv2

    bgr = cv2.imread(image_file, cv2.IMREAD_COLOR)
    if bgr is None:
        raise FileNotFoundError(image_file)
    h, w = bgr.shape[:2]
    tile_w = max(180, min(w, 360))
    tile_h = int(round(tile_w * h / w))
    base = cv2.resize(bgr, (tile_w, tile_h), interpolation=cv2.INTER_AREA)
    g = int(round(np.sqrt(alphas.shape[1])))
    # one shared color scale across the caption: per-tile autoscaling
    # would stretch a near-uniform map to the contrast of a peaked one
    vmax = float(alphas.max()) or 1.0

    label_h = 22
    pad = 6

    def tile(image, label):
        canvas = np.full((label_h + tile_h, tile_w, 3), 255, dtype=np.uint8)
        cv2.putText(
            canvas, label[:24], (4, label_h - 7),
            cv2.FONT_HERSHEY_SIMPLEX, 0.45, (0, 0, 0), 1, cv2.LINE_AA,
        )
        canvas[label_h:, :, :] = image
        return canvas

    tiles = [tile(base, "input")]
    for t, word in enumerate(words):
        amap = cv2.resize(
            alphas[t].reshape(g, g).astype(np.float32), (tile_w, tile_h),
            interpolation=cv2.INTER_CUBIC,
        )
        amap_u8 = np.clip(amap / vmax * 255.0, 0.0, 255.0).astype(np.uint8)
        heat = cv2.applyColorMap(amap_u8, cv2.COLORMAP_JET)
        blend = cv2.addWeighted(base, 0.4, heat, 0.6, 0.0)
        tiles.append(tile(blend, word))

    cols = min(5, len(tiles))
    rows = -(-len(tiles) // cols)
    cell_h, cell_w = tiles[0].shape[:2]
    panel = np.full(
        (rows * (cell_h + pad) + pad, cols * (cell_w + pad) + pad, 3),
        255, dtype=np.uint8,
    )
    for idx, t_img in enumerate(tiles):
        r, c = divmod(idx, cols)
        y = pad + r * (cell_h + pad)
        x = pad + c * (cell_w + pad)
        panel[y:y + cell_h, x:x + cell_w] = t_img
    cv2.imwrite(out_file, panel)


def _save_attention_panels(results: List[Dict[str, Any]], out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for r in results:
        if "alphas" not in r:
            continue
        stem = os.path.splitext(os.path.basename(r["image_file"]))[0]
        _render_attention_panel(
            r["image_file"], r["words"], r["alphas"],
            os.path.join(out_dir, f"{stem}_attention.jpg"),
        )


def _export_attention_artifacts(results: List[Dict[str, Any]], out_dir: str) -> None:
    """attn.jsonl (per-caption alpha grids with entropy and coverage
    statistics) and the HTML contact sheet, next to the panels."""
    from .telemetry import exporters

    os.makedirs(out_dir, exist_ok=True)
    n = exporters.export_attention_jsonl(results, os.path.join(out_dir, "attn.jsonl"))
    sheet = exporters.render_attention_sheet(results, os.path.join(out_dir, "attn.html"))
    if n:
        print(
            f"attention introspection: {n} captions -> "
            f"{os.path.join(out_dir, 'attn.jsonl')}"
            + (f", contact sheet {sheet}" if sheet else "")
        )


def _render_caption_images(results: List[Dict[str, Any]], out_dir: str) -> None:
    for r in results:
        stem = os.path.splitext(os.path.basename(r["image_file"]))[0]
        _render_caption_image(
            r["image_file"], r["caption"], os.path.join(out_dir, f"{stem}_result.jpg")
        )


def _render_caption_image(image_file: str, caption: str, out_file: str) -> None:
    """Captioned JPEG: the caption in a banner above the image, with cv2."""
    import cv2

    img = cv2.imread(image_file, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(image_file)
    h, w = img.shape[:2]
    out_w = max(320, min(w, 640))
    out_h = int(round(out_w * h / w))
    img = cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_AREA)

    # wrap the caption into lines that fit the banner
    font, scale, thick = cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1
    lines, cur = [], ""
    for word in caption.split():
        cand = (cur + " " + word).strip()
        if cv2.getTextSize(cand, font, scale, thick)[0][0] > out_w - 12 and cur:
            lines.append(cur)
            cur = word
        else:
            cur = cand
    if cur:
        lines.append(cur)

    line_h = 20
    banner_h = 8 + line_h * max(1, len(lines))
    canvas = np.full((banner_h + out_h, out_w, 3), 255, dtype=np.uint8)
    for k, line in enumerate(lines):
        cv2.putText(
            canvas, line, (6, 8 + line_h * k + 12),
            font, scale, (0, 0, 0), thick, cv2.LINE_AA,
        )
    canvas[banner_h:, :, :] = img
    cv2.imwrite(out_file, canvas)


# ---------------------------------------------------------------------------
# eval
# ---------------------------------------------------------------------------


def evaluate(
    config: Config,
    state: Optional[ServingState] = None,
    model_file: Optional[str] = None,
    prepared: Optional[Tuple[Any, DataSet, Vocabulary]] = None,
    device=None,
) -> Dict[str, float]:
    """Scored beam-search decoding over the eval split: results.json and
    BLEU-1..4 / METEOR / ROUGE_L / CIDEr.

    ``prepared``: an existing ``(coco, dataset, vocabulary)`` from
    :func:`prepare_eval_data`, so a sweep reads the captions once."""
    check_ported(config)
    dev = resolve_device(device)
    coco, dataset, vocabulary = prepared or prepare_eval_data(config)
    if state is None:
        state = setup_state(config, load=True, model_file=model_file, device=dev)

    results = decode_dataset(config, state, dataset, vocabulary, device=dev)
    payload = [{"image_id": r["image_id"], "caption": r["caption"]} for r in results]
    atomic_write(config.eval_result_file, "w", lambda f: json.dump(payload, f))

    if config.save_eval_result_as_image:
        os.makedirs(config.eval_result_dir, exist_ok=True)
        _render_caption_images(results, config.eval_result_dir)
    if config.save_attention_maps:
        _save_attention_panels(results, config.eval_result_dir)
        _export_attention_artifacts(results, config.eval_result_dir)

    coco_res = coco.load_results(payload)
    return CocoEvalCap(coco, coco_res, eval_data=dataset).evaluate()


def evaluate_sweep(config: Config, device=None) -> Dict[int, Dict[str, float]]:
    """Score every checkpoint under save_dir, in-process: the eval split is
    prepared once.  Writes ``<step>.txt`` score dumps next to the
    checkpoints and returns {step: scores}."""
    check_ported(config)
    dev = resolve_device(device)
    prepared = prepare_eval_data(config)
    sweep: Dict[int, Dict[str, float]] = {}
    for step in lineage.checkpoint_steps(config.save_dir):
        path = os.path.join(config.save_dir, f"{step}.npz")
        state = state_from_flat(load_flat(path), config, dev, path)
        scores = evaluate(config, state=state, prepared=prepared, device=dev)
        sweep[step] = scores
        atomic_write(
            os.path.join(config.save_dir, f"{step}.txt"),
            "w",
            lambda f: f.writelines(f"{k}: {v:.4f}\n" for k, v in scores.items()),
        )
    return sweep


# ---------------------------------------------------------------------------
# test
# ---------------------------------------------------------------------------


def test(
    config: Config,
    state: Optional[ServingState] = None,
    model_file: Optional[str] = None,
    device=None,
) -> List[Dict[str, Any]]:
    """Caption every JPEG of ``test_image_dir``: captioned JPEGs and
    results.csv."""
    check_ported(config)
    dev = resolve_device(device)
    dataset, vocabulary = prepare_test_data(config)
    if dataset.count == 0:
        print(f"no images found in {config.test_image_dir}")
        return []
    if state is None:
        state = setup_state(config, load=True, model_file=model_file, device=dev)

    results = decode_dataset(config, state, dataset, vocabulary, device=dev)

    os.makedirs(config.test_result_dir, exist_ok=True)
    _render_caption_images(results, config.test_result_dir)
    if config.save_attention_maps:
        _save_attention_panels(results, config.test_result_dir)
        _export_attention_artifacts(results, config.test_result_dir)

    import pandas as pd

    pd.DataFrame(
        {
            "image_files": [r["image_file"] for r in results],
            "caption": [r["caption"] for r in results],
            "prob": [r["prob"] for r in results],
        }
    ).to_csv(config.test_result_file)
    return results
