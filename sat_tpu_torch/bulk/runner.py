"""``--phase bulk``: corpus → stepped decode → sharded JSONL — the port of
``sat_tpu.bulk.runner``.

A crash-only offline workload made of existing parts:

* corpus walk + shard plan (:mod:`.corpus`) — pure functions of the
  input, never of device count or restart history;
* the serve engine's params (lineage load) and the slot pool's
  continuous stepped decode (``serve.slot_pool``, whose attention step
  is the CUDA ``fused_attend`` masked body on the card), embedded
  headless — no HTTP;
* the quarantine (``resilience.quarantine``) and, when one resolves, the
  shard cache with its crc32c row integrity: poison images are ledgered
  and deterministically substituted within their output shard, never
  fatal below the systemic ceiling (``SystemicCorruption``, exit 87);
* durable output (:mod:`.writer`) + the resume manifest
  (:mod:`.manifest`): kill the process anywhere and relaunch — completed
  shards are verified and skipped, the interrupted shard is re-decoded
  from its first row, and the final output files are bitwise those of
  an uninterrupted run;
* observability: ``bulk/*`` gauges (images done, captions/s, ETA,
  quarantined count, decode steps, device-ms per image) on the
  heartbeat, and the watchdog's phase guards over assembly, decode and
  write.

Bitwise resume rests on a deterministic decode schedule: the pool is
empty at each shard's start (every row is harvested before
``_decode_shard`` returns), ``admit`` fills the smallest free slots
first, and the window depth depends only on the rows not yet
submitted, so a re-decoded shard repeats the same encodes and windows.
Nothing on this path sets ``torch.backends.cudnn.benchmark``, so a new
process picks the same cuDNN algorithms for the same shapes.

With ``serve_quality="on"`` each row also carries its ``quality``
signals (margin, normalized log-prob, unk rate, coverage deviation),
host arithmetic on the drained harvest rounded to 6 places, so the
output stays bitwise deterministic.

Handled differently from the JAX package: the port compiles nothing, so
there is no compile listener and no ``bulk/steady_compiles`` gauge;
``--blackbox`` is refused here (the flight recorder is wired into serve
alone so far); ``--supervise`` is refused by the CLI.
"""

from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import telemetry
from ..config import Config
from ..data.images import ILSVRC_2012_MEAN, ImageLoader
from ..data.shards import resolve_shard_cache
from ..data.vocabulary import Vocabulary
from ..device import resolve_device
from ..resilience.faultinject import FaultPlan
from ..resilience.preempt import GracefulShutdown
from ..resilience.quarantine import QuarantineManager, SystemicCorruption, ledger_path_for
from ..resilience.watchdog import Watchdog, deadlines_from_config
from ..serve.batcher import choose_decode_depth
from ..serve.engine import ServeEngine, load_serving_state
from ..serve.slot_pool import PagedSlotPool
from ..telemetry.heartbeat import Heartbeat
from ..telemetry.metering import measured_busy_ms
from ..telemetry.quality import extract_signals
from .corpus import plan_shards, resolve_corpus
from .manifest import (
    corpus_fingerprint,
    load_manifest,
    manifest_path_for,
    mark_completed,
    new_manifest,
    write_manifest,
)
from .writer import ShardWriter, verify_shard


def _log(msg: str) -> None:
    print(f"sat_tpu_torch: {msg}", file=sys.stderr, flush=True)


def _assemble_rows(
    shard_files: List[str],
    loader: ImageLoader,
    cache,
    quarantine: QuarantineManager,
    num_workers: int,
) -> Tuple[np.ndarray, Dict[int, dict]]:
    """Decode one output shard's images into a [n, S, S, 3] batch in the
    engine's input dtype, containing poison rows as the ``PrefetchLoader``
    does: ledger each newly bad row, then overwrite it with a
    deterministically chosen healthy row OF THE SAME OUTPUT SHARD.
    Keying the substitution to the shard, not to the pool geometry or the
    admission timing, keeps it stable across restarts.

    Returns ``(batch, meta)``: ``meta[i]`` marks a substituted row for the
    writer.  The marker omits the detection reason: a first run sees
    ``decode_failed`` where a resumed run sees ``replayed_ledger`` for the
    same file, and the output bytes must not depend on which run wrote
    them."""
    n = len(shard_files)
    q = quarantine
    q.note_rows(n)
    bad: List[tuple] = []  # (row, file, reason, exc)
    flagged: set = set()
    # files the ledger names are substituted without a decode: a file
    # repaired since must not change a replay
    for i, f in enumerate(shard_files):
        if q.known_bad_file(f):
            bad.append((i, f, "replayed_ledger", None))
            flagged.add(i)
    if cache is not None:
        gather_bad: List[tuple] = []
        raw = cache.gather(shard_files, fallback=loader.load_raw, bad_rows=gather_bad)
        for i, f, reason, exc in gather_bad:
            if i not in flagged:
                bad.append((i, f, reason, exc))
                flagged.add(i)
    else:
        raw = np.zeros((n, loader.size, loader.size, 3), np.uint8)

        def load_one(i):
            if i in flagged:
                return i, None, None
            try:
                return i, loader.load_raw(shard_files[i]), None
            except Exception as e:  # quarantined below
                return i, None, e

        with ThreadPoolExecutor(max_workers=max(1, num_workers)) as tp:
            for i, img, exc in tp.map(load_one, range(n)):
                if img is not None:
                    raw[i] = img
                elif exc is not None:
                    bad.append((i, shard_files[i], "decode_failed", exc))
                    flagged.add(i)
    meta: Dict[int, dict] = {}
    if bad:
        bad_set = {b[0] for b in bad}
        healthy = [i for i in range(n) if i not in bad_set]
        for i, f, reason, exc in sorted(bad, key=lambda b: b[0]):
            if reason != "replayed_ledger":
                q.quarantine(f, reason, kind="image", exc=exc)  # may raise SystemicCorruption
            if not healthy:
                raise SystemicCorruption(
                    f"every row of output shard holding {f!r} is quarantined — no "
                    "healthy row to substitute; the corpus is systemically corrupt"
                )
            j = healthy[QuarantineManager.substitute_index(f"image:{f}", len(healthy))]
            raw[i] = raw[j]
            meta[i] = {"quarantined": True, "substituted_from": shard_files[j]}
    # elementwise the same op the live path applies per image
    batch = raw if loader.raw else raw.astype(np.float32) - ILSVRC_2012_MEAN
    return batch, meta


def _decode_shard(
    engine: ServeEngine,
    pool: PagedSlotPool,
    batch: np.ndarray,
    fp: FaultPlan,
    wd: Watchdog,
    step_counter: int,
) -> Tuple[List[Any], List[Any], int]:
    """One assembled shard through the continuous stepped decode: admit
    rows as slots free, run one fused window over the whole pool, drain
    the [S] done flags to the host and harvest finished rows there.  The
    window depth follows the serve loop's policy
    (``batcher.choose_decode_depth``): K=1 while shard rows wait for a
    slot, the deepest once all are submitted.  Returns each row's caption
    list and quality signals (None with the quality plane off), in row
    order, and the advanced decode-step counter, the clock of the fault
    hooks (``SAT_FI_DIE_AT_STEP`` counts decode steps across shards)."""
    want_quality = engine.config.serve_quality == "on"
    vocab_size = len(engine.vocabulary.words)
    n = batch.shape[0]
    results: List[Any] = [None] * n
    quality_rows: List[Any] = [None] * n
    submitted = harvested = 0
    while harvested < n:
        fp.maybe_kill(step_counter)
        fp.maybe_wedge(step_counter)
        fp.maybe_slow(step_counter)
        free = pool.free_count()
        if free and submitted < n:
            take = min(free, n - submitted)
            items = [(batch[i], i) for i in range(submitted, submitted + take)]
            with wd.phase("dispatch"):
                submitted += pool.admit(items)
        k = choose_decode_depth(pool.decode_depths, n - submitted, 0)
        with wd.phase("dispatch"):
            done, steps_run = pool.multi_step(k)
        done_host = done.cpu().numpy()
        step_counter += int(steps_run)
        if done_host.any():
            payloads, words, lengths, scores, _, alphas = pool.harvest(done_host)
            rows = engine.detok_rows((words, lengths, scores), len(payloads))
            for j, (payload, row) in enumerate(zip(payloads, rows)):
                results[payload] = row["captions"]
                if want_quality:
                    sig = extract_signals(
                        words[j], lengths[j], scores[j], vocab_size=vocab_size, eos_id=engine.eos_id,
                        alphas=None if alphas is None else alphas[j],
                    )
                    quality_rows[payload] = {
                        k: round(sig[k], 6)
                        for k in ("margin", "norm_logprob", "unk_rate", "coverage_dev")
                        if k in sig
                    }
                harvested += 1
    return results, quality_rows, step_counter


def run_bulk(config: Config, model_file: Optional[str] = None, device=None) -> int:
    """``python -m sat_tpu_torch.cli --phase bulk``: caption every image of
    ``bulk_input`` into ``bulk_output``; returns the exit code.  Runs on
    the card unless ``device="cpu"``."""
    if not config.bulk_output:
        raise ValueError("--bulk_output is required for --phase bulk")
    if config.blackbox:
        raise NotImplementedError("blackbox=True is not ported to sat_tpu_torch's bulk phase yet (serve only)")
    dev = resolve_device(device)
    files = resolve_corpus(config.bulk_input)
    shards = plan_shards(files, config.bulk_shard_rows)
    out_dir = config.bulk_output
    os.makedirs(out_dir, exist_ok=True)

    # ---- resume frontier: manifest + output-file verification --------
    mpath = manifest_path_for(out_dir)
    sha = corpus_fingerprint(files, config.bulk_shard_rows, config.image_size)
    manifest = load_manifest(mpath)
    if manifest is not None and manifest.get("corpus_sha") != sha:
        _log("bulk: corpus or shard geometry changed since the last run — restarting from an empty frontier")
        manifest = None
    if manifest is None:
        manifest = new_manifest(files, config.bulk_shard_rows, config.image_size)
    completed = manifest["completed"]
    for k in sorted(list(completed), key=int):
        entry = completed[k]
        if not verify_shard(
            os.path.join(out_dir, entry["file"]), expect_rows=entry["rows"], expect_crc=entry["crc32c"]
        ):
            _log(f"bulk: completed shard {k} failed verification — re-decoding")
            del completed[k]
    # a kill mid-shard leaves only a .tmp orphan; resume re-decodes that
    # shard from its first row, so the orphan is garbage
    for name in os.listdir(out_dir):
        if name.endswith(".jsonl.tmp"):
            os.unlink(os.path.join(out_dir, name))
    pending = [i for i in range(len(shards)) if str(i) not in completed]
    write_manifest(mpath, manifest)
    resumed_rows = sum(len(shards[i]) for i in range(len(shards)) if str(i) in completed)
    _log(
        f"bulk: {len(files)} images in {len(shards)} output shards of {config.bulk_shard_rows} "
        f"({len(shards) - len(pending)} already complete, {len(pending)} to decode) -> {out_dir}"
    )
    if not pending:
        _log("bulk: nothing to do — all output shards verified complete")
        return 0

    # ---- decode-plane boot (as serve.server.serve does) ---------------
    tel = telemetry.get()
    if not tel.enabled:
        # bulk always records: its progress gauges and the device-ms per
        # image ride the registry
        tel = telemetry.enable(capacity=config.telemetry_buffer)
    vocabulary = Vocabulary(config.vocabulary_size, config.vocabulary_file)
    state, source = load_serving_state(config, model_file=model_file, device=dev)
    engine = ServeEngine(config, state, vocabulary, device=dev, tel=tel)
    _log(f"bulk: captioning with params from {source} (step {engine.step}) on {dev}")
    pool = PagedSlotPool(engine, tel=tel)
    pool.warmup()

    quarantine = QuarantineManager(ledger_path_for(config), max_fraction=config.quarantine_max_fraction)
    cache = resolve_shard_cache(config, files)

    tdir = config.telemetry_dir or os.path.join(config.summary_dir, "telemetry")
    wd = Watchdog(
        deadlines_from_config(config),
        poll_s=config.watchdog_interval or 1.0,
        grace_s=config.watchdog_grace_s,
        dump_path=os.path.join(tdir, "watchdog_stacks.txt"),
    )
    hb = None
    if config.heartbeat_interval > 0:
        hb = Heartbeat(
            os.path.join(tdir, "heartbeat.json"), config.heartbeat_interval, tel,
            static={"phase": "bulk", "bulk_output": out_dir},
        )
        hb.start()
    if config.watchdog_interval > 0:
        wd.start()

    fp = FaultPlan.from_env()
    total = len(files)
    images_done = resumed_rows
    decoded_this_run = 0
    step_counter = 0
    t0 = time.perf_counter()

    def progress_gauges() -> None:
        elapsed = time.perf_counter() - t0
        rate = decoded_this_run / elapsed if elapsed > 0 else 0.0
        tel.gauge("bulk/images_done", images_done)
        tel.gauge("bulk/images_total", total)
        tel.gauge("bulk/shards_done", len(completed))
        tel.gauge("bulk/shards_total", len(shards))
        tel.gauge("bulk/captions_per_s", round(rate, 3))
        if rate > 0:
            tel.gauge("bulk/eta_s", round((total - images_done) / rate, 1))
        tel.gauge("bulk/quarantined", quarantine.total)
        # the fault clock, exported: a harness reads a control run's total
        # to aim SAT_FI_DIE_AT_STEP inside a shard
        tel.gauge("bulk/decode_steps", step_counter)
        # unit cost: measured device-busy ms (the BUSY_SPANS; bulk records
        # the pool's serve/encode windows) over images finished this run
        if decoded_this_run > 0:
            tel.gauge("bulk/device_ms_per_image", round(measured_busy_ms(tel) / decoded_this_run, 3))

    progress_gauges()
    interrupted = False
    try:
        with GracefulShutdown() as shutdown:
            for shard_idx in pending:
                if shutdown.stop_requested:
                    # graceful SIGTERM/SIGINT: stop at the shard boundary;
                    # the manifest records everything completed
                    interrupted = True
                    break
                shard_files = shards[shard_idx]
                with wd.phase("step"):
                    with wd.phase("data_wait"):
                        batch, meta = _assemble_rows(
                            shard_files, engine.loader, cache, quarantine, config.num_data_workers
                        )
                    results, qrows, step_counter = _decode_shard(engine, pool, batch, fp, wd, step_counter)
                    with wd.phase("checkpoint"):
                        writer = ShardWriter(out_dir, shard_idx)
                        try:
                            for i, f in enumerate(shard_files):
                                row = {"file": f, "captions": results[i]}
                                if qrows[i] is not None:
                                    row["quality"] = qrows[i]
                                row.update(meta.get(i, ()))
                                writer.write_row(row)
                            fname, rows, crc = writer.finish()
                        except BaseException:
                            writer.abort()
                            raise
                        mark_completed(manifest, shard_idx, fname, rows, crc)
                        write_manifest(mpath, manifest)
                images_done += len(shard_files)
                decoded_this_run += len(shard_files)
                progress_gauges()
    finally:
        if hb is not None:
            hb.stop()
        wd.stop()

    if interrupted:
        _log(
            f"bulk: drained at shard boundary on {shutdown.signal_name or 'signal'} — "
            f"{images_done}/{total} images captioned; relaunch to resume"
        )
        return 0
    elapsed = time.perf_counter() - t0
    rate = decoded_this_run / elapsed if elapsed > 0 else 0.0
    unit_ms = measured_busy_ms(tel) / decoded_this_run if decoded_this_run else 0.0
    _log(
        f"bulk: complete — {images_done}/{total} images in {len(shards)} shards "
        f"({decoded_this_run} decoded this run, {rate:.1f} captions/s, {unit_ms:.1f} "
        f"device-ms/image, {quarantine.total} quarantined)"
    )
    return 0
