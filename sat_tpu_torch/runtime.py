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

Observability, as in the JAX package: with ``telemetry`` the loops
record their phase spans (``train/data_wait|dispatch|log_sync|summary|
checkpoint``, ``decode/data_wait|dispatch|drain|batch``, the nested
``feed/device_put`` and ``ckpt/*``) and write ``trace*.json``,
``breakdown*.json`` and ``compile_report*.json`` at the end; train also
writes ``telemetry.jsonl`` at each log boundary (with the ``diag/*``
gauges of ``diag_level``), runs the heartbeat with the card's facts and
its allocator's bytes, the train SLOs, the ``/metrics`` listener of
``metrics_port`` and the ``SIGUSR2`` profiler trigger.  ``blackbox``
journals the loops into the flight recorder, and ``profile_dir`` opens a
torch.profiler window (:class:`ProfilerWindow`).  None of it adds a host
sync; a failure of any of it degrades to a warning.

Mesh and context-parallel runs (``mesh_shape``, ``context_parallel``)
run one process a mesh position under ``torchrun``
(``parallel``; :func:`mesh_for`): train on each rank's rows and blocks
with the gradients summed over the data group, eval and test decoding
each data rank's rows and assembling the results on every rank.  Rank 0
writes the results, summaries and checkpoints (the sharded leaves
gathered first, the writer synchronous); each rank keeps its own
telemetry directory (``<telemetry_dir>/rank<r>``: heartbeat, flight
recorder, traces), and ``fleet_telemetry`` merges the ranks' sidecars
into ``fleet.json`` in the shared telemetry directory.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import telemetry
from .config import Config
from .data.dataset import DataSet, prepare_eval_data, prepare_test_data, prepare_train_data
from .data.images import ImageLoader, PrefetchLoader
from .data.shards import resolve_shard_cache
from .data.vocabulary import Vocabulary, vocab_fingerprint
from .device import resolve_device
from .evalcap.eval import CocoEvalCap
from .models.captioner import encode, init_variables
from .ops.beam_search import BeamResult, beam_search
from .ops.fused_attend import fused_attend
from .resilience import lineage, retry
from .resilience.faultinject import FaultPlan
from .resilience.lineage import CheckpointWriteError
from .resilience.preempt import GracefulShutdown
from .resilience.quarantine import QuarantineManager, ledger_path_for
from .resilience.sentinel import AnomalySentinel
from .resilience.supervisor import RESTARTS_ENV
from .resilience.watchdog import Watchdog, deadlines_from_config
from .train.checkpoint import (
    AsyncCheckpointWriter, ServingState, apply_cnn_import, check_vocab, compute_params,
    import_reference_checkpoint, load_flat, restore_checkpoint, save_checkpoint, state_from_flat,
    take_elastic_restores, to_device, walk_back,
)
from .train.step import TrainState, create_train_state, make_train_step, step_generator
from .utils.fileio import atomic_write
from .utils.progress import Progress, track
from .utils.summary import SummaryWriter


def mesh_for(config: Config):
    """The mesh this launch runs ``config`` on (``parallel.mesh.Mesh``), or
    None for a plain single process with a one-device config.

    A ``mesh_shape`` of more than one position or a ``context_parallel``
    above 1 needs that many ranks (``torchrun``): in a single process it
    raises with the launch command, and a launch whose rank count differs
    from the mesh raises too.  There is no silent one-device run."""
    from .parallel.mesh import make_mesh, world_size

    if world_size() == 1 and int(np.prod(config.mesh_shape)) == 1 and config.context_parallel <= 1:
        return None
    mesh = make_mesh(config)
    if config.context_parallel > 1:
        from .parallel.context import validate_cp_mesh

        validate_cp_mesh(config, mesh)
    return mesh


def placement_config(config: Config) -> Config:
    """The config the placement rule reads: a context-parallel run spends
    the model axis on the context grid and keeps every leaf replicated
    (the vocab rule off), as the JAX package's ``placement_config``."""
    return config.replace(vocabulary_size=-1) if config.context_parallel > 1 else config


@contextlib.contextmanager
def _rank_zero_first(mesh, tag: str):
    """Rank 0 runs the block first (it writes the shared caches: the
    vocabulary, the annotation and data files), the other ranks after it
    (they read them)."""
    if mesh is None:
        yield
        return
    from .parallel.mesh import sync_processes

    if mesh.rank != 0:
        sync_processes(tag)
    yield
    if mesh.rank == 0:
        sync_processes(tag)


class _NullWriter:
    """The summary writer of a rank other than 0: writes nothing."""

    def __enter__(self) -> "_NullWriter":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def scalars(self, step, values) -> None:
        pass

    def variable_stats(self, step, params) -> None:
        pass


def _stop_agreed(mesh, requested: bool) -> bool:
    """Whether the loop stops at this step: this process's request alone,
    or on a mesh any rank's (one int over the CPU group every step)."""
    if mesh is None or mesh.host_group is None:
        return requested
    import torch.distributed as dist

    from .parallel.collectives import blocking

    flag = torch.tensor([int(requested)], dtype=torch.int32)
    with blocking():
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=mesh.host_group)
    return bool(flag.item())


def _fleet_gather(mesh, vec):
    """The fleet plane's transport: every rank's float64 row, over the CPU
    gloo group; None in a single process (the sidecar path is exact
    there) or when the gather fails (the plane then reads the sidecars)."""
    if mesh is None or mesh.host_group is None:
        return None
    import torch.distributed as dist

    from .parallel.collectives import blocking

    try:
        rows = [torch.zeros(len(vec), dtype=torch.float64) for _ in range(mesh.world)]
        with blocking():
            dist.all_gather(rows, torch.from_numpy(np.asarray(vec, np.float64)), group=mesh.host_group)
        return torch.stack(rows).numpy()
    except RuntimeError:
        return None


# ---------------------------------------------------------------------------
# input feed
# ---------------------------------------------------------------------------


# One QuarantineManager per ledger path, i.e. per run: the systemic-
# corruption ceiling is a run-level judgement, so the train and eval
# loaders of one run share the bookkeeping.
_QUARANTINES: Dict[str, QuarantineManager] = {}


def _quarantine_for(config: Config, mesh=None) -> QuarantineManager:
    path = ledger_path_for(config)
    q = _QUARANTINES.get(path)
    if q is None:
        # the ranks along a mesh's model axis feed the same rows: the
        # first of them writes the ledger, the others count alike
        appends = mesh is None or mesh.index("model") == 0
        q = QuarantineManager(path, max_fraction=config.quarantine_max_fraction, appends=appends)
        _QUARANTINES[path] = q
    return q


def make_loader(config: Config, dataset: DataSet, mesh=None) -> PrefetchLoader:
    """The host-side input pipeline of a dataset: the shard cache resolved
    per ``config.shard_cache`` (``data.shards``: build-or-load for "on",
    an existing valid cache for "auto", live JPEG decode when none), the
    prefetching loader ``prefetch_depth`` batches ahead, and the run's
    quarantine (on a ``mesh``, ledgered once across the ranks)."""
    return PrefetchLoader(
        dataset,
        ImageLoader(size=config.image_size, raw=config.device_preprocess),
        num_workers=config.num_data_workers,
        prefetch_depth=config.prefetch_depth,
        shard_cache=resolve_shard_cache(config, dataset.image_files),
        quarantine=_quarantine_for(config, mesh),
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
        # times only the enqueue of the copies; it runs inside the feed's
        # data wait, so the breakdown reports it as nested
        with telemetry.span("feed/device_put"):
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
# profiler window and telemetry wiring
# ---------------------------------------------------------------------------


def _start_trace(device):
    """Start a torch.profiler capture (CPU activity, and CUDA activity on
    a card); returns the running profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if getattr(device, "type", str(device)) == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_trace(prof, out_dir: str) -> None:
    """Stop the capture and write it as ``<out_dir>/trace.json``."""
    prof.__exit__(None, None, None)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def _sync(target) -> None:
    """Wait for the device work behind ``target`` (a tensor) to finish."""
    if isinstance(target, torch.Tensor) and target.device.type == "cuda":
        torch.cuda.synchronize(target.device)


class ProfilerWindow:
    """The step loops' trace window on ``torch.profiler``, with the JAX
    package's contract: open once at step >= ``profile_start_step``
    (resume-aware), capture ``profile_num_steps`` steps, wait for the last
    step's device work before stopping, and close on loop exit.  Decode
    loops pass ``max_start`` (their batch count - 1) so a short eval still
    traces.  Each window writes ``<profile_dir>/<stamp>/trace.json``; a
    sweep builds a fresh window per decode, and a closed window never
    opens again.  The ranks of a launch write under ``profile_dir/rank<r>``.

    Starting while another capture is live (a ``/profile`` or ``SIGUSR2``
    window, an outer profiler) raises in torch: the window marks itself
    fired first, so the open is never retried, and degrades to a warning
    without ever stopping the other capture."""

    def __init__(self, config: Config, max_start: Optional[int] = None, device=None) -> None:
        from .telemetry import process_identity

        index, count = process_identity()
        # the ranks of a launch share profile_dir: each writes under its own
        self._dir = os.path.join(config.profile_dir, f"rank{index}") if config.profile_dir and count > 1 \
            else config.profile_dir
        self._device = device
        self._start = config.profile_start_step
        if max_start is not None:
            self._start = min(self._start, max(max_start, 0))
        self._num = max(config.profile_num_steps, 1)
        self._on = False
        self._fired = False
        self._stop_at = -1
        self._last_sync = None
        self._prof = None
        self._out = ""

    def before_step(self, i: int) -> None:
        """Call before dispatching step ``i``; opens the window once."""
        if self._dir and not self._fired and i >= self._start:
            self._fired = True
            self._stop_at = i + self._num
            try:
                os.makedirs(self._dir, exist_ok=True)
                self._out = tempfile.mkdtemp(prefix=time.strftime("%Y%m%d-%H%M%S-"), dir=self._dir)
                self._prof = _start_trace(self._device)
            except Exception as e:
                print(
                    f"sat_tpu_torch: profiler window skipped — start_trace failed "
                    f"(another trace active?): {e}",
                    file=sys.stderr, flush=True,
                )
                return
            self._on = True

    def _stop(self) -> None:
        """Close the capture this window opened; a stop failure degrades to
        a warning but still marks the window closed."""
        try:
            _stop_trace(self._prof, self._out)
        except Exception as e:
            print(f"sat_tpu_torch: profiler stop_trace failed ({e})", file=sys.stderr, flush=True)
        self._on = False
        self._prof = None
        self._last_sync = None

    def after_step(self, i: int, sync) -> None:
        """Call after dispatching step ``i``; closes the window once the
        configured step count is captured, after ``sync``'s work."""
        self._last_sync = sync
        if self._on and i + 1 >= self._stop_at:
            _sync(sync)  # the window's close only
            self._stop()

    def __enter__(self) -> "ProfilerWindow":
        return self

    def __exit__(self, *exc) -> None:
        """Idempotent stop on loop exit (inside the window, or on an error)."""
        if self._on:
            if self._last_sync is not None:
                try:
                    _sync(self._last_sync)
                except Exception:
                    pass  # the sync target may be poisoned on the error path
            self._stop()
        self._last_sync = None


# train-loop phase decomposition: disjoint sub-intervals of "train/step"
# (their totals plus the "other" residual reconstruct measured wall time)
# and the nested spans that occur inside a phase (reported, not summed)
_TRAIN_PHASES = (
    "train/data_wait", "train/dispatch", "train/log_sync",
    "train/summary", "train/checkpoint",
)
_TRAIN_NESTED = ("feed/device_put", "ckpt/write", "ckpt/snapshot")
_DECODE_PHASES = ("decode/data_wait", "decode/dispatch", "decode/drain")
_DECODE_NESTED = ("feed/device_put",)


def _timed_iter(it, tel, name: str):
    """Yield from ``it``, recording each ``next()`` wait as a ``name``
    span: the feed-starvation phase of the consuming loop."""
    it = iter(it)
    while True:
        t0 = time.perf_counter_ns()
        try:
            item = next(it)
        except StopIteration:
            return
        tel.record(name, t0, time.perf_counter_ns() - t0)
        yield item


def _telemetry_dir(config: Config) -> str:
    """This process's telemetry directory: ``telemetry_dir`` (default
    ``<summary_dir>/telemetry``), and under a launch of several ranks its
    ``rank<r>`` subdirectory, so the ranks' heartbeats, traces and flight
    recorders never collide."""
    from .telemetry import process_identity

    base = _telemetry_base(config)
    index, count = process_identity()
    return os.path.join(base, f"rank{index}") if count > 1 else base


def _telemetry_base(config: Config) -> str:
    return config.telemetry_dir or os.path.join(config.summary_dir, "telemetry")


def _fleet_dir(config: Config) -> str:
    """The directory the ranks share for the fleet sidecars and
    ``fleet.json``: ``fleet_dir``, else the run's telemetry directory
    above the ranks' own."""
    return config.fleet_dir or _telemetry_base(config)


def _telemetry_begin(config: Config):
    """With ``telemetry`` on: fresh buffers for the run and a fresh compile
    report.  Off: the registry as the caller left it (the null object
    unless a caller enabled one, as bulk's and serve's do); the run
    writes no telemetry artifact either way."""
    if not config.telemetry:
        return telemetry.get()
    from .telemetry import compile_report

    tel = telemetry.enable(config.telemetry_buffer)
    compile_report.reset()
    return tel


def _device_static(device) -> dict:
    """Heartbeat ``static`` device facts: the backend, the device's kind
    and platform (the card's name on a card), this rank and the world
    size, and under a launch of several ranks the collectives' backend
    and whether the host's one card is shared."""
    from .parallel.mesh import boot_info
    from .telemetry import process_identity

    cuda = device.type == "cuda"
    index, count = process_identity()
    static = {
        "backend": device.type,
        "num_devices": torch.cuda.device_count() if cuda else 1,
        "process_index": index,
        "process_count": count,
        "device_kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "device_platform": "gpu" if cuda else "cpu",
    }
    boot = boot_info()
    if boot:
        static["collective_backend"] = boot["backend"]
        static["local_world_size"] = boot["local_world"]
        static["shared_card"] = bool(cuda and boot["backend"] == "gloo" and boot["local_world"] > 1)
    return static


def _device_memory_sampler(device):
    """Heartbeat sampler: the card's allocated bytes
    (``torch.cuda.memory_stats``, a host-side read) under
    ``hbm_bytes_in_use``; nothing on the CPU."""

    def sample() -> dict:
        if device.type != "cuda":
            return {}
        stats = torch.cuda.memory_stats(device)
        index = device.index if device.index is not None else torch.cuda.current_device()
        return {"hbm_bytes_in_use": {str(index): int(stats.get("allocated_bytes.all.current", 0))}}

    return sample


def _telemetry_finish(tel, config: Config, phase: str) -> None:
    """End-of-run exports: the Chrome trace, the per-phase step-time
    breakdown (printed and saved) and the compile report."""
    from .telemetry import compile_report, exporters

    tdir = _telemetry_dir(config)
    trace_path = config.trace_export or os.path.join(
        tdir, "trace.json" if phase == "train" else f"trace-{phase}.json"
    )
    exporters.export_chrome_trace(tel, trace_path)
    step_span, phases, nested = (
        ("train/step", _TRAIN_PHASES, _TRAIN_NESTED)
        if phase == "train"
        else ("decode/batch", _DECODE_PHASES, _DECODE_NESTED)
    )
    report = exporters.step_breakdown(tel, step_span, phases, nested)
    if report is not None:
        print(exporters.format_breakdown(report), flush=True)
        exporters.save_breakdown(
            report,
            os.path.join(tdir, "breakdown.json" if phase == "train" else f"breakdown-{phase}.json"),
        )
    summary = compile_report.format_summary()
    if summary is not None:
        print(summary, flush=True)
        compile_report.write_report(
            os.path.join(tdir, "compile_report.json" if phase == "train" else f"compile_report-{phase}.json")
        )


def _install_blackbox(config: Config, tel, event: str, **fields):
    """The flight recorder of ``blackbox``: a ring under
    ``<telemetry_dir>/blackbox``, installed as the process's postmortem
    source; None when off."""
    if not config.blackbox:
        return None
    from .telemetry import blackbox

    tdir = _telemetry_dir(config)
    bb = blackbox.BlackBox(os.path.join(tdir, "blackbox"), tel)
    blackbox.install(
        bb, telemetry_dir=tdir, config_snapshot=config.to_dict(), quarantine_ledger=ledger_path_for(config),
        fleet_dir=_fleet_dir(config) if config.fleet_telemetry else "",
    )
    bb.event(event, **fields)
    return bb


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
    mesh = mesh_for(config)
    dev = resolve_device(device)
    if seed is None:
        seed = config.seed
    if dataset is None:
        with _rank_zero_first(mesh, "prepare_train_data"):
            dataset = prepare_train_data(config if seed == config.seed else config.replace(seed=seed))
    if dataset.count == 0:
        raise ValueError(
            "training dataset is empty after preparation — every caption was filtered out "
            "(max_caption_length and vocabulary filters) or the caption file has none"
        )
    if state is None:
        state = setup_train_state(config, seed=seed, device=dev)
    if mesh is not None:
        from .parallel.data import mesh_data_shard, process_local_dataset
        from .parallel.mesh import sync_processes
        from .parallel.sharding import shard_train_state

        # this rank's blocks of the vocab-sharded leaves (a context-parallel
        # run keeps every leaf replicated), and its rows of each batch
        sync_processes("shard_state")
        state = shard_train_state(state, placement_config(config), mesh)
        dataset = process_local_dataset(dataset, *mesh_data_shard(mesh))
    from .parallel.collectives import blocked_ns

    train_step = make_train_step(config, mesh)
    loader = make_loader(config, dataset, mesh)
    retry.configure(config.io_retries, config.io_retry_base_s)
    sentinel = AnomalySentinel(config.anomaly_policy, config.anomaly_spike_factor)
    plan = FaultPlan.from_env()
    # a mesh writes synchronously: the save gathers the sharded leaves in
    # line with the step stream and rank 0 writes
    async_writer = AsyncCheckpointWriter() if config.async_checkpoint and mesh is None else None
    ckpt_save = async_writer.save if async_writer else functools.partial(save_checkpoint, mesh=mesh)
    primary = mesh is None or mesh.rank == 0
    # fresh ring buffers with telemetry on, the null object otherwise
    elastic = take_elastic_restores()
    tel = _telemetry_begin(config)
    if config.telemetry and elastic:
        tel.count("ckpt/elastic_restores", elastic)  # the --load before this run
    # incarnation number under --supervise (the supervisor exports it)
    tel.gauge("supervisor/restarts", int(os.environ.get(RESTARTS_ENV, "0") or 0))
    tdir = _telemetry_dir(config)
    wd = Watchdog(
        deadlines_from_config(config),
        poll_s=config.watchdog_interval or 1.0,
        grace_s=config.watchdog_grace_s,
        dump_path=os.path.join(tdir, "watchdog_stacks.txt"),
        pre_abort=async_writer.flush if async_writer else None,
        tel=tel,
    )
    step = state.step
    stopped = False
    probed = False  # the train step's compile report, on its first call
    final_path: Optional[str] = None
    profile_trigger = profile_latch = bb = fleet_plane = None
    # the ExitStack drains the async writer last (after the summary writer
    # closes), on success and on exception alike; rank 0 alone writes the
    # summaries of a mesh
    with contextlib.ExitStack() as stack, (SummaryWriter(config.summary_dir) if primary else _NullWriter()) \
            as writer, GracefulShutdown() as shutdown:
        if config.telemetry:
            # LIFO: the exports run last, after the heartbeat's final beat
            stack.callback(_telemetry_finish, tel, config, "train")
            hb = None
            if config.heartbeat_interval > 0:
                from .telemetry.heartbeat import Heartbeat

                hb = Heartbeat(
                    os.path.join(tdir, "heartbeat.json"), config.heartbeat_interval, tel,
                    static={"phase": "train", **_device_static(dev)},
                    sampler=_device_memory_sampler(dev),
                )
                stack.callback(hb.stop)
                hb.start()
            if config.metrics_port > 0:
                # read-only scrape endpoint riding the heartbeat payload;
                # a bind failure degrades to a warning
                from .telemetry.promtext import MetricsListener

                ml = MetricsListener(
                    "127.0.0.1", config.metrics_port, tel,
                    payload_fn=hb.payload if hb is not None else None,
                )
                if ml.start():
                    stack.callback(ml.stop)
            from .telemetry.slo import SLOEngine, objectives_from_config

            objectives = objectives_from_config(config, "train")
            if objectives:
                engine = SLOEngine(
                    tel, objectives, jsonl_path=os.path.join(tdir, "slo.jsonl"),
                    cap_bytes=int(config.telemetry_log_cap_mb * 1e6),
                    fast_s=config.slo_window_fast_s, slow_s=config.slo_window_slow_s,
                ).start(interval_s=max(0.1, min(5.0, config.slo_window_fast_s / 4)))
                stack.callback(engine.stop)
            # SIGUSR2 → a bounded live profiler capture, drained at the log
            # boundary (signals are async, profiler starts are not)
            import signal

            from .telemetry.profwin import ProfileLatch, SignalTrigger

            profile_latch = ProfileLatch(tdir, device=dev)
            stack.callback(profile_latch.stop_now)
            profile_trigger = SignalTrigger()
            if hasattr(signal, "SIGUSR2"):
                profile_trigger.install(signal.SIGUSR2)
            if config.fleet_telemetry:
                # every rank writes heartbeat_p<rank>.json at the log
                # boundary; rank 0 merges them into fleet.json.  finish()
                # records the terminal step even when the loop dies
                # between boundaries
                from .parallel.mesh import world_size
                from .telemetry.fleet import FleetPlane

                fleet_plane = FleetPlane(
                    _fleet_dir(config), 0 if mesh is None else mesh.rank, world_size(), tel,
                    straggler_factor=config.straggler_factor,
                    history_cap_bytes=int(config.telemetry_log_cap_mb * 1e6),
                )
                stack.callback(fleet_plane.finish)
        # the flight recorder: abnormal exits (watchdog 86, corruption 87,
        # a sentinel rollback, an uncaught exception) dump a postmortem
        # bundle from it; the finalizer chain flushes it on teardown
        bb = _install_blackbox(config, tel, "train_start", step=step)
        if bb is not None:
            from .telemetry import blackbox

            stack.callback(blackbox.run_finalizers)
        if async_writer:
            stack.callback(async_writer.close)
        if config.watchdog_interval > 0:
            # stops before the writer drains, so a slow drain is no wedge
            stack.callback(wd.stop)
            wd.start()
        # resume-aware trace window; the ExitStack closes it on any exit
        prof = stack.enter_context(ProfilerWindow(config, device=dev))
        if mesh is not None:
            # realign the ranks before the first step's collectives: loader
            # start-up and the first step's allocations drift them apart
            sync_processes("first_step")
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
                step_t0 = time.perf_counter_ns()
                blocked_t0 = blocked_ns()
                try:
                    for batch in _timed_iter(_watched_iter(feed, wd, "data_wait"), tel, "train/data_wait"):
                        with wd.phase("step"):
                            if config.max_steps and step >= config.max_steps:
                                stopped = True
                                break
                            plan.maybe_kill(step)  # injected preemption (inert unarmed)
                            plan.maybe_wedge(step)  # injected silent hang
                            plan.maybe_slow(step)  # injected slow-but-alive step
                            # a signal reaches the ranks at different steps:
                            # they agree the stop, so all leave at one step
                            if _stop_agreed(mesh, shutdown.stop_requested):
                                stopped = True
                                break
                            prof.before_step(step)
                            generator = step_generator(seed, step, dev)
                            with tel.span("train/dispatch"), wd.phase("dispatch"):
                                if config.telemetry and not probed:
                                    from .telemetry import compile_report

                                    probed = True
                                    state, metrics = compile_report.probe(
                                        "train_step", train_step, state, batch, generator, tel=tel,
                                    )
                                else:
                                    state, metrics = train_step(state, batch, generator)
                            prof.after_step(step, metrics["total_loss"])
                            step += 1
                            tel.gauge("train/step", step)
                            # injected NaN update (inert unarmed): poisons params and metrics
                            state, metrics = plan.maybe_poison(step, state, metrics)
                            if step % config.log_every == 0:
                                with tel.span("train/log_sync"):
                                    host = _fetch(metrics)  # the loop's one host sync
                                writer.scalars(step, host)
                                if config.telemetry:
                                    _log_boundary(tel, config, host, step, profile_trigger, profile_latch)
                                if fleet_plane is not None:
                                    with tel.span("fleet/tick"):
                                        fleet_plane.tick(step, gather_fn=functools.partial(_fleet_gather, mesh))
                                if bb is not None:
                                    bb.journal(step)
                                if sentinel.check(step, host) == "rollback":
                                    if bb is not None:
                                        from .telemetry import blackbox

                                        bb.event("anomaly_rollback", step=step, reason=sentinel.last_reason)
                                        blackbox.dump(
                                            "anomaly_rollback", step=step, reason_detail=sentinel.last_reason,
                                        )
                                    rollback = True
                                    break
                            if config.var_summary_period and step % config.var_summary_period == 0:
                                with tel.span("train/summary"):
                                    writer.variable_stats(step, state.params)
                            if config.save_period and step % config.save_period == 0 and not sentinel.suppress_save:
                                with tel.span("train/checkpoint"), wd.phase("checkpoint"):
                                    ckpt_save(state, config, healthy=sentinel.healthy)
                            bar.update()
                            now = time.perf_counter_ns()
                            tel.record("train/step", step_t0, now - step_t0)
                            if fleet_plane is not None and mesh is not None:
                                # the rank's own time: the step less its waits on peers
                                blocked = blocked_ns()
                                fleet_plane.note_step(now - step_t0 - (blocked - blocked_t0))
                                blocked_t0 = blocked
                            step_t0 = now
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
                restored = _restore_last_good(state, config, step, mesh)
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
            if bb is not None:
                # the stop raced the final checkpoint: leave a bundle that
                # says whether the tail landed
                from .telemetry import blackbox

                bb.event("sigterm_stop", step=step, signal=shutdown.signal_name)
                blackbox.dump(
                    "sigterm_during_checkpoint", exit_code=0, step=step,
                    signal=shutdown.signal_name, final_checkpoint=final_path or "",
                )
    if final_path is not None and primary:
        ok, reason = lineage.verify_checkpoint(final_path)
        if not ok:
            raise CheckpointWriteError(f"final checkpoint {final_path} did not land: {reason}")
    return state


def _log_boundary(tel, config: Config, host: Dict[str, float], step: int, trigger, latch) -> None:
    """The log boundary's telemetry, from the metrics just fetched (no
    device read): the ``diag/*`` gauges, a ``telemetry.jsonl`` row, and a
    live profiler window when ``SIGUSR2`` arrived since the last one."""
    from .telemetry import exporters

    for k, v in host.items():
        if k.startswith("diag/"):
            tel.gauge(k, v)
    exporters.append_jsonl(
        tel, os.path.join(_telemetry_dir(config), "telemetry.jsonl"), step,
        cap_bytes=int(config.telemetry_log_cap_mb * 1e6),
    )
    if trigger is not None and trigger.pop():
        ok, info = latch.start(config.profile_window_ms)
        print(
            "sat_tpu_torch: live profiler window " + (f"-> {info}" if ok else f"refused ({info})"),
            file=sys.stderr, flush=True,
        )


def _restore_last_good(state: TrainState, config: Config, step: int, mesh=None) -> Optional[TrainState]:
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
    restored, count = restore_checkpoint(state, model_file=path, mesh=mesh, placement=placement_config(config))
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
    probe=None,
) -> BeamResult:
    """One batch [B, S, S, 3] on the params' device: encode, then the
    monolithic beam search at ``config.beam_size``.  ``params`` is the
    :func:`compute_params` copy.  ``probe`` (``compile_report.probe`` with
    the run's registry) takes the compile report's entries of this call,
    the kernel's FLOPs added from its shapes."""
    kwargs = dict(beam_size=config.beam_size, valid_size=valid_size, return_alphas=return_alphas)
    if probe is None:
        return beam_search(params["decoder"], config, encode(params, config, images), eos_id, **kwargs)
    contexts = probe("decode/encode", encode, params, config, images)
    B, N, D = contexts.shape
    launched = fused_attend.launches
    return probe(
        "decode/beam_search", beam_search, params["decoder"], config, contexts, eos_id,
        extra_flops=lambda: (fused_attend.launches - launched) * attend_flops(
            B * config.beam_size, N, config.dim_attend_layer, D),
        **kwargs,
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
    image id kept once.

    On a mesh (:func:`mesh_for`) each data rank decodes its rows of every
    batch (``parallel.train.mesh_decode_batch``: the kernel runs in every
    rank), the beam-0 words, lengths, scores and alphas of every rank are
    gathered over the CPU group at the end, and every rank returns the
    whole result list in dataset order."""
    mesh = mesh_for(config)
    dev = resolve_device(device)
    params = compute_params(to_device(state.params, dev), config, to_device(state.batch_stats, dev))
    eos = _eos_id(vocabulary)
    valid_size = len(vocabulary.words)
    feed_ds = dataset
    if mesh is not None:
        from .parallel.data import mesh_data_shard, process_local_dataset
        from .parallel.train import place_params

        if config.batch_size % mesh.size("data"):
            raise ValueError(
                f"batch_size={config.batch_size} not divisible by the data-axis size {mesh.size('data')} "
                "for mesh decoding"
            )
        # the vocab rule's blocks (a context-parallel run keeps every leaf
        # replicated); the feed keyed on the data axis
        params = place_params(params, config, mesh)
        feed_ds = process_local_dataset(dataset, *mesh_data_shard(mesh))

    results: List[Dict[str, Any]] = []
    gathered: List[Tuple[np.ndarray, ...]] = []
    seen = set()
    emitted = 0

    def drain(out: BeamResult, files) -> None:
        nonlocal emitted
        words = out.words[:, 0].cpu().numpy()          # best caption per image
        lengths = out.lengths[:, 0].cpu().numpy()
        scores = out.log_scores[:, 0].cpu().numpy()
        alphas = out.alphas[:, 0].cpu().numpy() if out.alphas is not None else None
        if mesh is not None:
            # this rank's block of the global batch; assembled after the loop
            gathered.append((words, lengths, scores) + (() if alphas is None else (alphas,)))
            return
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

    tel = _telemetry_begin(config)
    probe = None
    if config.telemetry:
        from .telemetry import compile_report

        probe = functools.partial(compile_report.probe, tel=tel)  # batch 0 only

    # the flight recorder journals each batch, so an exception mid-decode
    # still leaves a postmortem bundle through the CLI's handler
    bb = _install_blackbox(config, tel, "decode_start", batches=dataset.num_batches)
    # batch n+1 is dispatched before batch n is drained
    prev: Optional[Tuple[BeamResult, List[str]]] = None
    with contextlib.ExitStack() as stack:
        if config.telemetry:
            # LIFO: the exports run after the recorder's flush below
            stack.callback(_telemetry_finish, tel, config, "decode")
            if config.heartbeat_interval > 0:
                from .telemetry.heartbeat import Heartbeat

                hb = Heartbeat(
                    os.path.join(_telemetry_dir(config), "heartbeat.json"), config.heartbeat_interval, tel,
                    static={"phase": "decode", **_device_static(dev)}, sampler=_device_memory_sampler(dev),
                )
                stack.callback(hb.stop)
                hb.start()
        if bb is not None:
            from .telemetry import blackbox

            stack.callback(blackbox.run_finalizers)
        feed = device_prefetch(make_loader(config, feed_ds, mesh), dev)
        stack.callback(feed.close)
        prof = stack.enter_context(ProfilerWindow(config, max_start=dataset.num_batches - 1, device=dev))
        if mesh is not None:
            from .parallel.mesh import sync_processes

            # realign the ranks before the first decode's collectives
            sync_processes("first_decode")
        batch_t0 = time.perf_counter_ns()
        for b, batch in enumerate(track(_timed_iter(feed, tel, "decode/data_wait"), dataset.num_batches,
                                        desc="decode")):
            prof.before_step(b)
            with tel.span("decode/dispatch"):
                if mesh is None:
                    out = decode_batch(params, config, batch["images"], eos, valid_size,
                                       return_alphas=config.save_attention_maps, probe=probe)
                else:
                    from .parallel import train as parallel_train

                    out = parallel_train.mesh_decode_batch(params, config, batch["images"], eos, valid_size,
                                                           mesh, return_alphas=config.save_attention_maps)
            probe = None
            prof.after_step(b, out.words)
            if prev is not None:
                with tel.span("decode/drain"):
                    drain(*prev)
            prev = (out, batch["files"])
            now = time.perf_counter_ns()
            tel.record("decode/batch", batch_t0, now - batch_t0)
            batch_t0 = now
            if bb is not None:
                bb.journal(b)
        if prev is not None:
            with tel.span("decode/drain"):
                drain(*prev)
    if mesh is not None:
        return _assemble_mesh_results(dataset, vocabulary, _gather_mesh_batches(gathered, mesh))
    return results


def _gather_mesh_batches(local: List[Tuple[np.ndarray, ...]], mesh) -> List[Tuple[np.ndarray, ...]]:
    """Every data rank's beam-0 blocks of each batch, over the CPU gloo
    group, stacked in data-index order into the global batch's rows (the
    ranks along the model axis hold the same rows; the first of each data
    row is taken)."""
    from .parallel.collectives import gather_objects

    per_rank = gather_objects(local, mesh)
    mp = mesh.size("model")
    rows = [per_rank[d * mp] for d in range(mesh.size("data"))]
    return [tuple(np.concatenate(parts, axis=0) for parts in zip(*blocks)) for blocks in zip(*rows)]


def _assemble_mesh_results(
    dataset: DataSet, vocabulary: Vocabulary, gathered: List[Tuple[np.ndarray, ...]],
) -> List[Dict[str, Any]]:
    """The gathered beam-0 results of a mesh decode in dataset order — the
    port of the JAX package's ``_assemble_mesh_results``.

    ``gathered[b]`` = (words [B, T], lengths [B], scores [B][, alphas
    [B, T, N]]) of global batch ``b``.  Each data rank's view holds the
    contiguous block of the global batch its index owns, so row ``m`` of
    gathered batch ``b`` is position ``b*B + m`` of the global order,
    which for the unshuffled eval set is dataset row ``b*B + m``.
    Positions at or past ``dataset.count`` are the trailing padding and
    are dropped; then each image id is kept once."""
    by_row: Dict[int, Tuple] = {}
    for b, batch_arrays in enumerate(gathered):
        B = batch_arrays[0].shape[0]
        for m in range(B):
            g = b * B + m
            if g < dataset.count:                # trailing fake_count padding
                by_row[g] = tuple(a[m] for a in batch_arrays)
    results: List[Dict[str, Any]] = []
    seen = set()
    for g in sorted(by_row):                     # dataset order, each id once
        image_id = int(dataset.image_ids[g])
        if image_id in seen:
            continue
        seen.add(image_id)
        word_row, length, score, *rest = by_row[g]
        length = max(1, int(length))
        row: Dict[str, Any] = {
            "image_id": image_id,
            "image_file": str(dataset.image_files[g]),
            "caption": vocabulary.get_sentence(word_row[:length]),
            "prob": float(np.exp(score)),
        }
        if rest:                                 # gathered beam-0 alphas
            row["words"] = [vocabulary.words[w] for w in word_row[:length]]
            row["alphas"] = rest[0][:length]     # [len, N]
        results.append(row)
    return results


def attend_flops(rows: int, N: int, da: int, D: int) -> float:
    """FLOPs of one unmasked ``fused_attend`` launch over ``rows`` rows,
    from its shapes: per row ``N·da`` adds of ``t1 + t2``, ``2·N·da`` for
    the product with ``w2`` and its sum, ``5·N`` for the softmax (max,
    subtract, exp, sum, divide) and ``2·N·D`` for the context sum."""
    return float(rows) * (3.0 * N * da + 5.0 * N + 2.0 * N * D)


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
    every_rank: bool = False,
) -> Dict[str, float]:
    """Scored beam-search decoding over the eval split: results.json and
    BLEU-1..4 / METEOR / ROUGE_L / CIDEr.

    ``prepared``: an existing ``(coco, dataset, vocabulary)`` from
    :func:`prepare_eval_data`, so a sweep reads the captions once.

    On a mesh every rank decodes and renders its share of the images;
    rank 0 writes results.json and scores, the other ranks return {} —
    or, with ``every_rank``, score their own copy of the gathered
    results, as every host of the JAX package does (the multi-host demo
    holds the ranks' scores equal)."""
    mesh = mesh_for(config)
    dev = resolve_device(device)
    if prepared is None:
        with _rank_zero_first(mesh, "prepare_eval_data"):
            prepared = prepare_eval_data(config)
    coco, dataset, vocabulary = prepared
    if state is None:
        state = setup_state(config, load=True, model_file=model_file, device=dev)

    results = decode_dataset(config, state, dataset, vocabulary, device=dev)
    payload = [{"image_id": r["image_id"], "caption": r["caption"]} for r in results]
    primary = mesh is None or mesh.rank == 0
    if primary:
        atomic_write(config.eval_result_file, "w", lambda f: json.dump(payload, f))

    if config.save_eval_result_as_image:
        os.makedirs(config.eval_result_dir, exist_ok=True)
        _render_caption_images(_local_render_rows(results, mesh), config.eval_result_dir)
    if config.save_attention_maps:
        _save_attention_panels(_local_render_rows(results, mesh), config.eval_result_dir)
        if primary:
            _export_attention_artifacts(results, config.eval_result_dir)
    if not (primary or every_rank):
        return {}
    coco_res = coco.load_results(payload)
    return CocoEvalCap(coco, coco_res, eval_data=dataset).evaluate()


def _local_render_rows(results: List[Dict[str, Any]], mesh) -> List[Dict[str, Any]]:
    """This rank's share of the per-image artifacts: every rank holds the
    whole result list after a mesh decode, so rank ``r`` of ``n`` renders
    rows ``r, r + n, ...`` (the JAX package's partition)."""
    return results if mesh is None else results[mesh.rank::mesh.world]


def evaluate_sweep(config: Config, device=None) -> Dict[int, Dict[str, float]]:
    """Score every checkpoint under save_dir, in-process: the eval split is
    prepared once.  Writes ``<step>.txt`` score dumps next to the
    checkpoints and returns {step: scores} (on a mesh, rank 0; the other
    ranks decode with it and return {step: {}})."""
    mesh = mesh_for(config)
    dev = resolve_device(device)
    with _rank_zero_first(mesh, "prepare_eval_data"):
        prepared = prepare_eval_data(config)
    sweep: Dict[int, Dict[str, float]] = {}
    for step in lineage.checkpoint_steps(config.save_dir):
        path = os.path.join(config.save_dir, f"{step}.npz")
        state = state_from_flat(load_flat(path), config, dev, path)
        scores = evaluate(config, state=state, prepared=prepared, device=dev)
        sweep[step] = scores
        if mesh is not None and mesh.rank != 0:
            continue
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
    results.csv (on a mesh: every rank renders its share of the images,
    rank 0 writes results.csv)."""
    mesh = mesh_for(config)
    dev = resolve_device(device)
    with _rank_zero_first(mesh, "prepare_test_data"):
        dataset, vocabulary = prepare_test_data(config)
    if dataset.count == 0:
        print(f"no images found in {config.test_image_dir}")
        return []
    if state is None:
        state = setup_state(config, load=True, model_file=model_file, device=dev)

    results = decode_dataset(config, state, dataset, vocabulary, device=dev)

    os.makedirs(config.test_result_dir, exist_ok=True)
    _render_caption_images(_local_render_rows(results, mesh), config.test_result_dir)
    if config.save_attention_maps:
        _save_attention_panels(_local_render_rows(results, mesh), config.test_result_dir)
    if mesh is not None and mesh.rank != 0:
        return results
    if config.save_attention_maps:
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
