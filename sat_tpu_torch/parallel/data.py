"""Per-rank input sharding — the port of ``sat_tpu.parallel.data``.

Each rank feeds the rows of the global batch that its data index owns,
the block ``r`` of every global batch, so the global batch the ranks of
one step hold together is element for element the batch a single process
feeds at the same (seed, epoch, step).  The rank's view yields the whole
global batch and names its block: the loader (``data.images.
PrefetchLoader``) assembles the global batch, quarantines and
substitutes its bad rows as one process would (a substitute may come
from another rank's block), and keeps the block.  No global tensor is
ever assembled on the device (``parallel.collectives``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..data.dataset import DataSet


def mesh_data_shard(mesh) -> Tuple[int, int]:
    """This rank's slot on the mesh's 'data' axis: ``(shard_index,
    num_shards)`` for the input feed.

    The feed is keyed on the data axis, not on the rank: the ranks along
    the model axis (vocab or context parallelism) share a data row and
    feed identical copies of it, so a pure model-axis mesh gives
    ``(0, 1)``.  Ranks are laid out data-major, one mesh position each,
    which is the JAX package's one-row-per-process case."""
    return mesh.index("data"), mesh.size("data")


class _ProcessShardView(DataSet):
    """A rank's view of a global DataSet whose batch stream does not
    depend on the process layout.

    Every epoch it draws the global keyed order (the permutation and the
    ``fake_count`` padding of ``DataSet._set_epoch``, the same rng in the
    same call order) and yields each global batch whole; ``block`` is
    the ``[start, stop)`` of its rows that this rank keeps (the loader
    slices it after the batch's quarantine), so:

    * a run over ``d`` data ranks computes each step over the example
      set and row order of the single-process run, substituted rows
      included;
    * a run checkpointed under one layout and resumed under another
      replays the same global stream (the cursor is f(seed, epoch)).

    The padding is part of the global order, so every rank always holds
    whole local batches and the step count agrees across ranks."""

    def __init__(self, global_ds: DataSet, shard_index: int, shard_count: int):
        self._global_batch = global_ds.batch_size
        local = global_ds.batch_size // shard_count
        self.block = (shard_index * local, (shard_index + 1) * local)
        super().__init__(
            global_ds.image_ids, global_ds.image_files, local,
            global_ds.word_idxs, global_ds.masks, is_train=global_ds.is_train,
            shuffle=global_ds.shuffle, seed=global_ds.seed,
        )
        # count / num_batches / fake_count describe the global set (the
        # step count every rank must agree on); batch_size is local
        self.num_batches = int(np.ceil(self.count / self._global_batch))
        self.fake_count = self.num_batches * self._global_batch - self.count
        self._global_ready = True
        self.seek(0, 0)

    def _set_epoch(self, epoch: int) -> None:
        if not getattr(self, "_global_ready", False):
            # DataSet.__init__'s seek, before the global counts are set
            self.epoch, self.idxs, self._pad_idxs = epoch, [], []
            return
        self.epoch = epoch
        rng = np.random.default_rng((self.seed, epoch))
        order = list(rng.permutation(self.count)) if self.shuffle else list(range(self.count))
        if self.fake_count:
            order += list(rng.choice(self.count, self.fake_count))
        self.idxs = order      # the global order, the padding included
        self._pad_idxs = []

    def seek(self, epoch: int, batch_offset: int = 0) -> None:
        self._set_epoch(epoch)
        self.current_idx = batch_offset * self._global_batch
        self._pending_seek = True

    def next_batch(self):
        """The next global batch: files, or (files, word_idxs, masks)."""
        idxs = self.idxs[self.current_idx: self.current_idx + self._global_batch]
        self.current_idx += self._global_batch
        files = self.image_files[idxs]
        if self.is_train:
            return files, self.word_idxs[idxs], self.masks[idxs]
        return files

    def __iter__(self):
        if self._pending_seek:
            self._pending_seek = False
        else:
            self.current_idx = 0
            self._set_epoch(self.epoch + 1)
        # always whole global batches
        while self.current_idx < len(self.idxs):
            yield self.next_batch()


def process_local_dataset(dataset: DataSet, process_index: int, process_count: int) -> DataSet:
    """This rank's view of a global DataSet: the global batches, with the
    block of ``global_batch / process_count`` rows that ``process_index``
    keeps (``block``).  ``process_count`` 1 returns the dataset
    unchanged."""
    if process_count == 1:
        return dataset
    if dataset.batch_size % process_count:
        raise ValueError(f"global batch {dataset.batch_size} not divisible by {process_count} processes")
    return _ProcessShardView(dataset, process_index, process_count)
