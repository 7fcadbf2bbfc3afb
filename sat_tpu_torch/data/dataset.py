"""Batch iteration and data preparation — the port's copy of
``sat_tpu.data.dataset``.

A ``DataSet`` yields batches of a fixed size: file lists, or for training
(files, word_idxs, masks).  The final partial batch is padded with items
drawn from the epoch's rng and ``fake_count`` records the padding, so
every batch has one shape (the bf16 encode on the card depends on the
batch size).  Epoch order is a pure function of ``(seed, epoch)``:
``numpy.random.default_rng((seed, epoch))`` shuffles (training) and then
draws the padding, the same draws as the JAX package's, so
:meth:`DataSet.seek` resumes mid-epoch on exactly the batch an
uninterrupted run would take.  Image bytes are assembled downstream by
``data.images.PrefetchLoader``.

:func:`prepare_train_data` writes and reads its caches (``vocabulary_file``,
``temp_annotation_file``: a pandas CSV with its index column,
``temp_data_file``: ``np.save`` of a pickled dict) exactly as the JAX
package does, so a cache written by either package serves the other.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Tuple

import numpy as np

from .. import telemetry
from ..config import Config
from ..utils.fileio import atomic_write
from .coco import CocoCaptions
from .vocabulary import Vocabulary


class DataSet:
    def __init__(
        self,
        image_ids,
        image_files,
        batch_size: int,
        word_idxs=None,
        masks=None,
        is_train: bool = False,
        shuffle: bool = False,
        seed: Optional[int] = None,
    ):
        self.image_ids = np.array(image_ids)
        self.image_files = np.array(image_files)
        self.word_idxs = None if word_idxs is None else np.array(word_idxs)
        self.masks = None if masks is None else np.array(masks)
        self.batch_size = batch_size
        self.is_train = is_train
        self.shuffle = shuffle
        self.seed = 0 if seed is None else int(seed)
        self.count = len(self.image_ids)
        self.num_batches = int(np.ceil(self.count / self.batch_size))
        self.fake_count = self.num_batches * self.batch_size - self.count
        # at epoch 0 with the seek pending: the first iteration takes epoch
        # 0, each later one the next epoch
        self.seek(0, 0)

    def _set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        telemetry.gauge("data/epoch", epoch)
        rng = np.random.default_rng((self.seed, epoch))
        self.idxs = list(rng.permutation(self.count)) if self.shuffle else list(range(self.count))
        # the padding of the final partial batch draws from the same rng
        self._pad_idxs = list(rng.choice(self.count, self.fake_count)) if self.fake_count else []

    def seek(self, epoch: int, batch_offset: int = 0) -> None:
        """Position at (epoch, batch), for mid-epoch resume: the next
        iteration starts there instead of at the next epoch."""
        self._set_epoch(epoch)
        self.current_idx = batch_offset * self.batch_size
        self._pending_seek = True

    def next_batch(self):
        """files, or (files, word_idxs, masks) when training; the final
        partial batch padded to full size."""
        if self.current_idx + self.batch_size <= self.count:
            idxs = self.idxs[self.current_idx : self.current_idx + self.batch_size]
        else:
            idxs = self.idxs[self.current_idx : self.count] + self._pad_idxs
        self.current_idx += self.batch_size
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
        while self.current_idx < self.count:
            yield self.next_batch()


def prepare_train_data(config: Config) -> DataSet:
    """COCO load → length filter → vocabulary built or loaded → word
    filter → captions tokenized (or the caches read) → a shuffled
    DataSet seeded with ``config.seed``."""
    coco = CocoCaptions(config.train_caption_file, config.max_train_ann_num)
    coco.filter_by_cap_len(config.max_caption_length)

    vocabulary = Vocabulary(config.vocabulary_size)
    if not os.path.exists(config.vocabulary_file):
        captions = coco.all_captions()
        if config.max_train_ann_num:
            captions = captions[: config.max_train_ann_num]
        vocabulary.build(captions)
        vocabulary.save(config.vocabulary_file)
    else:
        vocabulary.load(config.vocabulary_file)

    coco.filter_by_words(set(vocabulary.words))

    import pandas as pd

    if not os.path.exists(config.temp_annotation_file):
        ann_ids = list(coco.anns.keys())
        if config.max_train_ann_num:
            ann_ids = ann_ids[: config.max_train_ann_num]
        captions = [coco.anns[i]["caption"] for i in ann_ids]
        image_ids = [coco.anns[i]["image_id"] for i in ann_ids]
        image_files = [
            os.path.join(config.train_image_dir, coco.imgs[i]["file_name"]) for i in image_ids
        ]
        atomic_write(
            config.temp_annotation_file,
            "w",
            lambda f: pd.DataFrame(
                {"image_id": image_ids, "image_file": image_files, "caption": captions}
            ).to_csv(f),
        )
    else:
        annotations = pd.read_csv(config.temp_annotation_file)
        n = config.max_train_ann_num or len(annotations)
        captions = list(annotations["caption"].values[:n])
        image_ids = list(annotations["image_id"].values[:n])
        image_files = list(annotations["image_file"].values[:n])

    if not os.path.exists(config.temp_data_file):
        T = config.max_caption_length
        word_idxs = np.zeros((len(captions), T), np.int32)
        masks = np.zeros((len(captions), T), np.float32)
        for i, caption in enumerate(captions):
            idxs = vocabulary.process_sentence(caption)
            n_words = min(len(idxs), T)
            word_idxs[i, :n_words] = idxs[:n_words]
            masks[i, :n_words] = 1.0
        atomic_write(
            config.temp_data_file,
            "wb",
            lambda f: np.save(f, {"word_idxs": word_idxs, "masks": masks}, allow_pickle=True),
        )
    else:
        # a pickled dict: only this program (or the JAX package) writes it
        data = np.load(config.temp_data_file, allow_pickle=True).item()
        word_idxs, masks = data["word_idxs"], data["masks"]

    coco.download(config.train_image_dir, image_ids)
    return DataSet(
        image_ids, image_files, config.batch_size, word_idxs, masks,
        is_train=True, shuffle=True, seed=config.seed,
    )


def prepare_eval_data(config: Config) -> Tuple[CocoCaptions, DataSet, Vocabulary]:
    """(ground-truth COCO, unshuffled DataSet, Vocabulary).  With
    ``max_eval_ann_num`` the DataSet holds one image id per annotation of
    the first N, so an image with two captions among them appears twice
    (the decode drops the repeat)."""
    coco = CocoCaptions(config.eval_caption_file, config.max_eval_ann_num)
    if not config.max_eval_ann_num:
        image_ids = list(coco.imgs.keys())
    else:
        ann_ids = list(coco.anns.keys())[: config.max_eval_ann_num]
        image_ids = [coco.anns[i]["image_id"] for i in ann_ids]
    image_files = [
        os.path.join(config.eval_image_dir, coco.imgs[i]["file_name"])
        for i in image_ids
    ]

    vocabulary = _load_or_build_vocabulary(config)
    coco.download(config.eval_image_dir, image_ids)
    dataset = DataSet(image_ids, image_files, config.batch_size)
    return coco, dataset, vocabulary


def prepare_test_data(config: Config) -> Tuple[DataSet, Vocabulary]:
    """Caption every JPEG of ``test_image_dir``, in sorted order."""
    files = sorted(
        f
        for f in glob.glob(os.path.join(config.test_image_dir, "*"))
        if f.lower().endswith((".jpg", ".jpeg"))
    )
    image_ids = list(range(len(files)))
    vocabulary = _load_or_build_vocabulary(config)
    return DataSet(image_ids, files, config.batch_size), vocabulary


def _load_or_build_vocabulary(config: Config) -> Vocabulary:
    if os.path.exists(config.vocabulary_file):
        return Vocabulary(config.vocabulary_size, config.vocabulary_file)
    return build_vocabulary(config)


def build_vocabulary(config: Config) -> Vocabulary:
    """Build from the training captions (length-filtered, first
    ``max_train_ann_num``) and save."""
    coco = CocoCaptions(config.train_caption_file, config.max_train_ann_num)
    coco.filter_by_cap_len(config.max_caption_length)
    vocabulary = Vocabulary(config.vocabulary_size)
    captions = coco.all_captions()
    if config.max_train_ann_num:
        captions = captions[: config.max_train_ann_num]
    vocabulary.build(captions)
    vocabulary.save(config.vocabulary_file)
    return vocabulary
