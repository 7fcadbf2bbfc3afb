"""Batch iteration and eval/test data preparation — the port's copy of the
eval and test half of ``sat_tpu.data.dataset``.

A ``DataSet`` yields batch *file lists* of a fixed size: the last batch is
padded with items drawn by ``numpy.random.default_rng((0, epoch))``,
the same draws as the JAX package's, and ``fake_count`` records the
padding.  Every batch therefore has one shape (the bf16 encode on the
card depends on the batch size).  Image bytes are assembled downstream
by ``data.images.PrefetchLoader``.  Shuffling and the caption arrays of
training come with the training slice of the port.
"""

from __future__ import annotations

import glob
import os
from typing import Tuple

import numpy as np

from ..config import Config
from .coco import CocoCaptions
from .vocabulary import Vocabulary


# seed of the padding draws; the JAX package's default
PADDING_SEED = 0


class DataSet:
    def __init__(self, image_ids, image_files, batch_size: int):
        self.image_ids = np.array(image_ids)
        self.image_files = np.array(image_files)
        self.batch_size = batch_size
        self.count = len(self.image_ids)
        self.num_batches = int(np.ceil(self.count / self.batch_size))
        self.fake_count = self.num_batches * self.batch_size - self.count
        self.epoch = -1

    def __iter__(self):
        """One epoch's batches of files: epoch 0 on the first iteration,
        the next epoch on each later one.  The final partial batch is
        padded to full size with items drawn under
        ``default_rng((PADDING_SEED, epoch))``."""
        self.epoch += 1
        rng = np.random.default_rng((PADDING_SEED, self.epoch))
        pad = list(rng.choice(self.count, self.fake_count)) if self.fake_count else []
        idxs = list(range(self.count)) + pad
        for start in range(0, self.count, self.batch_size):
            yield self.image_files[idxs[start : start + self.batch_size]]


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
