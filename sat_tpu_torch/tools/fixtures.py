"""The synthetic COCO-format fixture the chaos campaign trains on.

The port's own copy of ``tests/fixtures.py:make_coco_fixture``: twelve
procedurally drawn JPEGs (the same ones in a train and a val directory),
two captions an image cycled from a fixed pool, and a ready ``Config``
(the port's) pointing at them.  On one machine it writes the same JPEGs
and the same caption JSON, byte for byte.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

CAPTIONS = [
    "a man riding a horse on the beach.",
    "a group of people standing around a kitchen.",
    "two dogs playing with a red ball in the grass.",
    "a plate of food with rice and vegetables.",
    "a bus driving down a city street.",
    "a cat sitting on top of a wooden table.",
    "a woman holding an umbrella in the rain.",
    "a young boy throwing a frisbee in the park.",
    "several boats floating in the harbor near the dock.",
    "a train traveling down the tracks near a station.",
    "a bird perched on a branch of a tree.",
    "a pizza with cheese and tomatoes on a plate.",
]


def _write_jpeg(path: str, seed: int, size: int = 64) -> None:
    import cv2

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
    # some structure so resize interpolation is non-trivial
    img[:, : size // 2, 0] = 200
    img[size // 2 :, :, 2] = 60
    cv2.imwrite(path, img)


def make_coco_fixture(root: str, num_images: int = 12) -> Dict:
    """Create train/val image dirs + caption JSONs under ``root``.
    Returns a dict of paths plus a ready Config."""
    from ..config import Config

    train_img_dir = os.path.join(root, "train", "images")
    val_img_dir = os.path.join(root, "val", "images")
    os.makedirs(train_img_dir, exist_ok=True)
    os.makedirs(val_img_dir, exist_ok=True)

    images: List[Dict] = []
    annotations: List[Dict] = []
    for i in range(num_images):
        fname = f"COCO_fixture_{i:012d}.jpg"
        images.append({"id": i + 1, "file_name": fname})
        _write_jpeg(os.path.join(train_img_dir, fname), seed=i)
        _write_jpeg(os.path.join(val_img_dir, fname), seed=i)
        # two captions per image, cycling the pool
        for j in range(2):
            annotations.append(
                {
                    "id": 1000 + 2 * i + j,
                    "image_id": i + 1,
                    "caption": CAPTIONS[(i + j) % len(CAPTIONS)],
                }
            )

    train_json = os.path.join(root, "train", "captions_train.json")
    val_json = os.path.join(root, "val", "captions_val.json")
    payload = {"images": images, "annotations": annotations}
    for p in (train_json, val_json):
        with open(p, "w") as f:
            json.dump(payload, f)

    config = Config(
        batch_size=4,
        vocabulary_size=200,
        max_train_ann_num=None,
        max_eval_ann_num=8,
        num_epochs=1,
        train_image_dir=train_img_dir,
        train_caption_file=train_json,
        eval_image_dir=val_img_dir,
        eval_caption_file=val_json,
        vocabulary_file=os.path.join(root, "vocabulary.csv"),
        temp_annotation_file=os.path.join(root, "train", "anns.csv"),
        temp_data_file=os.path.join(root, "train", "data.npy"),
        eval_result_dir=os.path.join(root, "val", "results"),
        eval_result_file=os.path.join(root, "val", "results.json"),
        test_image_dir=val_img_dir,
        test_result_dir=os.path.join(root, "test_results"),
        test_result_file=os.path.join(root, "test_results.csv"),
        save_dir=os.path.join(root, "models"),
        summary_dir=os.path.join(root, "summary"),
        save_eval_result_as_image=False,
    )
    return {
        "root": root,
        "train_json": train_json,
        "val_json": val_json,
        "train_img_dir": train_img_dir,
        "val_img_dir": val_img_dir,
        "config": config,
    }
