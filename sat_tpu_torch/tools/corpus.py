"""The quality protocol's procedural corpora and its loss-curve reader.

The port's own copy of ``scripts/quality_run.py``'s corpus makers: the
same ``cv2`` writes from the same ``numpy.random.default_rng`` streams,
so on one machine both write the same bytes.  ``make_corpus`` (48 images,
a 200-word vocabulary) gives every image a distinct learnable caption;
``make_rich_corpus`` (336 images, 1000+ words, caption lengths 7-20 plus
over-cap captions the length filter drops) covers the vocabulary and the
length distribution.  No torch: the corpus is numpy and ``cv2``.
"""

from __future__ import annotations

import itertools
import json
import os

import numpy as np

COLORS = ["red", "blue", "green", "yellow", "black", "white", "brown", "orange"]
ANIMALS = ["cat", "dog", "horse", "bird", "rabbit", "sheep"]
PLACES = ["park", "beach", "kitchen", "street", "garden", "field", "harbor", "station"]

# the rich corpus's pools: a 1000+ word vocabulary and the full
# caption-length distribution
ADJS = [
    "big", "small", "tiny", "huge", "fluffy", "sleepy", "playful", "spotted",
    "striped", "muddy", "shiny", "elderly", "young", "swift", "sluggish",
    "quiet", "noisy", "gentle", "curious", "clever", "lazy", "hungry",
    "cheerful", "grumpy",
]
VERBS = [
    "sitting", "standing", "sprinting", "sleeping", "playing", "eating",
    "drinking", "jumping", "strolling", "resting", "hiding", "waiting",
    "watching", "climbing", "digging", "paddling",
]
WEATHER = ["sunny", "rainy", "cloudy", "windy", "foggy", "snowy", "stormy", "hazy"]
TIMES = ["morning", "afternoon", "evening", "midday"]

# pronounceable fake words, deterministic and collision-free: base-70
# syllable triples.  Each rich-corpus image carries three unique tokens
# (a name, a toy, a landmark), so 336 images give 1000+ distinct words.
_SYLLABLES = [c + v for c in "bdfgklmnprstvz" for v in "aeiou"]


def _fake_word(i: int) -> str:
    a, rest = i % 70, i // 70
    b, c = rest % 70, rest // 70
    return _SYLLABLES[c % 70] + _SYLLABLES[b] + _SYLLABLES[a]


def make_rich_corpus(root: str, num_images: int = 336, image_edge: int = 64):
    """A few-hundred-image corpus with a 1000+ word vocabulary and caption
    lengths up to the 20-token cap; returns (image dir, caption file,
    token lengths of every caption).

    Per image: a (color, animal, place) scene, three unique fake words,
    and two captions whose length band cycles short (7 tokens) / medium
    (12) / long (19) / max (20).  Every 41st image carries a third,
    29-token caption that the caption-length filter must drop.  A color
    block and a per-image texture make the mapping learnable."""
    import cv2

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(1)

    images, annotations = [], []
    lengths = []
    ann_id = itertools.count(1000)
    for i in range(num_images):
        fname = f"rich_{i:06d}.jpg"
        img = rng.integers(0, 90, (image_edge, image_edge, 3), dtype=np.uint8)
        hue = np.zeros(3, dtype=np.uint8)
        hue[i % 3] = 120 + (i * 7) % 130
        img[: image_edge // 2, :, :] = hue
        img[image_edge // 2:, : image_edge // 2, (i // 3) % 3] = 210
        cv2.imwrite(os.path.join(img_dir, fname), img)
        images.append({"id": i + 1, "file_name": fname})

        color = COLORS[i % len(COLORS)]
        animal = ANIMALS[(i // 3) % len(ANIMALS)]
        place = PLACES[(i // 7) % len(PLACES)]
        adj = ADJS[(i // 2) % len(ADJS)]
        verb = VERBS[(i // 5) % len(VERBS)]
        weather = WEATHER[(i // 11) % len(WEATHER)]
        daytime = TIMES[(i // 13) % len(TIMES)]
        name, toy, mark = _fake_word(3 * i), _fake_word(3 * i + 1), _fake_word(3 * i + 2)

        # each image's caption pair surfaces all three unique tokens, or
        # the vocabulary undershoots 1000 words
        band = i % 4
        if band == 0:      # short: 7 tokens incl. '.'
            caps = [
                f"{name} the {color} {animal} is {verb}.",
                f"{name} has the {toy} and {mark}.",
            ]
        elif band == 1:    # medium: 12 tokens
            caps = [
                f"the {adj} {color} {animal} named {name} is {verb} in the {place}.",
                f"a {adj} {color} {animal} named {name} guards the {toy} and {mark}.",
            ]
        elif band == 2:    # long: 19 tokens
            caps = [
                f"on a {weather} {daytime} the {adj} {color} {animal} named "
                f"{name} is {verb} near the {place} with a {toy}.",
                f"on one {weather} {daytime} a {adj} {color} {animal} named "
                f"{name} was {verb} near the {place} with the {mark}.",
            ]
        else:              # max: exactly 20 tokens
            caps = [
                f"on a {weather} {daytime} the {adj} {color} {animal} named "
                f"{name} is {verb} by the old {mark} near the {place}.",
                f"on a {weather} {daytime} a {adj} {color} {animal} named "
                f"{name} was {verb} by the old {toy} near the {place}.",
            ]
        if i % 41 == 0:    # over-cap caption: the length filter must drop it
            caps.append(
                f"this is a deliberately very long extra caption about the {adj} "
                f"{color} {animal} named {name} that keeps {verb} near the "
                f"{place} with a {toy} by the {mark} today."
            )
        for cap in caps:
            lengths.append(len(cap.replace(".", " .").split()))
            annotations.append(
                {"id": next(ann_id), "image_id": i + 1, "caption": cap}
            )

    caption_file = os.path.join(root, "captions.json")
    with open(caption_file, "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    return img_dir, caption_file, lengths


def make_corpus(root: str, num_images: int = 48, image_edge: int = 96):
    """A COCO-format corpus: image i shows a color-coded pattern and carries
    two captions with the same content words (the learnable target) and
    one function-word variation (so scoring against two references is not
    degenerate); returns (image dir, caption file)."""
    import cv2

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    combos = list(itertools.product(range(len(COLORS)), range(len(ANIMALS)), range(len(PLACES))))
    if num_images > len(combos):
        raise SystemExit(
            f"--num-images must be <= {len(combos)} (distinct caption combos)"
        )
    rng = np.random.default_rng(0)
    rng.shuffle(combos)

    images, annotations = [], []
    for i in range(num_images):
        ci, ai, pi = combos[i]
        fname = f"fixture_{i:06d}.jpg"
        # a color block keyed to the caption's color word and a per-image
        # texture, so the mapping is learnable
        img = rng.integers(0, 80, (image_edge, image_edge, 3), dtype=np.uint8)
        hue = np.zeros(3, dtype=np.uint8)
        hue[ci % 3] = 250 - 20 * (ci // 3)
        img[: image_edge // 2, :, :] = hue
        img[image_edge // 2 :, : image_edge // 2, (ai % 3)] = 200
        img[image_edge // 2 :, image_edge // 2 :, (pi % 3)] = 120
        cv2.imwrite(os.path.join(img_dir, fname), img)
        images.append({"id": i + 1, "file_name": fname})
        color, animal, place = COLORS[ci], ANIMALS[ai], PLACES[pi]
        caps = [
            f"a {color} {animal} in the {place}.",
            f"the {color} {animal} is in the {place}.",
        ]
        for j, cap in enumerate(caps):
            annotations.append({"id": 1000 + 2 * i + j, "image_id": i + 1, "caption": cap})

    caption_file = os.path.join(root, "captions.json")
    with open(caption_file, "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    return img_dir, caption_file


def read_loss_curve(metrics_path: str, samples: int = 12):
    """(step, total_loss) rows of the last run in a metrics.jsonl,
    downsampled to ~``samples`` rows (the last row always kept).  A step
    that does not increase marks the start of a newer run appended to the
    same file; earlier segments are discarded."""
    curve = []
    with open(metrics_path) as f:
        for line in f:
            rec = json.loads(line)
            if "total_loss" in rec:
                if curve and rec["step"] <= curve[-1][0]:
                    curve = []
                curve.append((rec["step"], rec["total_loss"]))
    sampled = curve[:: max(1, len(curve) // samples)]
    if curve and sampled[-1][0] != curve[-1][0]:
        sampled.append(curve[-1])
    return sampled
