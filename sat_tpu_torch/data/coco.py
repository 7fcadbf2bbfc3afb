"""COCO captions index — the port's copy of ``sat_tpu.data.coco``.

The behavioral contract of the COCO caption toolkit, as the JAX package
keeps it:

* an optional ``max_ann_num`` cap on the first N annotations;
* caption normalization at load: lowercase and a trailing ``'.'``;
* ``filter_by_cap_len`` keeps annotations whose caption tokenizes to at
  most N tokens, and drops images left with none;
* ``load_results`` validates a predictions list or JSON against the
  ground-truth image set and wraps it in a new index;
* ``download`` fetches missing images by ``coco_url``; when every image
  is present it fetches nothing.

The word filter of training data preparation comes with the training
slice of the port.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Set

from ..utils.fileio import read_json
from .tokenizer import tokenize


class CocoCaptions:
    def __init__(
        self,
        annotation_file: Optional[str] = None,
        max_ann_num: Optional[int] = None,
    ):
        self.dataset: Dict = {"images": [], "annotations": []}
        self.anns: Dict[int, Dict] = {}
        self.imgs: Dict[int, Dict] = {}
        self.img_to_anns: Dict[int, List[Dict]] = {}
        self.max_ann_num = max_ann_num

        if annotation_file is not None:
            self.dataset = read_json(
                annotation_file, desc=f"read captions {annotation_file}"
            )
            self._normalize_captions()
            self.create_index(max_ann_num)

    def _normalize_captions(self) -> None:
        for ann in self.dataset.get("annotations", []):
            q = ann["caption"].lower()
            if not q.endswith("."):
                q = q + "."
            ann["caption"] = q

    def create_index(self, max_ann_num: Optional[int] = None) -> None:
        anns: Dict[int, Dict] = {}
        img_to_anns: Dict[int, List[Dict]] = {}
        annotations = self.dataset.get("annotations", [])
        if max_ann_num is not None:
            annotations = annotations[:max_ann_num]
        for ann in annotations:
            anns[ann["id"]] = ann
            img_to_anns.setdefault(ann["image_id"], []).append(ann)

        self.anns = anns
        self.img_to_anns = img_to_anns
        self.imgs = {img["id"]: img for img in self.dataset.get("images", [])}

    # ---- filters (rebuild the index afterwards) ----

    def filter_by_cap_len(self, max_cap_len: int) -> None:
        keep = [
            ann
            for ann in self.dataset["annotations"]
            if len(tokenize(ann["caption"])) <= max_cap_len
        ]
        self._apply_ann_filter(keep)

    def filter_by_words(self, vocab: Set[str]) -> None:
        """Keep the annotations whose every token is in ``vocab`` (and the
        images left with one)."""
        keep = [
            ann
            for ann in self.dataset["annotations"]
            if all(w in vocab for w in tokenize(ann["caption"]))
        ]
        self._apply_ann_filter(keep)

    def _apply_ann_filter(self, kept_anns: List[Dict]) -> None:
        kept_img_ids = {ann["image_id"] for ann in kept_anns}
        self.dataset["annotations"] = kept_anns
        self.dataset["images"] = [
            img for img in self.dataset["images"] if img["id"] in kept_img_ids
        ]
        self.create_index()

    # ---- accessors ----

    def all_captions(self) -> List[str]:
        return [ann["caption"] for ann in self.anns.values()]

    # ---- results wrapping for evaluation ----

    def load_results(self, res_file_or_list) -> "CocoCaptions":
        """Build a result index from a predictions JSON file or list of
        ``{'image_id': int, 'caption': str}`` dicts."""
        if isinstance(res_file_or_list, str):
            with open(res_file_or_list) as f:
                anns = json.load(f)
        else:
            # copy so assigning result ids never mutates the caller's dicts
            anns = [dict(a) for a in res_file_or_list]
        if not isinstance(anns, list):
            raise ValueError("results must be a list of objects")
        if not anns or "caption" not in anns[0]:
            raise ValueError("results must contain captions")
        res_img_ids = {ann["image_id"] for ann in anns}
        missing = res_img_ids - set(self.imgs.keys())
        if missing:
            raise ValueError(
                f"results reference unknown image ids: {sorted(missing)[:5]}"
            )

        res = CocoCaptions()
        res.dataset["images"] = [
            img for img in self.dataset["images"] if img["id"] in res_img_ids
        ]
        for i, ann in enumerate(anns):
            ann["id"] = i + 1
        res.dataset["annotations"] = anns
        res.create_index()
        return res

    # ---- image download (idempotent) ----

    def download(self, target_dir: str, img_ids: Sequence[int] = ()) -> int:
        from urllib.request import urlretrieve

        imgs = (
            [self.imgs[i] for i in img_ids] if len(img_ids) else list(self.imgs.values())
        )
        os.makedirs(target_dir, exist_ok=True)
        fetched = 0
        failed = 0
        for img in imgs:
            fname = os.path.join(target_dir, img["file_name"])
            if not os.path.exists(fname):
                if "coco_url" not in img:
                    continue
                try:
                    urlretrieve(img["coco_url"], fname)
                    fetched += 1
                except OSError:
                    # keep going: a missing image surfaces later with a
                    # clear error naming the file
                    failed += 1
        if failed:
            print(f"warning: failed to download {failed} missing images")
        return fetched
