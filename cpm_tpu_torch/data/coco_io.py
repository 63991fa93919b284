"""Lightweight COCO annotation index (pycocotools.COCO replacement).

The port's copy of cpm_tpu/data/coco_io.py. pycocotools is no dependency of
the port; this provides the small subset the framework needs: image records, per-image annotations, category
ids, and result loading for evaluation. JSON layout follows the COCO
spec (images / annotations / categories).
"""

import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence


class CocoIndex:
    def __init__(self, ann_file_or_dict):
        if isinstance(ann_file_or_dict, dict):
            data = ann_file_or_dict
        else:
            with open(ann_file_or_dict) as f:
                data = json.load(f)
        self.dataset = data
        self.imgs: Dict[int, dict] = {
            im["id"]: im for im in data.get("images", [])
        }
        self.cats: Dict[int, dict] = {
            c["id"]: c for c in data.get("categories", [])
        }
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        self.anns: Dict[int, dict] = {}
        for ann in data.get("annotations", []):
            self.img_to_anns[ann["image_id"]].append(ann)
            if "id" in ann:
                self.anns[ann["id"]] = ann

    # -- pycocotools-compatible surface (the subset we use) --

    def getImgIds(self) -> List[int]:
        return sorted(self.imgs.keys())

    def getCatIds(self) -> List[int]:
        return sorted(self.cats.keys())

    def getAnnIds(self, imgIds=None, iscrowd=None) -> List[int]:
        if imgIds is None:
            anns = list(self.anns.values())
        else:
            if not isinstance(imgIds, (list, tuple)):
                imgIds = [imgIds]
            anns = [a for i in imgIds for a in self.img_to_anns[i]]
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns if "id" in a]

    def loadAnns(self, ids: Sequence[int]) -> List[dict]:
        return [self.anns[i] for i in ids]

    def loadImgs(self, ids: Sequence[int]) -> List[dict]:
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def annotations_for_image(self, img_id: int) -> List[dict]:
        return self.img_to_anns[img_id]

    def loadRes(self, results: List[dict]) -> "CocoIndex":
        """Build an index over detection results (COCO.loadRes subset)."""
        data = dict(
            images=list(self.imgs.values()),
            categories=list(self.cats.values()),
            annotations=[],
        )
        for i, r in enumerate(results):
            ann = dict(r)
            ann["id"] = i + 1
            ann.setdefault("iscrowd", 0)
            if "bbox" in ann and "area" not in ann:
                ann["area"] = ann["bbox"][2] * ann["bbox"][3]
            data["annotations"].append(ann)
        return CocoIndex(data)
