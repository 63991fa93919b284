"""COCO detection dataset (host-side, numpy).

The port's copy of cpm_tpu/data/coco.py, itself after the reference's
pet/utils/data/datasets/coco.py:45-121:
  * filters crowd-only and empty-bbox images (:21-42, 54-61);
  * contiguous category-id mapping (:63-68);
  * items carry xyxy float boxes + 1-based contiguous labels.

Implemented over the in-repo CocoIndex (data/coco_io.py; no pycocotools).
"""

import os
from typing import List, Optional

import numpy as np

from cpm_tpu_torch.data import catalog
from cpm_tpu_torch.data.coco_io import CocoIndex
from cpm_tpu_torch.data.synthetic_coco import SYNTHETIC_NAME, ensure_registered


def _has_only_empty_bbox(anno) -> bool:
    return all(any(o <= 1 for o in obj["bbox"][2:]) for obj in anno)


def has_valid_annotation(anno) -> bool:
    """coco.py:33-42 filter rule."""
    if len(anno) == 0:
        return False
    if _has_only_empty_bbox(anno):
        return False
    return True


class COCODataset:
    def __init__(
        self,
        ann_file: str,
        root: str,
        remove_images_without_annotations: bool = True,
        ignore_crowd: bool = True,
    ):
        self.coco = CocoIndex(ann_file)
        self.root = root
        self.ids = sorted(self.coco.imgs.keys())

        if remove_images_without_annotations:
            kept = []
            for img_id in self.ids:
                ann_ids = self.coco.getAnnIds(imgIds=img_id, iscrowd=None)
                anno = self.coco.loadAnns(ann_ids)
                if ignore_crowd:
                    anno = [o for o in anno if o.get("iscrowd", 0) == 0]
                if has_valid_annotation(anno):
                    kept.append(img_id)
            self.ids = kept

        self.json_category_id_to_contiguous_id = {
            v: i + 1 for i, v in enumerate(self.coco.getCatIds())
        }
        self.contiguous_category_id_to_json_id = {
            v: k for k, v in self.json_category_id_to_contiguous_id.items()
        }
        self.id_to_img_map = {k: v for k, v in enumerate(self.ids)}

    def __len__(self):
        return len(self.ids)

    def get_img_info(self, index: int) -> dict:
        img_id = self.ids[index]
        return self.coco.imgs[img_id]

    def image_path(self, index: int) -> str:
        return os.path.join(self.root, self.get_img_info(index)["file_name"])

    def load_image(self, index: int) -> np.ndarray:
        """RGB uint8 HWC."""
        from PIL import Image

        with Image.open(self.image_path(index)) as im:
            return np.asarray(im.convert("RGB"))

    def load_annotations(self, index: int):
        """(boxes [N,4] xyxy float32, labels [N] int32 contiguous 1-based)."""
        img_id = self.ids[index]
        ann_ids = self.coco.getAnnIds(imgIds=img_id, iscrowd=None)
        anno = [
            o
            for o in self.coco.loadAnns(ann_ids)
            if o.get("iscrowd", 0) == 0
        ]
        boxes = np.array(
            [o["bbox"] for o in anno], np.float32
        ).reshape(-1, 4)
        # xywh -> xyxy with TO_REMOVE=1 (bounding_box.py convert)
        boxes[:, 2] = boxes[:, 0] + np.maximum(boxes[:, 2] - 1, 0)
        boxes[:, 3] = boxes[:, 1] + np.maximum(boxes[:, 3] - 1, 0)
        labels = np.array(
            [
                self.json_category_id_to_contiguous_id[o["category_id"]]
                for o in anno
            ],
            np.int32,
        )
        # clip to image (ImageList semantics) and drop degenerate boxes
        info = self.coco.imgs[img_id]
        w, h = info["width"], info["height"]
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, w - 1)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, h - 1)
        keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        return boxes[keep], labels[keep]

    def aspect_ratios(self) -> np.ndarray:
        """Per-image w/h for grouped batching (dataset.py:70-98)."""
        out = np.empty(len(self.ids), np.float32)
        for i, img_id in enumerate(self.ids):
            info = self.coco.imgs[img_id]
            out[i] = info["width"] / info["height"]
        return out


def build_dataset(cfg, names, is_train: bool) -> List[COCODataset]:
    """rcnn/datasets/dataset.py:17-47 equivalent (list of datasets)."""
    datasets = []
    for name in names:
        if name == SYNTHETIC_NAME:
            ensure_registered(cfg.DATA_DIR)
        elif not catalog.contains(name):
            raise KeyError(f"unknown dataset: {name}")
        datasets.append(
            COCODataset(
                ann_file=catalog.get_ann_fn(cfg.DATA_DIR, name),
                root=catalog.get_im_dir(cfg.DATA_DIR, name),
                remove_images_without_annotations=is_train,
            )
        )
    return datasets


class ConcatDataset:
    """Multi-dataset union (pet/utils/data/datasets/concat_dataset.py)."""

    def __init__(self, datasets):
        assert len(datasets) > 0
        self.datasets = list(datasets)
        self.offsets = []
        total = 0
        for d in self.datasets:
            self.offsets.append(total)
            total += len(d)
        self.total = total
        # category mapping must agree across datasets
        self.json_category_id_to_contiguous_id = self.datasets[
            0
        ].json_category_id_to_contiguous_id
        self.contiguous_category_id_to_json_id = self.datasets[
            0
        ].contiguous_category_id_to_json_id

    def __len__(self):
        return self.total

    def _locate(self, index):
        for d, off in zip(
            reversed(self.datasets), reversed(self.offsets)
        ):
            if index >= off:
                return d, index - off
        raise IndexError(index)

    def get_img_info(self, index):
        d, i = self._locate(index)
        return d.get_img_info(i)

    def image_path(self, index):
        d, i = self._locate(index)
        return d.image_path(i)

    def load_image(self, index):
        d, i = self._locate(index)
        return d.load_image(i)

    def load_annotations(self, index):
        d, i = self._locate(index)
        return d.load_annotations(i)

    def aspect_ratios(self):
        import numpy as _np

        return _np.concatenate([d.aspect_ratios() for d in self.datasets])
