"""Dataset catalog: name -> image dir + annotation file.

The port's copy of cpm_tpu/data/catalog.py: the reference's COCO 2017
entries (pet/utils/data/dataset_catalog.py:34-57), relative to cfg.DATA_DIR.
"""

import os

_CATALOG = {
    "coco_2017_train": dict(
        image_directory="coco/images/train2017",
        annotation_file="coco/annotations/instances_train2017.json",
    ),
    "coco_2017_val": dict(
        image_directory="coco/images/val2017",
        annotation_file="coco/annotations/instances_val2017.json",
    ),
    "coco_2017_test-dev": dict(
        image_directory="coco/images/test2017",
        annotation_file="coco/annotations/image_info_test-dev2017.json",
    ),
    "coco_2017_test": dict(
        image_directory="coco/images/test2017",
        annotation_file="coco/annotations/image_info_test2017.json",
    ),
}


def contains(name: str) -> bool:
    return name in _CATALOG


def get_im_dir(data_dir: str, name: str) -> str:
    return os.path.join(data_dir, _CATALOG[name]["image_directory"])


def get_ann_fn(data_dir: str, name: str) -> str:
    return os.path.join(data_dir, _CATALOG[name]["annotation_file"])


def register(name: str, image_directory: str, annotation_file: str):
    """Add a dataset at runtime (the reference edits the catalog dict)."""
    _CATALOG[name] = dict(
        image_directory=image_directory, annotation_file=annotation_file
    )
