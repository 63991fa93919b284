"""COCO evaluation: the port's copy of cpm_tpu/evaluation."""
