"""What every mode shares: sub-seeds, the run's record, the data tree, the
weights handed to both sides, and the reference's precision settings."""

import hashlib
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import models, weights
from benchmark.traffic import write_coco_tree

FOLD_IMAGES = 4  # images whose statistics set the trunk's frozen affines


def subseed(seed: int, tag: str, below: int = 2 ** 31 - 2 ** 20) -> int:
    """A seed under `below` for one use of the run's seed (numpy's
    generators take at most 32 bits; the run's may be larger)."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:4], "little") % below


# TrainLoader seeds numpy with seed * 7919 + epoch, which must stay under 2**32
LOADER_SEEDS = 500_000


def log(msg: str):
    print(msg, flush=True)


def free(device):
    """Collect what was dropped and hand the card's cached blocks back."""
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclass
class Run:
    """What a run measured and what its check read."""
    attempted: int = 0
    failed: int = 0
    images: int = 0
    window_s: float = 0.0
    setup_s: float = 0.0
    peak_window_bytes: int = 0
    peak_bytes: int = 0
    host: Dict[str, List[float]] = field(default_factory=dict)
    numbers: Dict[str, float] = field(default_factory=dict)
    trace: Optional[object] = None
    bounds: Dict[str, float] = field(default_factory=dict)
    traced_units: int = 0
    captured_units: int = 0
    flops_per_image: float = 0.0


@dataclass
class Prepared:
    pcfg: object
    rcfg: object
    tree: dict
    state: dict          # the weights, on the host


_TF32_DEFAULTS = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def reference_precision(on: bool = True):
    """float32 products without TF32 for the reference's phases; PyTorch's
    defaults again, as a user runs the port, when `on` is False."""
    matmul, cudnn = (False, False) if on else _TF32_DEFAULTS
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


def prepare(cell, seed: int, device, workdir: str, train_images: int = 0) -> Prepared:
    """The data tree, both configs, and the weights: drawn on `device`, the
    offset convs spread and the affines folded on the reference model in
    float32, then moved to the host (so that the port's memory peak holds
    only its own copy)."""
    from cpm_tpu_torch import config as port_config

    from benchmark.reference import config as ref_config
    from benchmark.reference.data.coco import COCODataset
    from benchmark.reference.data.loader import TestLoader

    t = time.perf_counter()
    tree = write_coco_tree(cell.mix, subseed(seed, "images"), workdir)
    log(f"[setup] {cell.mix['images']} images written in {time.perf_counter() - t:.2f} s")
    pcfg = models.make_config(cell.config, port_config, train_images)
    rcfg = models.make_config(cell.config, ref_config, train_images)
    rcfg.TPU.COMPUTE_DTYPE = "float32"
    # a batch of the tree's own images at the eval scale, decoded by the
    # reference, sets the frozen affines
    rdata = COCODataset(tree["annotations"], tree["images"])
    items = []
    for item in TestLoader(rcfg, rdata):
        if item["images"].shape[2] >= item["images"].shape[1]:
            items.append(item["images"][0])
        if len(items) == FOLD_IMAGES:
            break
    fold = torch.as_tensor(np.stack(items), device=device)
    t = time.perf_counter()
    reference_precision(True)
    meta = models.reference_meta(rcfg)
    t_meta = time.perf_counter()
    state = weights.make_state(meta, subseed(seed, "weights"), device)
    ref = models.on_device(meta, state, device)
    del state
    n_offsets = weights.spread_offset_convs(ref, subseed(seed, "offsets"))
    n_iou = weights.condition_iou_predictors(ref)
    sync(device)
    t_draw = time.perf_counter()
    n_affines = weights.fold_batch_statistics(ref, fold)
    sync(device)
    t_fold = time.perf_counter()
    host = {k: v.detach().to("cpu") for k, v in ref.state_dict().items()}
    del ref
    reference_precision(False)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    log(f"[setup] weights: {len(host)} tensors, {sum(v.numel() for v in host.values())} values "
        f"drawn on {device}, {n_offsets} offset convs spread, {n_iou} IoU predictors set, "
        f"{n_affines} affines folded, in {time.perf_counter() - t:.2f} s (meta build "
        f"{t_meta - t:.2f}, draws {t_draw - t_meta:.2f}, fold {t_fold - t_draw:.2f}, to host "
        f"{time.perf_counter() - t_fold:.2f})")
    return Prepared(pcfg=pcfg, rcfg=rcfg, tree=tree, state=host)


def control_config(prep):
    """The reference's config in the port's compute dtype, for the control
    (reference/precision.py)."""
    import copy

    cfg = copy.deepcopy(prep.rcfg)
    cfg.TPU.COMPUTE_DTYPE = prep.pcfg.TPU.COMPUTE_DTYPE
    return cfg


def jax_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    banned = {"jax", "jaxlib", "flax", "cpm_tpu"}
    return sorted({m.split(".")[0] for m in list(sys.modules) if m.split(".")[0] in banned})
