"""Iteration-based train and eval loaders with fixed-shape batches.

The port's copy of cpm_tpu/data/loader.py, numpy and PIL on the host (no
torch: batches are numpy arrays, moved to the device by the train step and
the eval forward). It replaces the reference's sampler stack:
  * DistributedSampler (epoch-seeded shuffle + pad-divide + rank slice,
    pet/utils/data/samplers/distributed.py:7-63) -> per-rank index slices;
  * GroupedBatchSampler (aspect-ratio buckets, grouped_batch_sampler.py)
    -> two orientation groups, batches drawn within a group;
  * IterationBasedBatchSampler (infinite re-iteration to MAX_ITER) ->
    epoch cycling inside the iterator;
  * BatchCollator + to_image_list -> fixed bucket padding into one NHWC
    array per batch.

Every batch has one of a small set of static shapes — a landscape bucket
(short_max x long_max) and its portrait transpose — and ground truth padded
to TRAIN.MAX_GT_BOXES with masks, so each conv shape is planned once.

Images are decoded where the JAX loaders decode them: by the native C++
decode pool (cpm_tpu_torch/native, the port's copy of cpm_tpu/native)
whenever that library builds, and by PIL otherwise, so that either way this
loader's batches are the JAX loader's bit for bit on the same path
(tests/test_torch_data.py, tests/test_torch_native.py). A library that does
not build warns once (cpm_tpu_torch/native.load) and each loader records
the path it takes in `decode_path` ('native' or 'pil') and the images each
path made in `decoded`; the CLIs print it. On the native path:
  * TrainLoader decodes a batch through an `ImagePool` of
    `DECODE_WORKERS` threads, opened when an iteration starts and closed
    when it ends, beneath the prefetch thread. Each
    image's draws are the JAX package's (the scale, then the flip); the
    flip comes after the resize. An image that does not decode falls back
    to PIL, as in the JAX package. Like the JAX native path it never
    applies TRAIN.BRIGHTNESS / CONTRAST / SATURATION / HUE: the color
    jitter runs on the PIL path only (ROADMAP Queue 3, item 35).
  * TestLoader decodes, resizes (cv2's INTER_LINEAR mapping or PIL's
    taps, per TPU.EVAL_RESIZE) and pads an image in one call; a TTA flip
    pass takes the PIL path, which flips the raw image before resizing.
"""

import queue as queue_mod
import threading
from typing import Iterator, Optional

import numpy as np

from cpm_tpu_torch.data.coco import COCODataset
from cpm_tpu_torch.data.transforms import (
    TestTransform,
    TrainTransform,
    get_blob_scale_size,
    get_resize_size,
)
from cpm_tpu_torch.structures.image_batch import round_up
from cpm_tpu_torch.utils.spans import span


PREFETCH_THREAD = "TrainLoader-prefetch"  # the name of the thread that makes the batches
# the native pool's threads: the JAX loader reads DATALOADER.NUM_WORKERS,
# which neither config tree holds (so no YAML can set it), with a default of 4
DECODE_WORKERS = 4


def _native():
    """The native decode library's bindings, or None when it does not build
    here (then the loaders decode with PIL)."""
    from cpm_tpu_torch import native

    return native if native.load() is not None else None


def describe_decode_path(loaders) -> str:
    """The CLIs' line for the path that `loaders` decode on: 'native' (with
    the library's build time when this process built it), 'pil' (with the
    build's first error line when it failed), or both, by pass."""
    from cpm_tpu_torch import native

    paths = [loader.decode_path for loader in loaders]
    status = native.status()
    if "native" in paths:
        text = "native"
        if status is not None and status.seconds:
            text += f" (cpm_tpu_torch/native built in {status.seconds:.2f} s)"
        n_pil = paths.count("pil")
        return text + (f"; pil for {n_pil} flip pass{'es' if n_pil > 1 else ''}" if n_pil else "")
    if status is not None and not status.built:
        return f"pil (the native library did not build: {status.error.splitlines()[0]})"
    return "pil"


def _resized_boxes(boxes, orig_hw, new_hw, flip: bool):
    """A native-path image's boxes: scaled to its resize, then flipped with
    it (the JAX package's arithmetic)."""
    (oh, ow), (nh, nw) = orig_hw, new_hw
    b = boxes.copy()
    b[:, 0::2] *= nw / ow
    b[:, 1::2] *= nh / oh
    if flip:
        fb = b.copy()
        fb[:, 0] = nw - b[:, 2] - 1
        fb[:, 2] = nw - b[:, 0] - 1
        b = fb
    return b


def compute_buckets(scales, max_size, divisibility: int):
    """(short, long) padded bucket extents covering every train resize."""
    short = round_up(max(scales), divisibility)
    long = round_up(max_size, divisibility)
    return short, long


class TrainLoader:
    """Yields fixed-shape train batches forever (the caller stops at
    MAX_ITER). Set `start_iter` before iterating to resume a stream."""

    def __init__(
        self,
        cfg,
        dataset: COCODataset,
        batch_size: int,
        *,
        rank: int = 0,
        world_size: int = 1,
        seed: int = 0,
        start_iter: int = 0,
        prefetch: int = 2,
    ):
        self.cfg = cfg
        self.dataset = dataset
        self.batch_size = batch_size
        self.rank = rank
        self.world_size = world_size
        self.seed = seed
        self.start_iter = start_iter
        # device_normalize: ship raw uint8 (1/4 the host->device bytes); the
        # model applies the input affine on the device
        # (GeneralizedRCNN._normalize_uint8)
        self.device_normalize = bool(getattr(cfg.TPU, "DEVICE_NORMALIZE", False))
        self.transform = TrainTransform(cfg, normalize=not self.device_normalize)
        self.max_gt = cfg.TRAIN.MAX_GT_BOXES
        self.divisibility = cfg.TRAIN.SIZE_DIVISIBILITY
        short, long = compute_buckets(cfg.TRAIN.SCALES, cfg.TRAIN.MAX_SIZE, self.divisibility)
        self.buckets = {"landscape": (short, long), "portrait": (long, short)}
        self.aspect = dataset.aspect_ratios()
        self.prefetch = prefetch
        # DATALOADER.SAMPLER_TRAIN (the reference wires it at
        # rcnn/datasets/dataset.py:51-52): RepeatFactorTrainingSampler
        # repeats rare-category images per epoch; the default has
        # DistributedSampler semantics. Repeat factors are fixed for the
        # whole run, computed once here (repeat_factor.py:62-65).
        self.sampler_train = str(getattr(cfg.DATALOADER, "SAMPLER_TRAIN", "DistributedSampler"))
        self._repeat_factors = None
        if self.sampler_train == "RepeatFactorTrainingSampler":
            from cpm_tpu_torch.data.samplers import repeat_factors_from_category_frequency

            rft = cfg.DATALOADER.RFTSAMPLER
            self._repeat_factors = repeat_factors_from_category_frequency(
                dataset,
                repeat_thresh=float(rft.REPEAT_THRESHOLD),
                pow_=float(rft.POW),
                max_repeat=float(rft.MAX_REPEAT_TIMES),
                min_repeat=float(rft.MIN_REPEAT_TIMES),
            )
        # the native decode path (the JAX loader's default): a pool of
        # DECODE_WORKERS threads decodes each batch while an iteration runs
        self.native = _native()
        self.decode_path = "native" if self.native is not None else "pil"
        self.decoded = {"native": 0, "pil": 0}  # images made by each path

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        """One epoch of per-rank dataset indices.

        DistributedSampler semantics (seeded shuffle, pad, strided rank
        slice) by default; RepeatFactorTrainingSampler (stochastic-ceil
        repetition + shuffle + contiguous rank slice, repeat_factor.py:131-155)
        when DATALOADER.SAMPLER_TRAIN selects it."""
        if self._repeat_factors is not None:
            from cpm_tpu_torch.data.samplers import repeat_factor_indices

            idx = repeat_factor_indices(self._repeat_factors, self.seed + epoch)
            # the reference takes contiguous per-rank slices of the (already
            # shuffled) repeated list, TRUNCATING the final < world_size
            # remainder (repeat_factor.py:148-151) — deliberately not the
            # padded semantics of the branch below
            per_rank = len(idx) // self.world_size
            return idx[self.rank * per_rank : (self.rank + 1) * per_rank]
        g = np.random.RandomState(self.seed + epoch)
        idx = g.permutation(len(self.dataset))
        total = ((len(idx) + self.world_size - 1) // self.world_size) * self.world_size
        idx = np.concatenate([idx, idx[: total - len(idx)]])
        return idx[self.rank :: self.world_size]

    def _group_batches(self, indices: np.ndarray, epoch: int, carry=None):
        """Aspect-ratio-grouped batches (GroupedBatchSampler).

        The reference's GroupedBatchSampler(drop_uneven=False) keeps each
        group's tail as a short final batch. Fixed-shape batches cannot
        shrink, so the tail indices are carried into the same group's pool
        at the next epoch: no image is ever dropped, every batch is full.
        Returns (batches, carry_out), carry_out mapping group -> leftover
        indices."""
        groups = {0: list((carry or {}).get(0, ())), 1: list((carry or {}).get(1, ()))}
        for i in indices:
            groups[int(self.aspect[i] >= 1)].append(i)
        batches = []
        carry_out = {0: [], 1: []}
        for k, g in groups.items():
            n_full = len(g) // self.batch_size
            for s in range(0, n_full * self.batch_size, self.batch_size):
                batches.append(g[s : s + self.batch_size])
            carry_out[k] = g[n_full * self.batch_size :]
        rng = np.random.RandomState(self.seed * 7919 + epoch)
        rng.shuffle(batches)
        return batches, carry_out

    def _load_one(self, i: int, rng: np.random.RandomState):
        """(image [nh, nw, 3], boxes, labels, (nh, nw)) of one image: the
        native fused decode when the library is built (the scale drawn
        before the decode, the flip after it), PIL and the train transform
        (color jitter, resize, flip) otherwise or when the bytes do not
        decode."""
        boxes, labels = self.dataset.load_annotations(i)
        if self.native is not None:
            info = self.dataset.get_img_info(i)
            oh, ow = info["height"], info["width"]
            shortest = self.transform.scales[rng.randint(len(self.transform.scales))]
            nh, nw = get_resize_size((oh, ow), shortest, self.transform.max_size)
            try:
                with open(self.dataset.image_path(i), "rb") as f:
                    data = f.read()
                if self.device_normalize:
                    img, _ = self.native.decode_resize_u8(
                        data, (nh, nw), (nh, nw), self.transform.to_bgr255)
                else:
                    img, _ = self.native.decode_resize_normalize(
                        data, (nh, nw), (nh, nw), self.transform.pixel_means,
                        self.transform.pixel_stds, self.transform.to_bgr255)
                flip = rng.rand() < self.transform.flip_prob
                if flip:
                    img = np.ascontiguousarray(img[:, ::-1])
                self.decoded["native"] += 1
                return img, _resized_boxes(boxes, (oh, ow), (nh, nw), flip), labels, (nh, nw)
            except RuntimeError:
                pass  # not decodable by the native library: PIL
        img = self.dataset.load_image(i)
        img, boxes, size = self.transform(img, boxes, rng)
        self.decoded["pil"] += 1
        return img, boxes, labels, size

    def _load_batch_pooled(self, batch_indices, rng: np.random.RandomState, pool):
        """The whole batch decoded by `pool`, in batch order, as a list
        of (img, boxes, labels, size); or None when an image failed, after
        every task of the batch has been collected (so that none is left in
        the pool for the next batch). The caller then loads the batch one
        image at a time, `rng` past this plan's draws, as the JAX loader
        does."""
        plan = []
        for i in batch_indices:
            info = self.dataset.get_img_info(i)
            oh, ow = info["height"], info["width"]
            shortest = self.transform.scales[rng.randint(len(self.transform.scales))]
            nh, nw = get_resize_size((oh, ow), shortest, self.transform.max_size)
            flip = rng.rand() < self.transform.flip_prob
            plan.append((i, (oh, ow), (nh, nw), flip))
        padded = (max(p[2][0] for p in plan), max(p[2][1] for p in plan))
        for t, (i, _, resized, _) in enumerate(plan):
            if self.device_normalize:
                pool.submit_u8(t, self.dataset.image_path(i), resized, padded,
                               self.transform.to_bgr255)
            else:
                pool.submit(t, self.dataset.image_path(i), resized, padded,
                            self.transform.pixel_means, self.transform.pixel_stds,
                            self.transform.to_bgr255)
        wait = pool.wait_any_u8 if self.device_normalize else pool.wait_any
        decoded, failed = [None] * len(plan), False
        for _ in plan:
            try:
                t, img, _ = wait(padded)
            except RuntimeError:  # a worker failed (e.g. an undecodable file)
                failed = True
                continue
            decoded[t] = img
        if failed:
            return None
        out = []
        for (i, orig, (nh, nw), flip), img in zip(plan, decoded):
            img = img[:nh, :nw]
            if flip:
                img = np.ascontiguousarray(img[:, ::-1])
            boxes, labels = self.dataset.load_annotations(i)
            out.append((img, _resized_boxes(boxes, orig, (nh, nw), flip), labels, (nh, nw)))
        self.decoded["native"] += len(out)
        return out

    def _make_batch(self, batch_indices, rng: np.random.RandomState, pool=None):
        """One batch: through `pool` (the native ImagePool of the running
        iteration) when there is one, else one image at a time."""
        loaded = self._load_batch_pooled(batch_indices, rng, pool) if pool is not None else None
        if loaded is None:
            loaded = [self._load_one(i, rng) for i in batch_indices]
        landscape_votes = sum(int(img.shape[1] >= img.shape[0]) for img, *_ in loaded)
        bh, bw = (
            self.buckets["landscape"]
            if landscape_votes * 2 >= len(loaded)
            else self.buckets["portrait"]
        )
        B = len(loaded)
        img_dtype = np.uint8 if self.device_normalize else np.float32
        out_images = np.zeros((B, bh, bw, 3), img_dtype)
        out_sizes = np.zeros((B, 2), np.int32)
        gt_boxes = np.zeros((B, self.max_gt, 4), np.float32)
        gt_labels = np.zeros((B, self.max_gt), np.int32)
        gt_mask = np.zeros((B, self.max_gt), bool)
        for b, (img, boxes, labels, _) in enumerate(loaded):
            h, w = img.shape[:2]
            h2, w2 = min(h, bh), min(w, bw)
            out_images[b, :h2, :w2] = img[:h2, :w2]
            out_sizes[b] = (h2, w2)
            k = min(len(boxes), self.max_gt)
            gt_boxes[b, :k] = boxes[:k]
            gt_labels[b, :k] = labels[:k]
            gt_mask[b, :k] = True
        return dict(
            images=out_images,
            image_sizes=out_sizes,
            gt_boxes=gt_boxes,
            gt_labels=gt_labels,
            gt_mask=gt_mask,
        )

    def _open_pool(self):
        """An ImagePool of DECODE_WORKERS threads on the native path, else
        None."""
        return None if self.native is None else self.native.ImagePool(DECODE_WORKERS)

    def _raw_iter(self) -> Iterator[dict]:
        """Yields batches from iteration `start_iter` onward.

        Resume parity with the reference (IterationBasedBatchSampler
        restarted at scheduler.iteration, tools/rcnn/train_net.py:127): the
        epoch and batch position are fast-forwarded by replaying the cheap
        index math — never decoding an image — so a resumed run sees the
        batch stream an uninterrupted run would. The native pool lives
        while this generator does, one for each iteration."""
        pool = self._open_pool()
        try:
            it = 0
            epoch = 0
            carry = None
            while True:
                indices = self._epoch_indices(epoch)
                batches, carry = self._group_batches(indices, epoch, carry)
                if not batches and not any(carry.values()):
                    raise RuntimeError("TrainLoader: empty epoch (no images)")
                if it + len(batches) <= self.start_iter:
                    it += len(batches)  # skip a fully consumed epoch
                    epoch += 1
                    continue
                skip = max(0, self.start_iter - it)
                it += skip
                for batch_indices in batches[skip:]:
                    rng = np.random.RandomState(
                        (self.seed * 1_000_003 + it * 97 + self.rank) % (2**31)
                    )
                    yield self._make_batch(batch_indices, rng, pool)
                    it += 1
                epoch += 1
        finally:
            if pool is not None:
                pool.close()

    def __iter__(self) -> Iterator[dict]:
        """The batches, made `prefetch` ahead on a thread of their own. The
        thread ends, and closes the native pool, when this generator is
        closed (or collected); an error it meets is raised here."""
        if self.prefetch <= 0:
            yield from self._raw_iter()
            return
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    pass
            return False

        def worker():
            batches = self._raw_iter()
            try:
                for item in batches:
                    if not put(item):
                        return
                put(done)
            except Exception as e:  # handed to the consumer, raised there
                put(e)
            finally:
                batches.close()  # closes the native pool on this thread

        t = threading.Thread(target=worker, daemon=True, name=PREFETCH_THREAD)
        t.start()
        try:
            while True:
                with span("cpm/data/wait"):
                    item = q.get()
                if item is done:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()


class TestLoader:
    """Eval batches of TEST.IMS_PER_GPU images (reference default 1; more
    groups same-orientation images into one padded bucket), each image
    resized by the eval transform and padded to the fixed eval bucket."""

    def __init__(
        self,
        cfg,
        dataset: COCODataset,
        *,
        start: int = 0,
        end: Optional[int] = None,
        scale: Optional[int] = None,
        max_size: Optional[int] = None,
        hflip: bool = False,
        batch_size: Optional[int] = None,
    ):
        self.cfg = cfg
        self.dataset = dataset
        self.start = start
        self.end = len(dataset) if end is None else end
        self.device_normalize = bool(getattr(cfg.TPU, "DEVICE_NORMALIZE", False))
        self.transform = TestTransform(
            cfg, scale=scale, max_size=max_size, normalize=not self.device_normalize,
        )
        self.divisibility = cfg.TEST.SIZE_DIVISIBILITY
        scale_v = scale if scale is not None else cfg.TEST.SCALE
        max_v = max_size if max_size is not None else cfg.TEST.MAX_SIZE
        short = round_up(scale_v, self.divisibility)
        long = round_up(max_v, self.divisibility)
        self.buckets = {"landscape": (short, long), "portrait": (long, short)}
        self.hflip = hflip
        self.batch_size = (
            int(batch_size)
            if batch_size is not None
            else max(1, int(getattr(cfg.TEST, "IMS_PER_GPU", 1)))
        )
        # the native fused decode (the JAX loader's default), except under a
        # TTA flip: the reference flips the RAW image before resizing
        # (test.py:342-343) and the fused op resizes first, so that a flip
        # after it would differ sub-pixel under cv2's mapping; a flip pass
        # takes the PIL path, which flips the raw image, then resizes
        self.native = None if hflip else _native()
        self.decode_path = "native" if self.native is not None else "pil"
        self.decoded = {"native": 0, "pil": 0}  # images made by each path

    def __len__(self):
        return self.end - self.start

    def _load_native(self, i: int):
        """(padded img, (nh, nw), (orig_h, orig_w)) from the native fused
        op, or None when it cannot decode the file."""
        info = self.dataset.get_img_info(i)
        oh, ow = info["height"], info["width"]
        interp = self.transform.backend  # 'cv2' (the reference's eval resize) or 'pil'
        if interp == "cv2":
            im_scale, (nh, nw) = get_blob_scale_size(
                (oh, ow), self.transform.scale, self.transform.max_size)
            scale_xy = (im_scale, im_scale)
        else:
            nh, nw = get_resize_size((oh, ow), self.transform.scale, self.transform.max_size)
            scale_xy = (1.0, 1.0)
        bucket = self.buckets["landscape"] if nw >= nh else self.buckets["portrait"]
        try:
            with open(self.dataset.image_path(i), "rb") as f:
                data = f.read()
            with span("cpm/data/decode"):
                if self.device_normalize:
                    img, _ = self.native.decode_resize_u8(
                        data, (nh, nw), bucket, self.transform.to_bgr255, interp=interp,
                        scale_xy=scale_xy)
                else:
                    img, _ = self.native.decode_resize_normalize(
                        data, (nh, nw), bucket, self.transform.pixel_means,
                        self.transform.pixel_stds, self.transform.to_bgr255, interp=interp,
                        scale_xy=scale_xy)
        except RuntimeError:
            return None
        return img, (nh, nw), (oh, ow)

    def _load_one_test(self, i: int):
        """(padded img [bh, bw, 3], (nh, nw), meta dict, bucket key)"""
        native_out = self._load_native(i) if self.native is not None else None
        if native_out is not None:
            img, (nh, nw), (orig_h, orig_w) = native_out
            scale_hw = (nh / orig_h, nw / orig_w)
            self.decoded["native"] += 1
        else:
            with span("cpm/data/decode"):
                raw = self.dataset.load_image(i)
                if self.hflip:
                    raw = np.ascontiguousarray(raw[:, ::-1])
                norm, (nh, nw), scale_hw = self.transform(raw)
            orig_h, orig_w = raw.shape[:2]
            bh, bw = self.buckets["landscape"] if nw >= nh else self.buckets["portrait"]
            img = np.zeros((bh, bw, 3), np.uint8 if self.device_normalize else np.float32)
            img[:nh, :nw] = norm[:bh, :bw]
            self.decoded["pil"] += 1
        key = "landscape" if nw >= nh else "portrait"
        meta = dict(
            index=i,
            image_id=self.dataset.id_to_img_map[i],
            orig_size=(orig_h, orig_w),
            scale_hw=scale_hw,
        )
        return img, (nh, nw), meta, key

    def _emit(self, buf):
        """buf: list of (img, (nh, nw), meta). Pads partial batches by
        repeating the last image; `count` marks the real images."""
        count = len(buf)
        while len(buf) < self.batch_size:
            buf.append(buf[-1])
        images = np.stack([b[0] for b in buf])
        sizes = np.array([b[1] for b in buf], np.int32)
        out = dict(
            images=images,
            image_sizes=sizes,
            meta=[b[2] for b in buf[:count]],
            count=count,
        )
        if self.batch_size == 1:
            out.update(buf[0][2])  # per-image keys
        return out

    def __iter__(self):
        # per-orientation buffers: all TTA passes of one image share its
        # aspect ratio, so parallel TestLoaders group identically
        buffers = {"landscape": [], "portrait": []}
        order = []  # flush order, so that iteration stays deterministic
        for i in range(self.start, self.end):
            with span("cpm/data/load"):
                img, size, meta, key = self._load_one_test(i)
            buffers[key].append((img, size, meta))
            if len(buffers[key]) == self.batch_size:
                yield self._emit(buffers[key])
                buffers[key] = []
            if key not in order:
                order.append(key)
        for key in order:
            if buffers[key]:
                yield self._emit(buffers[key])
