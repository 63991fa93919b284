"""Host-side image/box transforms (numpy + PIL).

The port's copy of cpm_tpu/data/transforms.py, after the reference's
pet/utils/data/transforms/transforms.py:11-111
and the fixed composition order in pet/rcnn/datasets/transform.py:37-45:
ColorJitter (off by default) -> Resize (shortest side to a randomly chosen
TRAIN.SCALES entry, capped by MAX_SIZE) -> RandomHorizontalFlip ->
ToTensor -> Normalize (RGB->BGR, x255, subtract caffe pixel means).

Box semantics preserve the reference's integer-coordinate conventions:
h-flip maps x -> W - x - 1 (bounding_box.py:128-166 TO_REMOVE=1).

Train resize uses PIL bilinear (the reference's torchvision F.resize path);
eval uses the same helper (the reference uses cv2 INTER_LINEAR at eval —
numerically close; documented deviation).
"""

from typing import Optional, Sequence, Tuple

import numpy as np
from PIL import Image


def get_resize_size(
    orig_hw: Tuple[int, int], shortest: int, max_size: int
) -> Tuple[int, int]:
    """Target (h, w): shortest side -> `shortest`, longest capped at
    max_size (transforms.py:29-52 get_size)."""
    h, w = orig_hw
    size = shortest
    if max_size is not None:
        min_orig = float(min(h, w))
        max_orig = float(max(h, w))
        if max_orig / min_orig * size > max_size:
            size = int(round(max_size * min_orig / max_orig))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    if w < h:
        ow = size
        oh = int(size * h / w)
    else:
        oh = size
        ow = int(size * w / h)
    return oh, ow


def get_blob_scale_size(
    orig_hw: Tuple[int, int], target_scale: int, max_size: int
):
    """The reference's EVAL-time resize geometry (test.py:343-354
    get_blob): one isotropic scale factor s = target/shortest, recomputed
    as max_size/longest when round(s*longest) > max_size; output size is
    cv2's dsize = (cvRound(w*s), cvRound(h*s)) (round half to even).

    Returns (im_scale, (nh, nw)). Differs from the torchvision/train
    semantics in get_resize_size by up to a pixel per axis.
    """
    h, w = orig_hw
    size_min = float(min(h, w))
    size_max = float(max(h, w))
    im_scale = float(target_scale) / size_min
    if np.round(im_scale * size_max) > max_size:
        im_scale = float(max_size) / size_max
    # cvRound = round half to even, same as python round() on doubles
    nh = int(round(h * im_scale))
    nw = int(round(w * im_scale))
    return im_scale, (nh, nw)


def cv2_linear_resize(image: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """cv2.resize(img, None, None, fx, fy, INTER_LINEAR) on a float32
    image (the reference casts to f32 before resizing, test.py:344).

    Pure-numpy fallback of the native kernel (imageops.cpp
    resize_cv2_linear): dst->src mapping (dst+0.5)/f-0.5 through the
    scale FACTOR (not the size ratio), 2-tap window clamped to the
    image, f32 coefficient math, and cv2's silent INTER_AREA switch when
    both factors are exactly 1/2 (count-normalized tail blocks). Matches
    real cv2 to ~1e-2 absolute in 0..255 units (fp noise; oracle test
    tests/test_cv2_resize.py).
    """
    img = image.astype(np.float32, copy=False)
    h, w = img.shape[:2]
    nw = int(round(w * float(fx)))
    nh = int(round(h * float(fy)))
    scale_x = 1.0 / float(fx)
    scale_y = 1.0 / float(fy)
    if (
        abs(scale_x - round(scale_x)) < 1e-12
        and abs(scale_y - round(scale_y)) < 1e-12
        and round(scale_x) == 2
        and round(scale_y) == 2
    ):
        return _cv2_area2x(img, nh, nw)

    def taps(in_size, out_size, scale):
        f = ((np.arange(out_size, dtype=np.float64) + 0.5) * scale
             - 0.5).astype(np.float32)
        s = np.floor(f).astype(np.int64)
        a = (f - s).astype(np.float32)
        a[s < 0] = 0.0
        s[s < 0] = 0
        a[s >= in_size - 1] = 0.0
        s[s >= in_size - 1] = in_size - 1
        return s, np.minimum(s + 1, in_size - 1), a

    sx, sx1, a = taps(w, nw, scale_x)
    sy, sy1, b = taps(h, nh, scale_y)
    if img.ndim == 3:
        aw = a[None, :, None]
        bw = b[:, None, None]
    else:
        aw = a[None, :]
        bw = b[:, None]
    one = np.float32(1)
    row = img[:, sx] * (one - aw) + img[:, sx1] * aw
    return row[sy] * (one - bw) + row[sy1] * bw


def _cv2_area2x(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """cv2 INTER_AREA fast path for exact 2x downscale: 2x2 block means,
    tail blocks averaged over only the in-bounds samples."""
    h, w = img.shape[:2]
    out = np.zeros((nh, nw) + img.shape[2:], np.float32)
    fh, fw = min(nh, h // 2), min(nw, w // 2)
    blk = img[: 2 * fh, : 2 * fw].astype(np.float32)
    out[:fh, :fw] = 0.25 * (
        blk[0::2, 0::2] + blk[0::2, 1::2] + blk[1::2, 0::2] + blk[1::2, 1::2]
    )
    if nw > fw and w > 2 * fw:  # single-column tail
        col = img[: 2 * fh, 2 * fw].astype(np.float32)
        out[:fh, fw] = 0.5 * (col[0::2] + col[1::2])
    if nh > fh and h > 2 * fh:  # single-row tail
        rowv = img[2 * fh, : 2 * fw].astype(np.float32)
        out[fh, :fw] = 0.5 * (rowv[0::2] + rowv[1::2])
    if nh > fh and nw > fw and h > 2 * fh and w > 2 * fw:
        out[fh, fw] = img[2 * fh, 2 * fw]
    return out


def resize_image_and_boxes(
    image: np.ndarray,
    boxes: np.ndarray,
    shortest: int,
    max_size: int,
):
    """Resize HWC uint8 image (PIL bilinear) + scale boxes. Returns
    (image, boxes, (new_h, new_w))."""
    h, w = image.shape[:2]
    nh, nw = get_resize_size((h, w), shortest, max_size)
    if (nh, nw) != (h, w):
        pil = Image.fromarray(image)
        pil = pil.resize((nw, nh), Image.BILINEAR)
        image = np.asarray(pil)
        ratio_w = nw / w
        ratio_h = nh / h
        boxes = boxes.copy()
        boxes[:, 0::2] *= ratio_w
        boxes[:, 1::2] *= ratio_h
    return image, boxes, (nh, nw)


def hflip_image_and_boxes(image: np.ndarray, boxes: np.ndarray):
    """Horizontal flip with TO_REMOVE=1 box math (bounding_box.py:145-152)."""
    w = image.shape[1]
    image = image[:, ::-1]
    out = boxes.copy()
    out[:, 0] = w - boxes[:, 2] - 1
    out[:, 2] = w - boxes[:, 0] - 1
    return np.ascontiguousarray(image), out


def adjust_brightness(image: np.ndarray, factor: float) -> np.ndarray:
    """uint8 RGB brightness (torchvision 0.6 F.adjust_brightness =
    PIL ImageEnhance.Brightness, the reference's backend)."""
    from PIL import ImageEnhance

    pil = ImageEnhance.Brightness(Image.fromarray(image)).enhance(factor)
    return np.asarray(pil)


def adjust_contrast(image: np.ndarray, factor: float) -> np.ndarray:
    """uint8 RGB contrast (PIL ImageEnhance.Contrast: blend with the
    rounded mean of the L-converted image)."""
    from PIL import ImageEnhance

    pil = ImageEnhance.Contrast(Image.fromarray(image)).enhance(factor)
    return np.asarray(pil)


def adjust_saturation(image: np.ndarray, factor: float) -> np.ndarray:
    """uint8 RGB saturation (PIL ImageEnhance.Color: blend with L
    grayscale)."""
    from PIL import ImageEnhance

    pil = ImageEnhance.Color(Image.fromarray(image)).enhance(factor)
    return np.asarray(pil)


def adjust_hue(image: np.ndarray, factor: float) -> np.ndarray:
    """uint8 RGB hue shift by factor in [-0.5, 0.5] (torchvision 0.6
    F.adjust_hue: HSV roundtrip with uint8-wrapping H shift)."""
    if not -0.5 <= factor <= 0.5:
        raise ValueError(f"hue factor {factor} not in [-0.5, 0.5]")
    pil = Image.fromarray(image)
    h, s, v = pil.convert("HSV").split()
    np_h = np.asarray(h, dtype=np.uint8)
    # uint8 wraparound shift, matching torchvision's `np_h += uint8(...)`
    # (old-numpy modular float->uint8 cast: truncate toward zero, mod 256)
    shift = int(factor * 255) % 256
    np_h = (np_h.astype(np.int16) + shift).astype(np.uint8)
    h = Image.fromarray(np_h, "L")
    return np.asarray(Image.merge("HSV", (h, s, v)).convert("RGB"))


class ColorJitter:
    """Photometric jitter matching torchvision 0.6 ColorJitter, the
    backend of the reference's T.ColorJitter
    (pet/utils/data/transforms/transforms.py:78-93,
    driven by cfg.TRAIN.BRIGHTNESS/CONTRAST/SATURATION/HUE and composed
    FIRST, before Resize — pet/rcnn/datasets/transform.py:30-45).

    Scalar args b/c/s sample a factor uniformly from [max(0,1-v), 1+v];
    hue from [-v, v]. A 0.0 arg disables that op (torchvision's
    _check_input -> None). The enabled ops run in a random order.
    """

    _OPS = (
        ("brightness", adjust_brightness),
        ("contrast", adjust_contrast),
        ("saturation", adjust_saturation),
        ("hue", adjust_hue),
    )

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0,
                 hue=0.0):
        self.brightness = float(brightness)
        self.contrast = float(contrast)
        self.saturation = float(saturation)
        self.hue = float(hue)
        if not 0.0 <= self.hue <= 0.5:
            raise ValueError(f"TRAIN.HUE must be in [0, 0.5], got {hue}")
        self.enabled = any(
            getattr(self, name) > 0 for name, _ in self._OPS
        )

    def __call__(self, image: np.ndarray, rng: np.random.RandomState):
        if not self.enabled:
            return image
        ops = []
        for name, fn in self._OPS:
            v = getattr(self, name)
            if v <= 0:
                continue
            if name == "hue":
                factor = rng.uniform(-v, v)
            else:
                factor = rng.uniform(max(0.0, 1.0 - v), 1.0 + v)
            ops.append((fn, factor))
        for i in rng.permutation(len(ops)):
            fn, factor = ops[i]
            image = fn(image, factor)
        return image


def normalize_image(
    image: np.ndarray,
    pixel_means: Sequence[float],
    pixel_stds: Sequence[float] = (1.0, 1.0, 1.0),
    to_bgr255: bool = True,
) -> np.ndarray:
    """uint8 RGB HWC -> float32 normalized (transforms.py:96-111).

    to_bgr255: channel-swap to BGR and keep the 0..255 range (caffe-style
    models), then (x - mean) / std.
    """
    img = image.astype(np.float32)
    if to_bgr255:
        img = img[:, :, ::-1]
    else:
        img = img / 255.0
    mean = np.asarray(pixel_means, np.float32)
    std = np.asarray(pixel_stds, np.float32)
    return (img - mean) / std


def to_model_channel_order(image: np.ndarray, to_bgr255: bool) -> np.ndarray:
    """uint8 RGB -> uint8 in the model's expected channel order (no
    normalization — the model applies the input affine on device)."""
    if to_bgr255:
        return np.ascontiguousarray(image[:, :, ::-1])
    return np.ascontiguousarray(image)


class TrainTransform:
    """Random-scale resize + random hflip + normalize (or, with
    normalize=False, uint8 output in model channel order for device-side
    normalization)."""

    def __init__(self, cfg, normalize: bool = True):
        self.scales = tuple(cfg.TRAIN.SCALES)
        self.max_size = cfg.TRAIN.MAX_SIZE
        self.flip_prob = 0.5  # RandomHorizontalFlip(0.5), transform.py:37-45
        self.color_jitter = ColorJitter(
            cfg.TRAIN.BRIGHTNESS, cfg.TRAIN.CONTRAST,
            cfg.TRAIN.SATURATION, cfg.TRAIN.HUE,
        )
        self.pixel_means = tuple(cfg.PIXEL_MEANS)
        self.pixel_stds = tuple(cfg.PIXEL_STDS)
        self.to_bgr255 = bool(cfg.TO_BGR255)
        self.normalize = normalize

    def __call__(self, image, boxes, rng: np.random.RandomState):
        if self.color_jitter.enabled:
            image = self.color_jitter(image, rng)
        shortest = self.scales[rng.randint(len(self.scales))]
        image, boxes, size = resize_image_and_boxes(
            image, boxes, shortest, self.max_size
        )
        if rng.rand() < self.flip_prob:
            image, boxes = hflip_image_and_boxes(image, boxes)
        if self.normalize:
            image = normalize_image(
                image, self.pixel_means, self.pixel_stds, self.to_bgr255
            )
        else:
            image = to_model_channel_order(image, self.to_bgr255)
        return image, boxes, size


class TestTransform:
    """Fixed-scale resize + normalize. Returns the resize scale for
    mapping detections back to original coordinates.

    backend='cv2' (the default via TPU.EVAL_RESIZE) reproduces the
    reference's eval resize exactly: cv2 INTER_LINEAR on the f32 image
    at one isotropic im_scale, dsize = cvRound sizes (test.py:343-354).
    backend='pil' keeps the antialias train-resize (legacy behavior,
    a documented deviation)."""

    def __init__(self, cfg, scale: Optional[int] = None,
                 max_size: Optional[int] = None, normalize: bool = True,
                 backend: Optional[str] = None):
        self.scale = scale if scale is not None else cfg.TEST.SCALE
        self.max_size = max_size if max_size is not None else cfg.TEST.MAX_SIZE
        self.pixel_means = tuple(cfg.PIXEL_MEANS)
        self.pixel_stds = tuple(cfg.PIXEL_STDS)
        self.to_bgr255 = bool(cfg.TO_BGR255)
        self.normalize = normalize
        self.backend = (
            backend
            if backend is not None
            else str(getattr(cfg.TPU, "EVAL_RESIZE", "cv2"))
        )

    def resolve_size(self, orig_hw: Tuple[int, int]) -> Tuple[int, int]:
        """(nh, nw) the eval pipeline will produce for an image of
        orig_hw under this transform's backend."""
        if self.backend == "cv2":
            _, (nh, nw) = get_blob_scale_size(
                orig_hw, self.scale, self.max_size
            )
            return nh, nw
        return get_resize_size(orig_hw, self.scale, self.max_size)

    def __call__(self, image):
        h, w = image.shape[:2]
        if self.backend == "cv2":
            im_scale, (nh, nw) = get_blob_scale_size(
                (h, w), self.scale, self.max_size
            )
            resized = cv2_linear_resize(image, im_scale, im_scale)
            if self.normalize:
                # normalize_image handles f32 input (astype is a no-op)
                image = normalize_image(
                    resized, self.pixel_means, self.pixel_stds,
                    self.to_bgr255,
                )
            else:
                # uint8 for the device-side input affine: round after the
                # f32 resize (the only quantization on this path; below
                # the bf16 compute cast — docs/AB_DEVIATIONS.md)
                resized = np.clip(resized + 0.5, 0, 255).astype(np.uint8)
                image = to_model_channel_order(resized, self.to_bgr255)
            return image, (nh, nw), (nh / h, nw / w)
        dummy = np.zeros((0, 4), np.float32)
        image, _, (nh, nw) = resize_image_and_boxes(
            image, dummy, self.scale, self.max_size
        )
        if self.normalize:
            image = normalize_image(
                image, self.pixel_means, self.pixel_stds, self.to_bgr255
            )
        else:
            image = to_model_channel_order(image, self.to_bgr255)
        return image, (nh, nw), (nh / h, nw / w)
