"""Host-side eval preprocessing (port of `tf_eager_object_detection_tpu/data/preprocessing.py`).

The serving half of the JAX module, on numpy: the reference's resize rule
(scale = min(min_size/min(h,w), max_size/max(h,w)), new size int(scale*dim)),
caffe or tf normalization, and zero padding right/bottom into the smallest
static bucket of `tpu_image_buckets` that fits. As in the JAX module, cv2
resizes when it is installed and a numpy bilinear (half-pixel) resize runs
otherwise. The training half (flip, gt boxes) comes with the training port.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

__all__ = [
    "compute_scale",
    "caffe_normalize",
    "tf_normalize",
    "resize_image",
    "pick_bucket",
    "pad_to_bucket",
    "preprocess_eval_image",
]


def compute_scale(h: int, w: int, min_size: int, max_size: int) -> float:
    return min(min_size / min(h, w), max_size / max(h, w))


def caffe_normalize(
    image_rgb: np.ndarray, bgr_means: Sequence[float], means_dtype=np.float32
) -> np.ndarray:
    """RGB -> BGR minus pixel means, float32 out.

    `means_dtype` float64 reproduces the reference's eval path, which
    subtracts a float64 means array and casts back (the last f32 ulp differs
    from a float32 subtract).
    """
    img = image_rgb.astype(np.float32)[..., ::-1]
    out = img - np.asarray(bgr_means, means_dtype)
    return out.astype(np.float32, copy=False)


def tf_normalize(image_rgb: np.ndarray) -> np.ndarray:
    return image_rgb.astype(np.float32) / 255.0 * 2.0 - 1.0


def resize_image(image: np.ndarray, scale: float) -> np.ndarray:
    h, w = image.shape[:2]
    nh, nw = int(scale * h), int(scale * w)
    if cv2 is not None:
        return cv2.resize(image, (nw, nh), interpolation=cv2.INTER_LINEAR)
    ys = (np.arange(nh) + 0.5) * h / nh - 0.5
    xs = (np.arange(nw) + 0.5) * w / nw - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = np.clip(ys - y0, 0, 1)[:, None, None]
    fx = np.clip(xs - x0, 0, 1)[None, :, None]
    img = image.astype(np.float32)
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy


def pick_bucket(h: int, w: int, buckets: Sequence[Sequence[int]]) -> Tuple[int, int]:
    """Smallest bucket that fits (h, w); falls back to the largest."""
    best = None
    for bh, bw in buckets:
        if h <= bh and w <= bw and (best is None or bh * bw < best[0]):
            best = (bh * bw, (bh, bw))
    if best is None:
        return tuple(max(b) for b in zip(*buckets))
    return best[1]


def pad_to_bucket(image: np.ndarray, bucket: Tuple[int, int]) -> np.ndarray:
    h, w = image.shape[:2]
    bh, bw = bucket
    if h > bh or w > bw:
        # cropping would cut off content that image_hw still refers to
        raise ValueError(
            f"resized image ({h}x{w}) exceeds bucket ({bh}x{bw}); add a larger "
            "bucket to tpu_image_buckets covering the image_min_size/"
            "image_max_size resize envelope"
        )
    out = np.zeros((bh, bw) + image.shape[2:], image.dtype)
    out[:h, :w] = image
    return out


def preprocess_eval_image(
    image_rgb: np.ndarray,
    cfg: dict,
    preprocessing_type: str = "caffe",
    image_format: Optional[str] = None,
):
    """One eval image -> (padded image, image_hw, scale, raw_h, raw_w).

    image_format: channel order fed to the model; None is the native order
    of the preprocessing type (caffe -> BGR, tf -> RGB), 'rgb'/'bgr' flip
    after normalization when it differs.
    """
    if image_format not in (None, "bgr", "rgb"):
        raise ValueError(f"unknown image format {image_format}")
    h, w = image_rgb.shape[:2]
    if preprocessing_type == "caffe":
        img = caffe_normalize(image_rgb, cfg["bgr_pixel_means"], means_dtype=np.float64)
        native = "bgr"
    elif preprocessing_type == "tf":
        img = tf_normalize(image_rgb)
        native = "rgb"
    else:
        raise ValueError(preprocessing_type)
    if image_format is not None and image_format != native:
        img = img[..., ::-1]
    scale = compute_scale(h, w, cfg["image_min_size"], cfg["image_max_size"])
    img = resize_image(img, scale)
    nh, nw = img.shape[:2]
    img = pad_to_bucket(img, pick_bucket(nh, nw, cfg["tpu_image_buckets"]))
    return img, np.asarray([nh, nw], np.int32), float(scale), h, w
