"""Box overlays (port of `tf_eager_object_detection_tpu/utils/visual.py`):
draw labelled rectangles and undo the preprocessing for display. numpy,
and cv2 where it is installed.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

__all__ = ["draw_bboxes_with_labels", "unpreprocess_image", "show_one_image"]


def draw_bboxes_with_labels(
    image_uint8: np.ndarray,
    bboxes_xyxy: np.ndarray,
    labels: Sequence,
    color=(0, 255, 0),
) -> np.ndarray:
    """Draw boxes and text labels; returns a new uint8 RGB image."""
    img = np.ascontiguousarray(image_uint8.copy())
    for box, label in zip(np.asarray(bboxes_xyxy), labels):
        x1, y1, x2, y2 = [int(round(float(v))) for v in box]
        if cv2 is not None:
            cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)
            cv2.putText(img, str(label), (x1, max(y1 - 4, 10)), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                        color, 1)
        else:
            img[y1 : y1 + 2, x1:x2] = color
            img[max(y2 - 2, 0) : y2, x1:x2] = color
            img[y1:y2, x1 : x1 + 2] = color
            img[y1:y2, max(x2 - 2, 0) : x2] = color
    return img


def unpreprocess_image(
    image: np.ndarray,
    preprocessing_type: str = "caffe",
    bgr_means: Sequence[float] = (103.939, 116.779, 123.68),
) -> np.ndarray:
    """Preprocessed float image -> displayable RGB uint8."""
    if preprocessing_type == "caffe":
        img = image + np.asarray(bgr_means, np.float32)
        img = img[..., ::-1]  # BGR -> RGB
    elif preprocessing_type == "tf":
        img = (image + 1.0) * 127.5
    else:
        raise ValueError(preprocessing_type)
    return np.clip(img, 0, 255).astype(np.uint8)


def show_one_image(
    preprocessed_image: np.ndarray,
    bboxes_xyxy: np.ndarray,
    labels: Sequence,
    preprocessing_type: str = "caffe",
    bgr_means: Sequence[float] = (103.939, 116.779, 123.68),
) -> np.ndarray:
    """Undo the preprocessing and draw; returns RGB uint8 (no GUI)."""
    img = unpreprocess_image(preprocessed_image, preprocessing_type, bgr_means)
    return draw_bboxes_with_labels(img, bboxes_xyxy, labels)
