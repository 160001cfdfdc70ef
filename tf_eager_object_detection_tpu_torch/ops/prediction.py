"""Final detection post-processing (port of `tf_eager_object_detection_tpu/ops/prediction.py`).

For one image: class-specific decode, clip and min-edge filter for every
foreground class, then ONE class-batched NMS over [C-1, N] boxes, then a
global top-k. The reference's `(None, None, None)` empty result is an
all-False validity mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tf_eager_object_detection_tpu_torch.core.boxes import clip_boxes, min_edge_mask
from tf_eager_object_detection_tpu_torch.core.transforms import decode_boxes
from tf_eager_object_detection_tpu_torch.ops.nms import non_max_suppression

__all__ = ["Detections", "post_ops_prediction"]


class Detections(NamedTuple):
    boxes: torch.Tensor  # [D, 4] xyxy
    labels: torch.Tensor  # [D] int64 class ids (>= 1)
    scores: torch.Tensor  # [D]
    valid: torch.Tensor  # [D] bool


def post_ops_prediction(
    roi_scores_softmax: torch.Tensor,
    roi_deltas: torch.Tensor,
    rois: torch.Tensor,
    roi_valid: torch.Tensor,
    image_height,
    image_width,
    target_means=(0.0, 0.0, 0.0, 0.0),
    target_stds=(0.1, 0.1, 0.2, 0.2),
    max_num_per_class: int = 50,
    max_num_per_image: int = 50,
    nms_iou_threshold: float = 0.3,
    score_threshold: float = 0.0,
    min_edge: float = 16.0,
    num_classes: int = 21,
    clip_deltas: bool = True,
) -> Detections:
    """roi_scores_softmax [N, C]; roi_deltas [N, C, 4]; rois [N, 4]; roi_valid [N]."""
    fg_scores = roi_scores_softmax[:, 1:].transpose(0, 1)  # [C-1, N]
    fg_deltas = roi_deltas[:, 1:, :].transpose(0, 1)  # [C-1, N, 4]
    boxes = decode_boxes(
        rois.unsqueeze(0), fg_deltas, target_means, target_stds,
        clip_deltas=clip_deltas,
    )
    boxes = clip_boxes(boxes, image_height, image_width)
    keep = roi_valid & (fg_scores > score_threshold) & min_edge_mask(boxes, min_edge)
    idx, ok = non_max_suppression(
        boxes, fg_scores, keep, max_num_per_class, nms_iou_threshold
    )  # [C-1, K]
    c_minus_1, k = idx.shape
    boxes_c = torch.gather(boxes, 1, idx.unsqueeze(-1).expand(c_minus_1, k, 4))
    scores_c = torch.gather(fg_scores, 1, idx)
    labels_c = torch.arange(1, num_classes, device=idx.device)[:, None].expand(
        c_minus_1, k
    )

    flat_scores = torch.where(
        ok, scores_c, torch.full_like(scores_c, float("-inf"))
    ).reshape(-1)
    # stable: equal scores keep the lower flat index first, like lax.top_k
    top_scores, top_idx = torch.sort(flat_scores, descending=True, stable=True)
    top_scores, top_idx = top_scores[:max_num_per_image], top_idx[:max_num_per_image]
    valid = top_scores > float("-inf")
    out_boxes = boxes_c.reshape(-1, 4)[top_idx]
    return Detections(
        torch.where(valid.unsqueeze(-1), out_boxes, torch.zeros_like(out_boxes)),
        torch.where(valid, labels_c.reshape(-1)[top_idx], torch.zeros_like(top_idx)),
        torch.where(valid, top_scores, torch.zeros_like(top_scores)),
        valid,
    )
