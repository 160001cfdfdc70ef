"""Box geometry on tensors (port of `tf_eager_object_detection_tpu/core/boxes.py`).

Boxes are `[..., 4]` float32 `(x1, y1, x2, y2)` pixels with the reference's
"+1 pixel" width convention. Image extents may be Python numbers or tensors
that broadcast against `boxes[..., 0]` (e.g. `[B, 1]` for `[B, N, 4]` boxes).
Pairwise functions take `[..., N, 4]` and `[..., M, 4]` and give `[..., N, M]`,
with the float32 operations of the JAX functions in the same order.
"""

from __future__ import annotations

import torch

__all__ = [
    "area",
    "pairwise_intersection",
    "pairwise_iou",
    "clip_boxes",
    "min_edge_mask",
    "inside_image_mask",
]


def _as_f32(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=like.device)


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Box areas with the +1 pixel convention. boxes: [..., 4] xyxy."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    return w * h


def pairwise_intersection(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection areas: [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    a = boxes1.unsqueeze(-2)  # [..., N, 1, 4]
    b = boxes2.unsqueeze(-3)  # [..., 1, M, 4]
    ih = (torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1]) + 1.0)
    iw = (torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0]) + 1.0)
    return ih.clamp_min(0.0) * iw.clamp_min(0.0)


def pairwise_iou(
    boxes1: torch.Tensor, boxes2: torch.Tensor, mask2: torch.Tensor | None = None
) -> torch.Tensor:
    """Pairwise IoU [..., N, M], zero where the intersection is empty; with
    `mask2` ([..., M] bool), zero for the columns it marks invalid."""
    boxes1 = boxes1.float()
    boxes2 = boxes2.float()
    inter = pairwise_intersection(boxes1, boxes2)
    union = area(boxes1).unsqueeze(-1) + area(boxes2).unsqueeze(-2) - inter
    iou = torch.where(inter > 0.0, inter / union, torch.zeros_like(inter))
    if mask2 is not None:
        iou = torch.where(mask2.unsqueeze(-2), iou, torch.zeros_like(iou))
    return iou


def clip_boxes(boxes: torch.Tensor, max_height, max_width) -> torch.Tensor:
    """Clamp boxes into [0, max_width-1] x [0, max_height-1]."""
    max_w = _as_f32(max_width, boxes) - 1.0
    max_h = _as_f32(max_height, boxes) - 1.0
    x1 = torch.minimum(boxes[..., 0].clamp_min(0.0), max_w)
    y1 = torch.minimum(boxes[..., 1].clamp_min(0.0), max_h)
    x2 = torch.minimum(boxes[..., 2].clamp_min(0.0), max_w)
    y2 = torch.minimum(boxes[..., 3].clamp_min(0.0), max_h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def min_edge_mask(boxes: torch.Tensor, min_edge) -> torch.Tensor:
    """True for boxes whose width and height (+1 convention) are >= min_edge."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    min_edge = _as_f32(min_edge, boxes)
    return (w >= min_edge) & (h >= min_edge)


def inside_image_mask(anchors: torch.Tensor, max_height, max_width) -> torch.Tensor:
    """True for boxes that lie wholly inside the image."""
    max_w = _as_f32(max_width, anchors)
    max_h = _as_f32(max_height, anchors)
    return ((anchors[..., 0] >= 0) & (anchors[..., 1] >= 0)
            & (anchors[..., 2] <= max_w - 1.0) & (anchors[..., 3] <= max_h - 1.0))
