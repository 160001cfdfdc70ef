"""Box geometry on tensors (port of `tf_eager_object_detection_tpu/core/boxes.py`).

Boxes are `[..., 4]` float32 `(x1, y1, x2, y2)` pixels with the reference's
"+1 pixel" width convention. Image extents may be Python numbers or tensors
that broadcast against `boxes[..., 0]` (e.g. `[B, 1]` for `[B, N, 4]` boxes).
"""

from __future__ import annotations

import torch

__all__ = ["clip_boxes", "min_edge_mask"]


def _as_f32(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=like.device)


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
