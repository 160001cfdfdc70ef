"""RoI features with `tf.image.crop_and_resize` semantics
(port of `tf_eager_object_detection_tpu/ops/roi_align.py`, Faster R-CNN part).

Bilinear resampling along y and along x are linear maps, so each crop is
`W_y @ feature @ W_x^T`: two batched matmuls. Feature maps are NHWC at this
module's functions, as in JAX, with the batch dimension explicit.

TF crop_and_resize sampling rule (crop size S > 1):
  y_i = y1*(H-1) + i * (y2-y1)*(H-1)/(S-1), bilinear, whole sample = 0 when
  y_i outside [0, H-1] (same for x).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["crop_and_resize", "roi_crop_faster_rcnn", "max_pool_2x2_same"]

# Samples within this distance outside [0, size-1] still count as inside, as
# in the JAX module (where XLA may reassociate the coordinate arithmetic).
_EDGE_EPS = 1e-3


def _interp_weights(lo: torch.Tensor, hi: torch.Tensor, size: int, crop: int) -> torch.Tensor:
    """Bilinear sampling weights [..., crop, size] for TF crop_and_resize.

    lo/hi: [...] normalized start/end coordinates along this axis.
    """
    scale = float(size - 1)
    if crop > 1:
        step = (hi - lo) * scale / (crop - 1)
        steps = torch.arange(crop, dtype=torch.float32, device=lo.device)
        coords = (lo * scale).unsqueeze(-1) + step.unsqueeze(-1) * steps
    else:
        coords = (0.5 * (lo + hi) * scale).unsqueeze(-1)
    in_range = (coords >= -_EDGE_EPS) & (coords <= scale + _EDGE_EPS)
    coords = coords.clamp(0.0, scale)
    cells = torch.arange(size, dtype=torch.float32, device=lo.device)
    w = (1.0 - (coords.unsqueeze(-1) - cells).abs()).clamp_min(0.0)  # tent
    return torch.where(in_range.unsqueeze(-1), w, torch.zeros_like(w))


def crop_and_resize(
    features: torch.Tensor, boxes: torch.Tensor, crop_size: int
) -> torch.Tensor:
    """TF-semantics crop_and_resize, one feature map per batch row.

    features [B, H, W, C]; boxes [B, N, 4] normalized (y1, x1, y2, x2).
    Returns [B, N, S, S, C] float32.
    """
    b, h, w, c = features.shape
    n = boxes.shape[1]
    s = crop_size
    wy = _interp_weights(boxes[..., 0], boxes[..., 2], h, s)  # [B, N, S, H]
    wx = _interp_weights(boxes[..., 1], boxes[..., 3], w, s)  # [B, N, S, W]
    feat = features.float().reshape(b, h, w * c)
    # contract H first: [B, N*S, H] @ [B, H, W*C]
    rows = torch.bmm(wy.reshape(b, n * s, h), feat).reshape(b * n, s, w, c)
    # then W: per roi, [S_t, W] @ [W, S_s*C]
    rows = rows.permute(0, 2, 1, 3).reshape(b * n, w, s * c)
    out = torch.bmm(wx.reshape(b * n, s, w), rows)  # [B*N, S_t, S_s*C]
    return out.reshape(b, n, s, s, c).transpose(2, 3)


def max_pool_2x2_same(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool with TF 'SAME' padding over [..., H, W, C].

    SAME pads only at the bottom and the right (an odd extent gets one -inf
    row/column there), unlike torch's symmetric pooling padding.
    """
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    y = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.pad(y, (0, w % 2, 0, h % 2), value=float("-inf"))
    y = F.max_pool2d(y, 2, 2)
    return y.permute(0, 2, 3, 1).reshape(*lead, y.shape[2], y.shape[3], c)


def roi_crop_faster_rcnn(
    features: torch.Tensor,
    rois: torch.Tensor,
    extractor_stride: int,
    pool_size: int,
    max_pooling: bool,
) -> torch.Tensor:
    """Faster R-CNN RoI pooling (`RoiPoolingCropAndResize`).

    features [B, H', W', C]; rois [B, N, 4] xyxy pixels. rois are divided by
    the stride and normalized by (H'-1, W'-1). Returns [B, N, P, P, C].
    """
    h, w = features.shape[1], features.shape[2]
    r = rois.float() / float(extractor_stride)
    boxes = torch.stack(
        [r[..., 1] / (h - 1.0), r[..., 0] / (w - 1.0),
         r[..., 3] / (h - 1.0), r[..., 2] / (w - 1.0)],
        dim=-1,
    )
    if max_pooling:
        return max_pool_2x2_same(crop_and_resize(features, boxes, pool_size * 2))
    return crop_and_resize(features, boxes, pool_size)
