"""Box encode/decode (port of `tf_eager_object_detection_tpu/core/transforms.py`).

xyxy corners <-> normalized (tx, ty, tw, th) deltas with the +1 width
convention; any leading batch shape; float32 arithmetic in the same order
as the JAX functions.
"""

from __future__ import annotations

import torch

__all__ = ["encode_boxes", "decode_boxes"]

# log(1000 / 16): Detectron's BBOX_XFORM_CLIP on dw/dh before exp
_DELTA_CLIP = 4.135166556742356


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, dtype=torch.float32, device=like.device)


def encode_boxes(
    src_boxes: torch.Tensor,
    dst_boxes: torch.Tensor,
    means=(0.0, 0.0, 0.0, 0.0),
    stds=(1.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """xyxy (src anchor/roi, dst gt) -> normalized (tx, ty, tw, th)."""
    box = src_boxes.float()
    gt = dst_boxes.float()
    w = box[..., 2] - box[..., 0] + 1.0
    h = box[..., 3] - box[..., 1] + 1.0
    cx = box[..., 0] + 0.5 * w
    cy = box[..., 1] + 0.5 * h
    gw = gt[..., 2] - gt[..., 0] + 1.0
    gh = gt[..., 3] - gt[..., 1] + 1.0
    gcx = gt[..., 0] + 0.5 * gw
    gcy = gt[..., 1] + 0.5 * gh
    delta = torch.stack(
        [(gcx - cx) / w, (gcy - cy) / h, torch.log(gw / w), torch.log(gh / h)],
        dim=-1,
    )
    return (delta - _vec(means, box)) / _vec(stds, box)


def decode_boxes(
    anchors: torch.Tensor,
    deltas: torch.Tensor,
    means=(0.0, 0.0, 0.0, 0.0),
    stds=(1.0, 1.0, 1.0, 1.0),
    clip_deltas: bool = True,
) -> torch.Tensor:
    """(tx, ty, tw, th) deltas + anchors -> xyxy boxes (x2 = x1 + width).

    `clip_deltas` clamps dw/dh to log(1000/16) before exp; `False` is the
    unclamped reference arithmetic (`strict_reference_parity`).
    """
    delta = deltas.float() * _vec(stds, deltas) + _vec(means, deltas)
    if clip_deltas:
        delta = torch.cat(
            [delta[..., :2], delta[..., 2:].clamp(-_DELTA_CLIP, _DELTA_CLIP)],
            dim=-1,
        )
    w = anchors[..., 2] - anchors[..., 0] + 1.0
    h = anchors[..., 3] - anchors[..., 1] + 1.0
    cx = anchors[..., 0] + 0.5 * w
    cy = anchors[..., 1] + 0.5 * h

    cx = cx + delta[..., 0] * w
    cy = cy + delta[..., 1] * h
    w = w * torch.exp(delta[..., 2])
    h = h * torch.exp(delta[..., 3])

    x1 = cx - 0.5 * w
    y1 = cy - 0.5 * h
    return torch.stack([x1, y1, x1 + w, y1 + h], dim=-1)
