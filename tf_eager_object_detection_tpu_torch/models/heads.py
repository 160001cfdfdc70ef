"""RPN head (port of `tf_eager_object_detection_tpu/models/heads.py`).

3x3 conv(512, relu) + 1x1 score conv(2A) + 1x1 box conv(4A). Takes and
returns NHWC maps like the flax head; the convolutions run in NCHW. The 3x3
conv computes in `compute_dtype`; the two 1x1 convs have no dtype in the
flax head, so they compute in float32 on the upcast input and the maps are
float32 whatever the compute dtype (rounding the logits to bfloat16 would
reorder the proposals).
"""

from __future__ import annotations

import torch
from torch import nn

from tf_eager_object_detection_tpu_torch.models.layers import Conv2d, SameConv2d

__all__ = ["RpnHead", "frcnn_score_logits", "reshuffle_frcnn_scores"]


class RpnHead(nn.Module):
    def __init__(self, in_channels: int = 1024, num_anchors: int = 9,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rpn_first_conv = SameConv2d(in_channels, 512, 3, compute_dtype=compute_dtype)
        self.rpn_score_conv = Conv2d(512, num_anchors * 2, 1)
        self.rpn_bbox_conv = Conv2d(512, num_anchors * 4, 1)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x [B, h, w, C] -> (score [B, h, w, 2A], bbox [B, h, w, 4A])."""
        y = torch.relu(self.rpn_first_conv(x.permute(0, 3, 1, 2)))
        score = self.rpn_score_conv(y).permute(0, 2, 3, 1)
        bbox = self.rpn_bbox_conv(y).permute(0, 2, 3, 1)
        return score, bbox


def frcnn_score_logits(score_map: torch.Tensor, num_anchors: int) -> torch.Tensor:
    """[B, h, w, 2A] score map -> [B, h*w*A, 2] logits, tf-faster-rcnn layout.

    The 2A channels are class-major: channel s*A + a.
    """
    b, h, w, _ = score_map.shape
    m = score_map.reshape(b, h * w, 2, num_anchors)
    return m.transpose(2, 3).reshape(b, -1, 2)


def reshuffle_frcnn_scores(score_map: torch.Tensor, num_anchors: int) -> torch.Tensor:
    """[B, h, w, 2A] -> [B, h*w*A] foreground probabilities (anchor-minor)."""
    return torch.softmax(frcnn_score_logits(score_map, num_anchors), dim=-1)[..., 1]
