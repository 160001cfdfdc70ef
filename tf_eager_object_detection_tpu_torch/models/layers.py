"""Shared layers (port of `tf_eager_object_detection_tpu/models/layers.py`).

Modules here take NCHW tensors; the NHWC <-> NCHW change happens at the
entry and exit of the backbone and the heads.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["FrozenBatchNorm", "SameConv2d"]


class FrozenBatchNorm(nn.Module):
    """Affine-only batch norm over frozen statistics, NCHW.

    The statistics are buffers under the flax parameter names, so the weight
    bridge maps them one to one. epsilon matches keras ResNet (1.001e-5).
    """

    def __init__(self, channels: int, epsilon: float = 1.001e-5):
        super().__init__()
        self.epsilon = epsilon
        self.register_buffer("gamma", torch.ones(channels))
        self.register_buffer("beta", torch.zeros(channels))
        self.register_buffer("moving_mean", torch.zeros(channels))
        self.register_buffer("moving_variance", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.reciprocal(torch.sqrt(self.moving_variance + self.epsilon))
        scale = self.gamma * inv
        shift = self.beta - self.moving_mean * self.gamma * inv
        return x * scale[:, None, None] + shift[:, None, None]


def _same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """TF/flax 'SAME' padding (before, after) along one axis."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """Conv2d with TF 'SAME' padding, computed from the input size.

    Symmetric padding goes to the convolution itself; an asymmetric one (odd
    extents at stride 2, extra on the bottom/right) is padded explicitly.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        top, bottom = _same_padding(x.shape[-2], kh, sh)
        left, right = _same_padding(x.shape[-1], kw, sw)
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, self.bias, self.stride, (top, left))
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, self.stride)
