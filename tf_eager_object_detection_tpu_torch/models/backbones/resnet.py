"""ResNet v1 backbones + conv5 RoI head
(port of `tf_eager_object_detection_tpu/models/backbones/resnet.py`).

`ResNetBackbone`: keras-style bottlenecks with the stride on the first 1x1
conv of a stack's first block. `SlimResNetBackbone` (FPN's
`tpu_fpn_backbone_style: "slim"`): the stride on the last block's 3x3 conv
after an explicit (1, 1) pad (VALID), identity shortcuts subsampled by
`[::stride, ::stride]`, and each stack's pre-stride output as the lateral.
Both: conv1 7x7/2 after an explicit (3, 3) zero pad, then a 3x3/2 max pool
over a -inf pad of 1; every BatchNorm frozen. Every layer that mixes rows
is one of `models/layers.py`, so the extractors take row-sharded maps
(`parallel/spatial.py`). Submodules carry the keras/flax names
(`conv2_block1_1_conv`, ...) so the weight bridge is a name map. Public
inputs and outputs are NHWC; the convolutions run in NCHW.

`compute_dtype` is the flax modules' `dtype`: every convolution computes
in it (bfloat16 stage outputs under bf16 compute). The RoI head averages
its conv5 output in that dtype, then casts to float32 for its two dense
layers, as the JAX head does.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tf_eager_object_detection_tpu_torch.models.layers import (
    Conv2d,
    FrozenBatchNorm,
    MaxPool2d,
    SameConv2d,
    subsample as subsample_rows,
)

__all__ = ["ResNetBackbone", "ResNetRoiHead", "SlimResNetBackbone", "RESNET_DEPTH_BLOCKS"]

# blocks per (conv3, conv4) stack; conv2 and conv5 always have 3 blocks
RESNET_DEPTH_BLOCKS = {50: (4, 6), 101: (4, 23), 152: (8, 36)}


def _bottleneck_forward(mod: nn.Module, x: torch.Tensor, prefix: str, conv_shortcut: bool,
                        subsample: int = 1):
    """1x1 -> 3x3 -> 1x1, each with a frozen BN; residual + relu. An
    identity shortcut takes every `subsample`-th row and column.

    The convs live on `mod` under their flax names (`{prefix}_{i}_conv`).
    """

    def conv_bn(i, t):
        return getattr(mod, f"{prefix}_{i}_bn")(getattr(mod, f"{prefix}_{i}_conv")(t))

    shortcut = conv_bn(0, x) if conv_shortcut else subsample_rows(x, subsample)
    y = torch.relu(conv_bn(1, x))
    y = torch.relu(conv_bn(2, y))
    y = conv_bn(3, y)
    return torch.relu(shortcut + y)


def _add_bottleneck(mod: nn.Module, prefix: str, in_ch: int, filters: int,
                    stride: int, conv_shortcut: bool, dtype: torch.dtype) -> None:
    if conv_shortcut:
        setattr(mod, f"{prefix}_0_conv", SameConv2d(in_ch, 4 * filters, 1, stride, dtype))
        setattr(mod, f"{prefix}_0_bn", FrozenBatchNorm(4 * filters))
    layers = [(in_ch, filters, 1, stride), (filters, filters, 3, 1), (filters, 4 * filters, 1, 1)]
    for i, (cin, cout, k, s) in enumerate(layers, start=1):
        setattr(mod, f"{prefix}_{i}_conv", SameConv2d(cin, cout, k, s, dtype))
        setattr(mod, f"{prefix}_{i}_bn", FrozenBatchNorm(cout))


def _add_slim_bottleneck(mod: nn.Module, prefix: str, in_ch: int, filters: int,
                         stride: int, dtype: torch.dtype) -> bool:
    """A slim block: the stride on the 3x3 conv, after a (1, 1) zero pad;
    a conv shortcut where the depth changes. Returns whether it has one."""
    conv_shortcut = in_ch != 4 * filters
    if conv_shortcut:
        setattr(mod, f"{prefix}_0_conv", SameConv2d(in_ch, 4 * filters, 1, stride, dtype))
        setattr(mod, f"{prefix}_0_bn", FrozenBatchNorm(4 * filters))
    setattr(mod, f"{prefix}_1_conv", SameConv2d(in_ch, filters, 1, compute_dtype=dtype))
    setattr(mod, f"{prefix}_2_conv", Conv2d(filters, filters, 3, stride, 1, dtype))
    setattr(mod, f"{prefix}_3_conv", SameConv2d(filters, 4 * filters, 1, compute_dtype=dtype))
    for i, ch in ((1, filters), (2, filters), (3, 4 * filters)):
        setattr(mod, f"{prefix}_{i}_bn", FrozenBatchNorm(ch))
    return conv_shortcut


def _add_stem(mod: nn.Module, dtype: torch.dtype) -> None:
    mod.conv1_conv = Conv2d(3, 64, 7, stride=2, padding=3, compute_dtype=dtype)
    mod.conv1_bn = FrozenBatchNorm(64)
    mod.pool = MaxPool2d(3, stride=2, padding=1)  # pads with -inf


def _stem_forward(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """NHWC image -> NCHW stride-4 map: conv1, its BN and relu, the max pool."""
    x = x.permute(0, 3, 1, 2).contiguous()
    return mod.pool(torch.relu(mod.conv1_bn(mod.conv1_conv(x))))


def _add_stack(mod: nn.Module, plan: list, name: str, in_ch: int, filters: int,
               blocks: int, stride1: int, dtype: torch.dtype) -> int:
    """Registers one stack's convs on `mod`, appends (prefix, shortcut) to plan."""
    for i in range(1, blocks + 1):
        prefix = f"{name}_block{i}"
        first = i == 1
        _add_bottleneck(mod, prefix, in_ch, filters, stride1 if first else 1, first, dtype)
        plan.append((prefix, first))
        in_ch = 4 * filters
    return in_ch


class ResNetBackbone(nn.Module):
    """Image [B, H, W, 3] (caffe BGR, NHWC) -> stage outputs, NHWC.

    `return_stages` picks which of (c2, c3, c4, c5) to return: the default
    ("c4",) is the Faster R-CNN extractor ([B, H/16, W/16, 1024], returned
    as a tensor); FPN takes ("c2", "c3", "c4", "c5") with `include_c5=True`,
    which puts the conv5 stack (stride 2) inside the extractor.
    """

    def __init__(self, depth: int = 50, return_stages: Sequence[str] = ("c4",),
                 include_c5: bool = False, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if depth not in RESNET_DEPTH_BLOCKS:
            raise ValueError(f"unknown resnet depth {depth}")
        b3, b4 = RESNET_DEPTH_BLOCKS[depth]
        self.depth = depth
        self.return_stages = tuple(return_stages)
        _add_stem(self, compute_dtype)
        self._stages: list = []  # (stage name, its plan)
        ch = 64
        stacks = [("c2", "conv2", 64, 3, 1), ("c3", "conv3", 128, b3, 2),
                  ("c4", "conv4", 256, b4, 2)]
        if include_c5:
            stacks.append(("c5", "conv5", 512, 3, 2))
        for stage, name, filters, blocks, stride in stacks:
            plan: list = []
            ch = _add_stack(self, plan, name, ch, filters, blocks, stride, compute_dtype)
            self._stages.append((stage, plan))
        missing = set(self.return_stages) - {s for s, _ in self._stages}
        if missing:
            raise ValueError(f"stages {sorted(missing)} are not built (include_c5={include_c5})")

    def forward(self, x: torch.Tensor):
        x = _stem_forward(self, x)
        out = {}
        for stage, plan in self._stages:
            for prefix, conv_shortcut in plan:
                x = _bottleneck_forward(self, x, prefix, conv_shortcut)
            out[stage] = x.permute(0, 2, 3, 1)
        res = tuple(out[s] for s in self.return_stages)
        return res[0] if len(res) == 1 else res


class SlimResNetBackbone(nn.Module):
    """Image [B, H, W, 3] (caffe BGR, NHWC) -> (c2, c3, c4, c5) NHWC, FPN's
    slim-style extractor. Stacks conv2..conv4 put their stride 2 on the last
    block and return the output before it as the lateral (c2 at stride 4,
    c3 at 8, c4 at 16); conv5 runs at stride 1 on conv4's strided output
    (c5 at stride 32)."""

    def __init__(self, depth: int = 50, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if depth not in RESNET_DEPTH_BLOCKS:
            raise ValueError(f"unknown resnet depth {depth}")
        b3, b4 = RESNET_DEPTH_BLOCKS[depth]
        self.depth = depth
        _add_stem(self, compute_dtype)
        self._stacks: list = []  # per stack: [(prefix, conv shortcut, stride)] by block
        ch = 64
        for name, filters, blocks, stride in (("conv2", 64, 3, 2), ("conv3", 128, b3, 2),
                                              ("conv4", 256, b4, 2), ("conv5", 512, 3, 1)):
            plan = []
            for i in range(1, blocks + 1):
                s = stride if i == blocks else 1
                prefix = f"{name}_block{i}"
                plan.append((prefix, _add_slim_bottleneck(self, prefix, ch, filters, s,
                                                          compute_dtype), s))
                ch = 4 * filters
            self._stacks.append(plan)

    def forward(self, x: torch.Tensor):
        x = _stem_forward(self, x)
        laterals = []
        for plan in self._stacks:
            for prefix, conv_shortcut, stride in plan:
                if prefix == plan[-1][0]:
                    laterals.append(x)  # the stack's output before its stride
                x = _bottleneck_forward(self, x, prefix, conv_shortcut, stride)
        c2, c3, c4 = laterals[:3]
        return tuple(t.permute(0, 2, 3, 1) for t in (c2, c3, c4, x))


class ResNetRoiHead(nn.Module):
    """RoI features [N, 7, 7, 1024] NHWC -> (scores [N, C], deltas [N, 4C]).

    conv5 stack at stride 1 in `compute_dtype`, global average pool, then
    two float32 dense heads.
    """

    def __init__(self, num_classes: int = 21, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self._plan: list = []
        _add_stack(self, self._plan, "conv5", 1024, 512, 3, 1, compute_dtype)
        self.roi_head_score = nn.Linear(2048, num_classes)
        self.roi_head_bboxes = nn.Linear(2048, 4 * num_classes)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = x.permute(0, 3, 1, 2).contiguous()
        for prefix, conv_shortcut in self._plan:
            x = _bottleneck_forward(self, x, prefix, conv_shortcut)
        x = x.mean(dim=(2, 3)).float()
        return self.roi_head_score(x), self.roi_head_bboxes(x)
