"""VGG16 extractor + fc RoI head with dropout
(port of `tf_eager_object_detection_tpu/models/backbones/vgg.py`).

The extractor is 13 3x3 SAME convolutions with ReLU in five blocks, a 2x2 /
stride-2 SAME max pool after each of blocks 1-4 (none after block 5), so
the output stride is 16. The RoI head flattens the NHWC crop [N, 7, 7, 512]
in (h, w, c) order, as flax does, so the bridged `fc1` kernel needs no
permutation; then fc1 4096 -> ReLU -> dropout -> fc2 4096 -> ReLU ->
dropout -> score and box layers. Submodules carry the keras / flax names
(`block1_conv1`, `fc1`, ...). Public inputs and outputs are NHWC; the
convolutions run in NCHW. Blocks 1-2 are frozen in Faster R-CNN
(`models/freeze.py`).

Compute dtype, as the flax modules' `dtype`: the convolutions, fc1 and fc2
compute in `compute_dtype`; the score and box layers have no dtype in
flax, so they compute in float32 on the upcast input.

Dropout has no random stream of its own: the head takes the keep masks
(`keep`, bool [2, N, 4096], one per dropout layer) from the caller, which
draws them with the samplers' (`ops/sampling.py::TrainDraws`), so a test
can hand the port the masks JAX drew. `keep=None` is no dropout, as in
serving; with masks a layer computes `where(keep, x / keep_prob, 0)`, as
flax's `lax.select(mask, inputs / keep_prob, 0)`.
"""

from __future__ import annotations

import torch
from torch import nn

from tf_eager_object_detection_tpu_torch.models.layers import Linear, SameConv2d, max_pool_same

__all__ = ["Vgg16Extractor", "Vgg16RoiHead", "VGG16_FROZEN_PREFIXES", "VGG16_HIDDEN"]

# the layers with no gradient and no weight decay in Faster R-CNN
VGG16_FROZEN_PREFIXES = ("block1_conv1", "block1_conv2", "block2_conv1", "block2_conv2")
VGG16_HIDDEN = 4096  # width of fc1 and fc2, the dropout masks' last axis

_BLOCKS = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


class Vgg16Extractor(nn.Module):
    """Image [B, H, W, 3] (caffe BGR, NHWC) -> features [B, ceil(H/16), ceil(W/16), 512]."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self._plan = []
        cin = 3
        for block, (n_convs, ch) in enumerate(_BLOCKS, start=1):
            names = []
            for i in range(1, n_convs + 1):
                name = f"block{block}_conv{i}"
                setattr(self, name, SameConv2d(cin, ch, 3, compute_dtype=compute_dtype))
                names.append(name)
                cin = ch
            self._plan.append(names)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).contiguous()
        for block, names in enumerate(self._plan, start=1):
            for name in names:
                x = torch.relu(getattr(self, name)(x))
            if block < len(self._plan):  # no pool after block 5: the stride stays 16
                x = max_pool_same(x, 2, 2)
        return x.permute(0, 2, 3, 1)


class Vgg16RoiHead(nn.Module):
    """RoI features [N, 7, 7, 512] NHWC -> (scores [N, C], deltas [N, 4C])."""

    def __init__(self, num_classes: int = 21, keep_rate: float = 0.5,
                 in_features: int = 7 * 7 * 512, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(in_features, VGG16_HIDDEN, compute_dtype)
        self.fc2 = Linear(VGG16_HIDDEN, VGG16_HIDDEN, compute_dtype)
        # no dtype in flax: float32 on the upcast input (`Linear`'s default)
        self.roi_head_score = Linear(VGG16_HIDDEN, num_classes)
        self.roi_head_bboxes = Linear(VGG16_HIDDEN, 4 * num_classes)
        # flax's Dropout(rate=1 - keep_rate) keeps with probability 1 - rate
        self.keep_prob = 1.0 - (1.0 - keep_rate)

    def _dropout(self, x: torch.Tensor, keep) -> torch.Tensor:
        if keep is None:
            return x
        return torch.where(keep, x / self.keep_prob, torch.zeros((), dtype=x.dtype))

    def forward(self, x: torch.Tensor, keep: torch.Tensor | None = None):
        """`keep`: bool [2, N, 4096], the masks of the two dropout layers, or
        None for no dropout."""
        masks = (None, None) if keep is None else (keep[0], keep[1])
        x = x.reshape(x.shape[0], -1)  # NHWC order, as the bridged fc1 expects
        x = self._dropout(torch.relu(self.fc1(x)), masks[0])
        x = self._dropout(torch.relu(self.fc2(x)), masks[1])
        return self.roi_head_score(x), self.roi_head_bboxes(x)
