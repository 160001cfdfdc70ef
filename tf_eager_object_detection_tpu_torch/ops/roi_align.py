"""RoI features with `tf.image.crop_and_resize` semantics
(port of `tf_eager_object_detection_tpu/ops/roi_align.py` and of the
fused-pyramid RoIAlign of `ops/pallas/roi_align_pallas.py`).

Bilinear resampling along y and along x are linear maps, so each crop is
`W_y @ feature @ W_x^T`: two batched matmuls. Feature maps are NHWC at this
module's functions, as in JAX, with the batch dimension explicit.

TF crop_and_resize sampling rule (crop size S > 1):
  y_i = y1*(H-1) + i * (y2-y1)*(H-1)/(S-1), bilinear, whole sample = 0 when
  y_i outside [0, H-1] (same for x).

`roi_align_multilevel` is FPN's RoIAlign: every roi sampled from its own
pyramid level; `roi_align_single_level` samples one level for the rois it
marks active. Both are differentiable in the planes (not in rois, levels or
masks, as in JAX). A CUDA tensor goes to the hand-written kernels behind a
`torch.autograd.Function` (`csrc/roi_align.cu` forward, K4 / K2;
`csrc/roi_align_backward.cu` backward, K5 / K3), a CPU tensor to the plain
PyTorch versions (`*_reference`), whose gradients are autograd's.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tf_eager_object_detection_tpu_torch.ops.kernels.roi_align_backward_cuda import (
    ROI_ALIGN_BACKWARD_KERNEL,
    ROI_ALIGN_SINGLE_BACKWARD_KERNEL,
)
from tf_eager_object_detection_tpu_torch.ops.kernels.roi_align_cuda import (
    ROI_ALIGN_KERNEL,
    ROI_ALIGN_SINGLE_KERNEL,
)

__all__ = [
    "crop_and_resize",
    "roi_crop_faster_rcnn",
    "roi_crop_fpn",
    "max_pool_2x2_same",
    "level_sample_coords",
    "roi_align_multilevel",
    "roi_align_multilevel_reference",
    "roi_align_multilevel_reference_backward",
    "roi_align_single_level",
    "roi_align_single_level_reference",
    "RoIAlignMultilevel",
    "RoIAlignSingleLevel",
]

# Samples within this distance outside [0, size-1] still count as inside, as
# in the JAX module (where XLA may reassociate the coordinate arithmetic).
_EDGE_EPS = 1e-3


def _tent_weights(coords: torch.Tensor, in_range: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear weights [..., size] of clamped sample coords [...]: the tent
    max(0, 1 - |coord - cell|) over the cells, zero for out-of-range samples."""
    cells = torch.arange(size, dtype=torch.float32, device=coords.device)
    w = (1.0 - (coords.unsqueeze(-1) - cells).abs()).clamp_min(0.0)
    return torch.where(in_range.unsqueeze(-1), w, torch.zeros_like(w))


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
    return _tent_weights(coords.clamp(0.0, scale), in_range, size)


def _crop(features: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """features [B, H, W, C], wy [B, N, S, H], wx [B, N, S, W] -> [B, N, S, S, C]."""
    b, h, w, c = features.shape
    n, s = wy.shape[1], wy.shape[2]
    feat = features.float().reshape(b, h, w * c)
    # contract H first: [B, N*S, H] @ [B, H, W*C]
    rows = torch.bmm(wy.reshape(b, n * s, h), feat).reshape(b * n, s, w, c)
    # then W: per roi, [S_t, W] @ [W, S_s*C]
    rows = rows.permute(0, 2, 1, 3).reshape(b * n, w, s * c)
    out = torch.bmm(wx.reshape(b * n, s, w), rows)  # [B*N, S_t, S_s*C]
    return out.reshape(b, n, s, s, c).transpose(2, 3)


def crop_and_resize(
    features: torch.Tensor, boxes: torch.Tensor, crop_size: int
) -> torch.Tensor:
    """TF-semantics crop_and_resize, one feature map per batch row.

    features [B, H, W, C]; boxes [B, N, 4] normalized (y1, x1, y2, x2).
    Returns [B, N, S, S, C] float32.
    """
    h, w = features.shape[1], features.shape[2]
    wy = _interp_weights(boxes[..., 0], boxes[..., 2], h, crop_size)  # [B, N, S, H]
    wx = _interp_weights(boxes[..., 1], boxes[..., 3], w, crop_size)  # [B, N, S, W]
    return _crop(features, wy, wx)


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


def roi_crop_fpn(
    features: torch.Tensor,
    rois: torch.Tensor,
    image_height: torch.Tensor,
    image_width: torch.Tensor,
    pool_size: int,
    level_stride: int,
) -> torch.Tensor:
    """FPN RoI pooling of one level (`RoiPoolingCropAndResize2`, `level_stride` path).

    features [B, H, W, C] padded-bucket map; rois [B, N, 4] xyxy pixels;
    image_height/width [B] valid image extent. Boxes are normalized by the
    image and rescaled by (valid - 1) / (H - 1), valid = ceil(dim / stride),
    so samples stay on each image's valid feature extent. Crops at
    2 * pool_size, then 2x2 SAME max pool: [B, N, P, P, C].
    """
    h, w = features.shape[1], features.shape[2]
    ih = image_height.float()
    iw = image_width.float()
    s = float(level_stride)
    fy = ((torch.ceil(ih / s) - 1.0) / ((h - 1.0) * ih))[:, None]
    fx = ((torch.ceil(iw / s) - 1.0) / ((w - 1.0) * iw))[:, None]
    r = rois.float()
    boxes = torch.stack([r[..., 1] * fy, r[..., 0] * fx, r[..., 3] * fy, r[..., 2] * fx], dim=-1)
    return max_pool_2x2_same(crop_and_resize(features, boxes, pool_size * 2))


def level_sample_coords(
    lo: torch.Tensor, hi: torch.Tensor, image_dim: torch.Tensor, stride: int, crop: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample coordinates of one axis on one pyramid level, with the
    arithmetic of the JAX `_window_geometry` / `_coord_scales`.

    lo/hi [B, N] pixel coords of the roi along the axis; image_dim [B] valid
    image extent. The last valid cell is b = ceil(dim / stride) - 1 and a
    pixel maps to pixel * (b / dim). Sample i lies at
    c1 + ((c2 - c1) * i) * r with r the float32 reciprocal of crop - 1: XLA
    compiles the JAX division by the constant into that product, and a
    product rounds alike on every backend (torch divides by a scalar as a
    true division on the CPU and as a reciprocal product on CUDA). Returns
    (coords [B, N, crop] clamped to [0, b], in_range [B, N, crop] with the
    1e-3 tolerance).
    """
    dim = image_dim.float()
    last = torch.ceil(dim / float(stride)) - 1.0  # [B]; stride is a power of 2
    g = (last / dim)[:, None]
    c1, c2 = lo.float() * g, hi.float() * g
    idx = torch.arange(crop, dtype=torch.float32, device=lo.device)
    recip = float(np.float32(1.0) / np.float32(crop - 1))
    coords = c1.unsqueeze(-1) + ((c2 - c1).unsqueeze(-1) * idx) * recip
    last = last[:, None, None]
    in_range = (coords >= -_EDGE_EPS) & (coords <= last + _EDGE_EPS)
    return torch.minimum(coords.clamp_min(0.0), last), in_range


def roi_align_multilevel_reference(
    p_list: Sequence[torch.Tensor],
    rois: torch.Tensor,
    levels: torch.Tensor,
    valid: torch.Tensor,
    image_height: torch.Tensor,
    image_width: torch.Tensor,
    crop_size: int,
    strides: Sequence[int],
) -> torch.Tensor:
    """Plain PyTorch version of the fused-pyramid RoIAlign (TPU kernel `_ml_kernel`).

    p_list: per-level [B, H_l, W_l, C] padded-bucket planes; rois [B, N, 4]
    xyxy pixels; levels [B, N] int index into p_list; valid [B, N] bool;
    image_height/width [B] valid image extent; strides: per-level strides.
    Returns [B, N, S, S, C] float32 before any pooling: the sum over levels
    of the level-masked, valid-masked crops, each sampled exactly (no window)
    with `level_sample_coords`. A roi whose level matches no plane, or that
    is invalid, gives zeros.
    """
    if crop_size < 2:
        raise ValueError(f"crop_size must be >= 2, got {crop_size}")
    total = None
    for k, (feat, stride) in enumerate(zip(p_list, strides)):
        h, w = feat.shape[1], feat.shape[2]
        ys, y_ok = level_sample_coords(rois[..., 1], rois[..., 3], image_height, stride, crop_size)
        xs, x_ok = level_sample_coords(rois[..., 0], rois[..., 2], image_width, stride, crop_size)
        crop = _crop(feat, _tent_weights(ys, y_ok, h), _tent_weights(xs, x_ok, w))
        keep = ((levels == k) & valid)[..., None, None, None]
        crop = torch.where(keep, crop, torch.zeros_like(crop))
        total = crop if total is None else total + crop
    return total


def roi_align_multilevel_reference_backward(
    grad: torch.Tensor,
    p_list: Sequence[torch.Tensor],
    rois: torch.Tensor,
    levels: torch.Tensor,
    valid: torch.Tensor,
    image_height: torch.Tensor,
    image_width: torch.Tensor,
    crop_size: int,
    strides: Sequence[int],
) -> list[torch.Tensor]:
    """Plain version of the fused-pyramid backward (TPU kernel `_ml_bwd_kernel`):
    the gradient of `roi_align_multilevel_reference` with respect to each
    plane for the output gradient `grad` [B, N, S, S, C], by autograd. Only
    the planes' shapes matter (the function is linear in them)."""
    with torch.enable_grad():
        planes = [p.detach().float().requires_grad_() for p in p_list]
        out = roi_align_multilevel_reference(
            planes, rois, levels, valid, image_height, image_width, crop_size, strides
        )
        return list(torch.autograd.grad(out, planes, grad))


def roi_align_single_level_reference(
    features: torch.Tensor,
    rois: torch.Tensor,
    active: torch.Tensor,
    image_height: torch.Tensor,
    image_width: torch.Tensor,
    crop_size: int,
    level_stride: int,
) -> torch.Tensor:
    """Plain PyTorch version of the single-level RoIAlign (TPU kernel `_kernel`,
    `pallas_roi_align_window` with `level_stride`): the fused-pyramid
    reference with one plane; rois with `active` False give zeros."""
    return roi_align_multilevel_reference(
        [features], rois, torch.zeros_like(active, dtype=torch.long), active.bool(),
        image_height, image_width, crop_size, (level_stride,),
    )


class RoIAlignMultilevel(torch.autograd.Function):
    """K4 forward, K5 backward; the gradient goes to the planes only.

    apply(rois, levels, valid, image_height, image_width, crop_size, strides,
    *p_list) on CUDA tensors in the kernels' dtypes and layout.
    """

    @staticmethod
    def forward(ctx, rois, levels, valid, image_height, image_width, crop_size, strides, *p_list):
        ctx.save_for_backward(rois, levels, valid, image_height, image_width)
        ctx.crop_size, ctx.strides = crop_size, tuple(strides)
        ctx.shapes = [tuple(p.shape) for p in p_list]
        return ROI_ALIGN_KERNEL(list(p_list), rois, levels, valid, image_height, image_width,
                                crop_size, strides)

    @staticmethod
    def backward(ctx, grad):
        dfs = ROI_ALIGN_BACKWARD_KERNEL(grad.contiguous(), ctx.shapes, *ctx.saved_tensors,
                                        ctx.crop_size, ctx.strides)
        return (None,) * 7 + tuple(dfs)


class RoIAlignSingleLevel(torch.autograd.Function):
    """K2 forward, K3 backward; the gradient goes to the features only.

    apply(features, rois, active, image_height, image_width, crop_size,
    level_stride) on CUDA tensors in the kernels' dtypes and layout.
    """

    @staticmethod
    def forward(ctx, features, rois, active, image_height, image_width, crop_size, level_stride):
        levels = torch.zeros_like(active, dtype=torch.long)
        ctx.save_for_backward(rois, levels, active, image_height, image_width)
        ctx.crop_size, ctx.strides = crop_size, (level_stride,)
        ctx.shape = tuple(features.shape)
        return ROI_ALIGN_SINGLE_KERNEL([features], rois, levels, active, image_height,
                                       image_width, crop_size, ctx.strides)

    @staticmethod
    def backward(ctx, grad):
        (df,) = ROI_ALIGN_SINGLE_BACKWARD_KERNEL(grad.contiguous(), [ctx.shape],
                                                 *ctx.saved_tensors, ctx.crop_size, ctx.strides)
        return (df,) + (None,) * 6


def roi_align_multilevel(
    p_list: Sequence[torch.Tensor],
    rois: torch.Tensor,
    levels: torch.Tensor,
    valid: torch.Tensor,
    image_height: torch.Tensor,
    image_width: torch.Tensor,
    crop_size: int,
    strides: Sequence[int],
) -> torch.Tensor:
    """Fused-pyramid RoIAlign -> [B, N, S, S, C] float32 (see the reference).

    CUDA tensors launch the kernels (and raise if one fails); CPU tensors
    take `roi_align_multilevel_reference`. Either way no gradient reaches
    the rois, as in JAX (`stop_gradient`).
    """
    if rois.device.type == "cuda":
        return RoIAlignMultilevel.apply(
            rois.detach().float().contiguous(), levels.long().contiguous(),
            valid.bool().contiguous(), image_height.float().contiguous(),
            image_width.float().contiguous(), crop_size, tuple(strides),
            *[p.float().contiguous() for p in p_list],
        )
    if rois.device.type == "cpu":
        return roi_align_multilevel_reference(
            p_list, rois.detach(), levels, valid, image_height, image_width, crop_size, strides
        )
    raise ValueError(f"no RoIAlign for device {rois.device}")


def roi_align_single_level(
    features: torch.Tensor,
    rois: torch.Tensor,
    active: torch.Tensor,
    image_height: torch.Tensor,
    image_width: torch.Tensor,
    crop_size: int,
    level_stride: int,
) -> torch.Tensor:
    """Single-level RoIAlign (port of `pallas_roi_align_window` with
    `level_stride`) -> [B, N, S, S, C] float32; rois with `active` False give
    zeros. CUDA tensors launch the kernels, CPU tensors take
    `roi_align_single_level_reference`."""
    if rois.device.type == "cuda":
        return RoIAlignSingleLevel.apply(
            features.float().contiguous(), rois.detach().float().contiguous(),
            active.bool().contiguous(), image_height.float().contiguous(),
            image_width.float().contiguous(), crop_size, int(level_stride),
        )
    if rois.device.type == "cpu":
        return roi_align_single_level_reference(
            features, rois.detach(), active, image_height, image_width, crop_size, level_stride
        )
    raise ValueError(f"no RoIAlign for device {rois.device}")
