"""Anchors (port of `tf_eager_object_detection_tpu/core/anchors.py`).

`generate_anchor_base`, `shift_anchor_base` (Faster R-CNN) and
`make_level_anchors` (FPN) are plain numpy, re-written here because the JAX
module imports `jax.numpy` at its top.

Ordering contract (must match the RPN head reshape): cell-major (row-major
over (y, x)), anchor-minor — anchors[(y * grid_w + x) * A + a].
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["generate_anchor_base", "shift_anchor_base", "make_level_anchors", "valid_anchor_mask"]


def _whctrs(anchor):
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    return w, h, anchor[0] + 0.5 * (w - 1), anchor[1] + 0.5 * (h - 1)


def _mkanchors(ws, hs, x_ctr, y_ctr):
    ws = ws[:, None]
    hs = hs[:, None]
    return np.hstack(
        (
            x_ctr - 0.5 * (ws - 1),
            y_ctr - 0.5 * (hs - 1),
            x_ctr + 0.5 * (ws - 1),
            y_ctr + 0.5 * (hs - 1),
        )
    )


def generate_anchor_base(base_size=16, ratios=(0.5, 1.0, 2.0), scales=(8, 16, 32)):
    """py-faster-rcnn base anchors around (0, 0, base-1, base-1): [A, 4] float64.

    Enumeration order: ratio-major, scale-minor.
    """
    ratios = np.asarray(ratios, np.float64)
    scales = np.asarray(scales, np.float64)
    base_anchor = np.array([1, 1, base_size, base_size], np.float64) - 1
    w, h, x_ctr, y_ctr = _whctrs(base_anchor)
    ws = np.round(np.sqrt(w * h / ratios))
    hs = np.round(ws * ratios)
    ratio_anchors = _mkanchors(ws, hs, x_ctr, y_ctr)
    out = []
    for anchor in ratio_anchors:
        w, h, x_ctr, y_ctr = _whctrs(anchor)
        out.append(_mkanchors(w * scales, h * scales, x_ctr, y_ctr))
    return np.vstack(out)


def shift_anchor_base(
    anchor_base: np.ndarray, feat_stride: int, grid_h: int, grid_w: int
) -> np.ndarray:
    """Shift base anchors over a grid_h x grid_w grid -> [grid_h*grid_w*A, 4] f32."""
    shift_x = np.arange(grid_w, dtype=np.float32) * feat_stride
    shift_y = np.arange(grid_h, dtype=np.float32) * feat_stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    a = anchor_base.shape[0]
    anchors = anchor_base.reshape((1, a, 4)).astype(np.float32) + shifts.reshape(
        (-1, 1, 4)
    )
    return anchors.reshape((-1, 4)).astype(np.float32)


def make_level_anchors(
    base_anchor_size: float, scales, ratios, grid_h: int, grid_w: int, stride: int
) -> np.ndarray:
    """FPN anchors for one pyramid level -> [grid_h*grid_w*A, 4] float32 xyxy.

    The reference's `make_anchors` with its `enum_ratios` swap: per (ratio,
    scale) the box is w = base*scale*sqrt(ratio), h = base*scale/sqrt(ratio),
    centred at (x*stride, y*stride). Order within a cell: ratio-major,
    scale-minor; cells row-major, as in `shift_anchor_base`.
    """
    scales = np.asarray(scales, np.float32)
    ratios = np.asarray(ratios, np.float32)
    sizes = base_anchor_size * scales
    sqrt_r = np.sqrt(ratios)
    ws = (sqrt_r[:, None] * sizes[None, :]).ravel()[None, :]  # [1, A]
    hs = (sizes[None, :] / sqrt_r[:, None]).ravel()[None, :]
    xc, yc = np.meshgrid(np.arange(grid_w, dtype=np.float32) * stride,
                         np.arange(grid_h, dtype=np.float32) * stride)
    xc = xc.ravel()[:, None]  # [K, 1]
    yc = yc.ravel()[:, None]
    anchors = np.stack([xc - 0.5 * ws, yc - 0.5 * hs, xc + 0.5 * ws, yc + 0.5 * hs], axis=2)
    return anchors.reshape(-1, 4).astype(np.float32)


def valid_anchor_mask(
    grid_h: int,
    grid_w: int,
    num_anchors: int,
    valid_h: torch.Tensor,
    valid_w: torch.Tensor,
) -> torch.Tensor:
    """[B, grid_h*grid_w*num_anchors] bool: anchors whose cell lies inside the
    valid sub-grid of each image (`valid_h`/`valid_w`: [B] int tensors)."""
    device = valid_h.device
    ys = torch.arange(grid_h, device=device)[None, :, None]
    xs = torch.arange(grid_w, device=device)[None, None, :]
    cell_ok = (ys < valid_h[:, None, None]) & (xs < valid_w[:, None, None])
    b = cell_ok.shape[0]
    return (
        cell_ok[..., None].expand(b, grid_h, grid_w, num_anchors).reshape(b, -1)
    )
