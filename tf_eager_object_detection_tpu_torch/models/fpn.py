"""FPN detector (ResNet-50/101/152), serving and training
(port of `tf_eager_object_detection_tpu/models/fpn.py`).

- extractor: multi-output ResNet (c2..c5, conv5 inside the extractor);
- neck: 1x1 laterals, TF1-semantics bilinear upsample as two matmuls,
  0.5/0.5 fusion, 3x3 SAME convs on p2..p4, p6 = p5 subsampled by 2;
- one RPN head shared by p2..p6 with the FPN score layout ([A, 2] per
  cell), one batched RPN NMS over the concatenation of all levels;
- level assignment floor(4 + log2(sqrt(wh) / 224)) clamped to
  [min_level, max_level]; every roi is sampled from its own level by the
  fused-pyramid RoIAlign (`ops/roi_align.py::roi_align_multilevel`, the
  CUDA kernels K4 / K5 on the card) or, with `tpu_roi_align_fused_levels`
  False, by one single-level RoIAlign per level, summed (K2 / K3); then
  2x2 SAME max pool;
- RoI head: NHWC flatten -> fc1024 -> fc1024 -> score and box heads, with
  no dropout in training either (as in JAX).

`loss_fn` is the training loss: RPN targets over every anchor and RoI
targets over the training proposals (both under `torch.no_grad()`, with
random draws from `ops/sampling.py::TrainDraws`), then the four losses and
the sample counts under the JAX metric names.

Invalid proposal slots (`roi_valid` False) get zero RoI features, so their
rows of `im_detect_batch` differ from the JAX detector's, which crops them
at the origin; post-processing masks them out either way. The serving
entry points are those of `models/detector.py`; `predict` keeps boxes with
sides of at least 16 px, as the reference hardcodes.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Sequence

import numpy as np
import torch
from torch import nn

from tf_eager_object_detection_tpu_torch.core.anchors import make_level_anchors, valid_anchor_mask
from tf_eager_object_detection_tpu_torch.models.backbones.resnet import ResNetBackbone
from tf_eager_object_detection_tpu_torch.models.detector import RESNET_DEPTHS, ServingDetector
from tf_eager_object_detection_tpu_torch.models.heads import RpnHead
from tf_eager_object_detection_tpu_torch.models.layers import SameConv2d
from tf_eager_object_detection_tpu_torch.ops.losses import cls_loss, smooth_l1_loss
from tf_eager_object_detection_tpu_torch.ops.region_proposal import region_proposal
from tf_eager_object_detection_tpu_torch.ops.roi_align import (
    max_pool_2x2_same,
    roi_align_multilevel,
    roi_align_single_level,
)
from tf_eager_object_detection_tpu_torch.ops.sampling import (
    TrainDraws,
    anchor_target,
    proposal_target,
)

__all__ = ["FPNDetector", "ResnetFpnNeck", "FpnRoiHead", "resize_bilinear_tf1"]


def _tf1_interp_matrix(out_size: int, in_size: int) -> np.ndarray:
    """TF1 resize_bilinear (align_corners=False) weights [out, in]: sample at
    i * in/out (no half-pixel offset), clamped at the last cell."""
    coords = np.arange(out_size, dtype=np.float64) * (in_size / out_size)
    cells = np.arange(in_size, dtype=np.float64)
    w = np.maximum(0.0, 1.0 - np.abs(coords[:, None] - cells[None, :]))
    w[coords >= in_size - 1, :] = 0.0
    w[coords >= in_size - 1, in_size - 1] = 1.0
    return w.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _interp_matrix_on(out_size: int, in_size: int, device: torch.device) -> torch.Tensor:
    """`_tf1_interp_matrix` as a tensor on `device`, copied there once; a
    normal tensor even when first asked for under `torch.inference_mode`
    (serving), so that a training step can save it for its backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(_tf1_interp_matrix(out_size, in_size)).to(device)


def _resize_nchw(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """TF1 bilinear resize of [B, C, H, W]: H contracted first, then W."""
    wy = _interp_matrix_on(out_h, x.shape[-2], x.device)
    wx = _interp_matrix_on(out_w, x.shape[-1], x.device)
    return torch.matmul(torch.matmul(wy, x), wx.T)


def resize_bilinear_tf1(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, out_h, out_w, C] with TF1 legacy semantics."""
    return _resize_nchw(x.permute(0, 3, 1, 2), out_h, out_w).permute(0, 2, 3, 1)


class ResnetFpnNeck(nn.Module):
    """(c2, c3, c4, c5) NHWC -> (p2, p3, p4, p5, p6) NHWC; convs run in NCHW."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048), dims: int = 256):
        super().__init__()
        c2, c3, c4, c5 = in_channels
        self.build_p5 = nn.Conv2d(c5, dims, 1)
        self.build_p4_reduce_dims = nn.Conv2d(c4, dims, 1)
        self.build_p3_reduce_dims = nn.Conv2d(c3, dims, 1)
        self.build_p2_reduce_dims = nn.Conv2d(c2, dims, 1)
        self.build_p4 = SameConv2d(dims, dims, 3)
        self.build_p3 = SameConv2d(dims, dims, 3)
        self.build_p2 = SameConv2d(dims, dims, 3)

    def forward(self, inputs):
        c2, c3, c4, c5 = (c.permute(0, 3, 1, 2) for c in inputs)
        p5 = self.build_p5(c5)
        p6 = p5[:, :, ::2, ::2]  # stride-2 max pool of size 1 = subsample

        def fuse(p_up, c, lateral):
            up = _resize_nchw(p_up, c.shape[-2], c.shape[-1])
            return up * 0.5 + lateral(c) * 0.5

        p4 = fuse(p5, c4, self.build_p4_reduce_dims)
        p3 = fuse(p4, c3, self.build_p3_reduce_dims)
        p2 = fuse(p3, c2, self.build_p2_reduce_dims)
        p4, p3, p2 = self.build_p4(p4), self.build_p3(p3), self.build_p2(p2)
        return tuple(p.permute(0, 2, 3, 1) for p in (p2, p3, p4, p5, p6))


class FpnRoiHead(nn.Module):
    """[N, 7, 7, C] NHWC -> (scores [N, classes], deltas [N, 4 * classes])."""

    def __init__(self, num_classes: int = 21, in_features: int = 7 * 7 * 256):
        super().__init__()
        self.fc1 = nn.Linear(in_features, 1024)
        self.fc2 = nn.Linear(1024, 1024)
        self.roi_head_score = nn.Linear(1024, num_classes)
        self.roi_head_bboxes = nn.Linear(1024, 4 * num_classes)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = x.reshape(x.shape[0], -1)  # NHWC order, as the bridged fc1 expects
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        return self.roi_head_score(x), self.roi_head_bboxes(x)


class FPNDetector(ServingDetector):
    model_type = "fpn"
    min_edge = 16.0  # base_fpn_model.py:275 hardcodes stride 16
    _FIXED_INIT_STD = {
        "rpn_head.rpn_first_conv": 0.01,
        "rpn_head.rpn_score_conv": 0.01,
        "rpn_head.rpn_bbox_conv": 0.001,
        "roi_head.roi_head_score": 0.01,
        "roi_head.roi_head_bboxes": 0.001,
    }

    def __init__(self, backbone: str, config: Dict[str, Any], device="cuda", seed: int = 0):
        super().__init__(backbone, config, device)
        cfg = self.cfg
        self.strides = list(cfg["anchor_stride_list"])
        self.base_sizes = list(cfg["base_anchor_size_list"])
        self.min_level = cfg["min_level"]
        self.max_level = cfg["max_level"]
        self.num_anchors = len(cfg["ratios"]) * len(cfg["scales"])
        dims = cfg["top_down_dims"]

        self.extractor = ResNetBackbone(
            RESNET_DEPTHS[backbone], return_stages=("c2", "c3", "c4", "c5"), include_c5=True
        )
        self.neck = ResnetFpnNeck(dims=dims)
        self.rpn_head = RpnHead(dims, self.num_anchors)
        pool = cfg["roi_pooling_size"]
        self.roi_head = FpnRoiHead(self.num_classes, pool * pool * dims)
        self._anchor_cache: dict = {}
        self._place(seed)
        # the samplers' draws when loss_fn is given none
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _init_std(self, name: str, fan_in: int) -> float:
        if name.startswith("neck."):
            return (2.0 / fan_in) ** 0.5  # he normal
        return super()._init_std(name, fan_in)

    # --------------------------------------------------------------- anchors
    def anchors_for_grids(self, grids) -> torch.Tensor:
        """grids: (gh, gw) per level -> [A_total, 4], levels concatenated
        (cached as a normal tensor, as `_interp_matrix_on`)."""
        key = tuple(grids)
        if key not in self._anchor_cache:
            per_level = [
                make_level_anchors(self.base_sizes[i], self.cfg["scales"], self.cfg["ratios"],
                                   gh, gw, self.strides[i])
                for i, (gh, gw) in enumerate(grids)
            ]
            with torch.inference_mode(False):
                self._anchor_cache[key] = torch.as_tensor(
                    np.concatenate(per_level, axis=0), device=self.device
                )
        return self._anchor_cache[key]

    def _level_valid_mask(self, grids, image_hw: torch.Tensor) -> torch.Tensor:
        """[B, A_total] bool: anchors whose cell lies on each image's valid grid."""
        h, w = image_hw[:, 0], image_hw[:, 1]
        return torch.cat([
            valid_anchor_mask(gh, gw, self.num_anchors, (h + s - 1) // s, (w + s - 1) // s)
            for (gh, gw), s in zip(grids, self.strides)
        ], dim=1)

    # ----------------------------------------------------------- shared path
    def _backbone_neck_rpn(self, images: torch.Tensor):
        """-> (p_list NHWC per level, score maps [B, h, w, 2A], bbox maps [B, h, w, 4A])."""
        p_list = self.neck(self.extractor(images))
        score_list, bbox_list = [], []
        for p in p_list:
            s, b = self.rpn_head(p)
            score_list.append(s.float())
            bbox_list.append(b.float())
        return p_list, score_list, bbox_list

    @staticmethod
    def _flatten_levels(score_list, bbox_list):
        """Per-level maps -> (scores [B, A_total, 2], deltas [B, A_total, 4],
        grids). Scores are [A, 2] per cell (reshape(-1, 2)), not class-major
        as in Faster R-CNN."""
        b = score_list[0].shape[0]
        grids = tuple((s.shape[1], s.shape[2]) for s in score_list)
        scores2 = torch.cat([s.reshape(b, -1, 2) for s in score_list], dim=1)
        deltas = torch.cat([d.reshape(b, -1, 4) for d in bbox_list], dim=1)
        return scores2, deltas, grids

    def _proposals(self, scores2, deltas, grids, image_hw, training: bool = False):
        """Batched proposals over the level concatenation, at the test or the
        training sizes."""
        cfg = self.cfg
        phase = "train" if training else "test"
        return region_proposal(
            deltas,
            self.anchors_for_grids(grids),
            torch.softmax(scores2, dim=-1)[..., 1],
            self._level_valid_mask(grids, image_hw),
            image_hw[:, 0],
            image_hw[:, 1],
            num_post_nms=cfg[f"rpn_proposal_{phase}_after_nms_sample_number"],
            nms_iou_threshold=cfg["rpn_proposal_nms_iou_threshold"],
            num_pre_nms=min(cfg[f"rpn_proposal_{phase}_pre_nms_sample_number"], deltas.shape[1]),
            target_means=cfg["rpn_proposal_means"],
            target_stds=cfg["rpn_proposal_stds"],
            clip_deltas=self.clip_deltas,
        )

    def _roi_levels(self, rois: torch.Tensor) -> torch.Tensor:
        """Pyramid level per roi: floor(4 + log2(sqrt(wh) / 224)) clamped to
        [min_level, max_level]. rois [..., 4] xyxy -> int64 [...]."""
        wq = (rois[..., 2] - rois[..., 0]).clamp_min(0.0)
        hq = (rois[..., 3] - rois[..., 1]).clamp_min(0.0)
        levels = torch.floor(4.0 + torch.log2(torch.sqrt(wq * hq + 1e-8) / 224.0))
        return levels.clamp(self.min_level, self.max_level).long()

    def _roi_features(self, p_list, rois, roi_valid, image_hw):
        """Level-assigned RoIAlign of p2..p5, pooled: [B, N, P, P, C]."""
        n = self.max_level - self.min_level + 1
        levels = self._roi_levels(rois) - self.min_level
        ih, iw = image_hw[:, 0], image_hw[:, 1]
        crop = 2 * self.cfg["roi_pooling_size"]
        if self.cfg.get("tpu_roi_align_fused_levels", True):
            crops = roi_align_multilevel(p_list[:n], rois, levels, roi_valid, ih, iw, crop,
                                         self.strides[:n])
        else:
            crops = sum(roi_align_single_level(p_list[k], rois, (levels == k) & roi_valid, ih, iw,
                                               crop, self.strides[k]) for k in range(n))
        return max_pool_2x2_same(crops)

    def _roi_head(self, roi_feats):
        b, r = roi_feats.shape[:2]
        roi_scores, roi_deltas = self.roi_head(roi_feats.reshape(b * r, *roi_feats.shape[2:]))
        roi_softmax = torch.softmax(roi_scores, dim=-1).reshape(b, r, self.num_classes)
        return roi_softmax, roi_deltas.reshape(b, r, self.num_classes, 4)

    def _detect(self, images, image_hw):
        p_list, score_list, bbox_list = self._backbone_neck_rpn(images)
        rois, roi_valid = self._proposals(*self._flatten_levels(score_list, bbox_list), image_hw)
        roi_feats = self._roi_features(p_list, rois, roi_valid, image_hw)
        return (rois, roi_valid, *self._roi_head(roi_feats))

    # ------------------------------------------------------------------ loss
    def loss_fn(self, images, image_hw, gt_boxes, gt_mask, gt_labels, draws=None):
        """One training batch -> (total loss, metrics).

        images [B, Hp, Wp, 3]; image_hw [B, 2]; gt_boxes [B, G, 4] xyxy
        pixels with gt_mask [B, G] and gt_labels [B, G] (class ids >= 1);
        numpy or tensors. `draws` is the samplers' `TrainDraws`, or a
        `torch.Generator` on the detector's device to draw them from, or None
        for the detector's own `generator`. Metrics (0-dim tensors, read
        nothing back): rpn_cls_loss, rpn_reg_loss, roi_cls_loss,
        roi_reg_loss, total_loss, and the per-image means of num_proposals,
        num_rpn_fg, num_rpn_bg, num_roi_fg.
        """
        cfg = self.cfg
        images, image_hw = self._as_inputs(images, image_hw)
        gt_boxes = torch.as_tensor(gt_boxes, dtype=torch.float32, device=self.device)
        gt_mask = torch.as_tensor(gt_mask, device=self.device).bool()
        gt_labels = torch.as_tensor(gt_labels, device=self.device).long()
        b = images.shape[0]
        s = cfg["roi_total_sample_number"]
        h, w = image_hw[:, 0], image_hw[:, 1]

        p_list, score_list, bbox_list = self._backbone_neck_rpn(images)
        scores2, deltas, grids = self._flatten_levels(score_list, bbox_list)
        anchors = self.anchors_for_grids(grids)
        if not isinstance(draws, TrainDraws):
            draws = TrainDraws.sample(
                self.generator if draws is None else draws, b, anchors.shape[0],
                cfg["rpn_proposal_train_after_nms_sample_number"], s,
            )
        with torch.no_grad():  # proposals and targets carry no gradient
            rois, roi_valid = self._proposals(scores2, deltas, grids, image_hw, training=True)
            at = anchor_target(
                anchors, gt_boxes, gt_mask, h, w, draws.anchor_fg, draws.anchor_bg,
                pos_iou_threshold=cfg["rpn_pos_iou_threshold"],
                neg_iou_threshold=cfg["rpn_neg_iou_threshold"],
                total_num_samples=cfg["rpn_total_sample_number"],
                max_pos_samples=cfg["rpn_pos_sample_max_number"],
                target_means=tuple(cfg["rpn_proposal_means"]),
                target_stds=tuple(cfg["rpn_proposal_stds"]),
            )
            pt = proposal_target(
                rois, roi_valid, gt_boxes, gt_mask, gt_labels,
                draws.roi_fg, draws.roi_bg, draws.roi_bg_gumbel,
                num_classes=self.num_classes,
                pos_iou_threshold=cfg["roi_pos_iou_threshold"],
                neg_iou_threshold=cfg["roi_neg_iou_threshold"],
                total_num_samples=s,
                max_pos_samples=cfg["roi_pos_sample_max_number"],
                target_means=tuple(cfg["roi_proposal_means"]),
                target_stds=tuple(cfg["roi_proposal_stds"]),
                strict_class_column=bool(cfg.get("strict_reference_parity", False)),
            )
        rpn_cls = cls_loss(scores2, at.labels, at.labels >= 0).mean()
        rpn_reg = smooth_l1_loss(deltas, at.bbox_targets, at.in_weights, at.out_weights,
                                 sigma=cfg["rpn_sigma"], dim=(1, 2))

        # every sampled slot is cropped, as in JAX (no validity mask)
        roi_feats = self._roi_features(p_list, pt.rois, torch.ones_like(pt.valid), image_hw)
        roi_scores, roi_deltas = self.roi_head(roi_feats.reshape(b * s, *roi_feats.shape[2:]))
        roi_cls = cls_loss(roi_scores, pt.labels.reshape(-1))
        roi_reg = smooth_l1_loss(roi_deltas, pt.bbox_targets.reshape(b * s, -1),
                                 pt.in_weights.reshape(b * s, -1),
                                 pt.out_weights.reshape(b * s, -1),
                                 sigma=cfg["roi_sigma"], dim=(1,))
        metrics = {"rpn_cls_loss": rpn_cls, "rpn_reg_loss": rpn_reg,
                   "roi_cls_loss": roi_cls, "roi_reg_loss": roi_reg}
        total = sum(metrics.values())
        metrics["total_loss"] = total
        counts = {"num_proposals": roi_valid, "num_rpn_fg": at.labels == 1,
                  "num_rpn_bg": at.labels == 0, "num_roi_fg": pt.labels > 0}
        for k, v in counts.items():
            metrics[k] = v.float().sum(dim=-1).mean()
        return total, metrics
