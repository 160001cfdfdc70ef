"""FPN detector (ResNet-50/101/152), serving and training
(port of `tf_eager_object_detection_tpu/models/fpn.py`).

- extractor: multi-output ResNet (c2..c5, conv5 inside the extractor),
  keras-style or, with `tpu_fpn_backbone_style: "slim"`, slim-style
  (`models/backbones/resnet.py`; any other style raises ValueError);
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

Under bfloat16 compute (`tpu_compute_dtype`) the convolutions and fc1 / fc2
compute in bfloat16 and the rest follows JAX's type promotion: the neck's
upsample (float32 matrices) and its fused sums are float32 until the next
3x3 conv, p2..p6 are bfloat16 and go to the RoIAlign kernels as they are
(the crops are float32), and the RPN maps and the score and box heads are
float32.

`loss_fn` is the training loss: RPN targets over every anchor and RoI
targets over the training proposals (both under `torch.no_grad()`, with
random draws from `ops/sampling.py::TrainDraws`), then the four losses and
the sample counts under the JAX metric names.

Invalid proposal slots (`roi_valid` False) get zero RoI features, so their
rows of `im_detect_batch` differ from the JAX detector's, which crops them
at the origin; post-processing masks them out either way. The serving
entry points are those of `models/detector.py`; `predict` keeps boxes with
sides of at least 16 px, as the reference hardcodes. The debug entry points
`predict_rpns` (positive anchors over all levels) and `predict_rois` (the
RoI training batch of the test-size proposals, as JAX takes them) take
injectable draws like `loss_fn`.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Sequence

import numpy as np
import torch
from torch import nn

from tf_eager_object_detection_tpu_torch.core.anchors import make_level_anchors, valid_anchor_mask
from tf_eager_object_detection_tpu_torch.models.backbones.resnet import (
    ResNetBackbone,
    SlimResNetBackbone,
)
from tf_eager_object_detection_tpu_torch.models.detector import RESNET_DEPTHS, ServingDetector
from tf_eager_object_detection_tpu_torch.models.heads import RpnHead
from tf_eager_object_detection_tpu_torch.models.layers import Conv2d, Linear, SameConv2d
from tf_eager_object_detection_tpu_torch.ops.region_proposal import region_proposal
from tf_eager_object_detection_tpu_torch.ops.roi_align import (
    max_pool_2x2_same,
    roi_align_multilevel,
    roi_align_single_level,
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
    """TF1 bilinear resize of [B, C, H, W]: H contracted first, then W; float32
    (a bfloat16 input is upcast, as float32 matrices promote it in JAX)."""
    wy = _interp_matrix_on(out_h, x.shape[-2], x.device)
    wx = _interp_matrix_on(out_w, x.shape[-1], x.device)
    return torch.matmul(torch.matmul(wy, x.float()), wx.T)


def resize_bilinear_tf1(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, out_h, out_w, C] with TF1 legacy semantics."""
    return _resize_nchw(x.permute(0, 3, 1, 2), out_h, out_w).permute(0, 2, 3, 1)


class ResnetFpnNeck(nn.Module):
    """(c2, c3, c4, c5) NHWC -> (p2, p3, p4, p5, p6) NHWC; convs run in NCHW
    and compute in `compute_dtype`; the upsampled and fused maps are float32."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048), dims: int = 256,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        c2, c3, c4, c5 = in_channels
        dt = compute_dtype
        self.build_p5 = Conv2d(c5, dims, 1, compute_dtype=dt)
        self.build_p4_reduce_dims = Conv2d(c4, dims, 1, compute_dtype=dt)
        self.build_p3_reduce_dims = Conv2d(c3, dims, 1, compute_dtype=dt)
        self.build_p2_reduce_dims = Conv2d(c2, dims, 1, compute_dtype=dt)
        self.build_p4 = SameConv2d(dims, dims, 3, compute_dtype=dt)
        self.build_p3 = SameConv2d(dims, dims, 3, compute_dtype=dt)
        self.build_p2 = SameConv2d(dims, dims, 3, compute_dtype=dt)

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
    """[N, 7, 7, C] NHWC -> (scores [N, classes], deltas [N, 4 * classes]):
    fc1 and fc2 in `compute_dtype`, the score and box heads in float32."""

    def __init__(self, num_classes: int = 21, in_features: int = 7 * 7 * 256,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(in_features, 1024, compute_dtype)
        self.fc2 = Linear(1024, 1024, compute_dtype)
        self.roi_head_score = nn.Linear(1024, num_classes)
        self.roi_head_bboxes = nn.Linear(1024, 4 * num_classes)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = x.reshape(x.shape[0], -1)  # NHWC order, as the bridged fc1 expects
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x)).float()
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

        dt = self.compute_dtype
        self.backbone_style = cfg.get("tpu_fpn_backbone_style", "keras")
        if self.backbone_style == "slim":
            self.extractor = SlimResNetBackbone(RESNET_DEPTHS[backbone], dt)
        elif self.backbone_style == "keras":
            self.extractor = ResNetBackbone(
                RESNET_DEPTHS[backbone], return_stages=("c2", "c3", "c4", "c5"),
                include_c5=True, compute_dtype=dt,
            )
        else:
            raise ValueError(f"unknown tpu_fpn_backbone_style {self.backbone_style!r}: "
                             "expected 'keras' or 'slim'")
        self.neck = ResnetFpnNeck(dims=dims, compute_dtype=dt)
        self.rpn_head = RpnHead(dims, self.num_anchors, dt)
        pool = cfg["roi_pooling_size"]
        self.roi_head = FpnRoiHead(self.num_classes, pool * pool * dims, dt)
        self._anchor_cache: dict = {}
        self._place(seed)

    def _init_std(self, name: str, fan_in: int) -> float:
        if name.startswith("neck.") or (self.backbone_style == "slim"
                                        and name.startswith("extractor.")):
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
        """Level-assigned RoIAlign of p2..p5 (in their own dtype), pooled:
        [B, N, P, P, C] float32."""
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

    # ------------------------------------------------------------ debug APIs
    @torch.inference_mode()
    def predict_rpns(self, image, image_hw, gt_boxes, gt_mask, draws=None):
        """Positive RPN anchors for one image over the concatenation of all
        pyramid levels (JAX `predict_rpns`, reference base_fpn_model.py:
        326-339) -> (anchors [A, 4], positive mask [A]). Arguments as
        `FasterRCNNDetector.predict_rpn`'s."""
        images, hw, boxes, mask, _ = self._debug_inputs(image, image_hw, gt_boxes, gt_mask)
        _, score_list, _ = self._backbone_neck_rpn(images)
        grids = tuple((s.shape[1], s.shape[2]) for s in score_list)
        return self._anchor_targets_one(self.anchors_for_grids(grids), hw, boxes, mask, draws)

    @torch.inference_mode()
    def predict_rois(self, image, image_hw, gt_boxes, gt_mask, gt_labels, draws=None):
        """The proposal-target training batch of one image (JAX
        `predict_rois`, reference base_fpn_model.py:341-362): the proposals
        at the test sizes, as JAX takes them, then `proposal_target` ->
        `ProposalTargets` without the batch axis. Arguments as
        `FasterRCNNDetector.predict_roi`'s."""
        images, hw, boxes, mask, labels = self._debug_inputs(image, image_hw, gt_boxes, gt_mask,
                                                             gt_labels)
        _, score_list, bbox_list = self._backbone_neck_rpn(images)
        rois, roi_valid = self._proposals(*self._flatten_levels(score_list, bbox_list), hw)
        return self._proposal_targets_one(rois, roi_valid, boxes, mask, labels, draws)

    # ------------------------------------------------------------------ loss
    def loss_fn(self, images, image_hw, gt_boxes, gt_mask, gt_labels, draws=None):
        """One training batch -> (total loss, metrics).

        images [B, Hp, Wp, 3]; image_hw [B, 2]; gt_boxes [B, G, 4] xyxy
        pixels with gt_mask [B, G] and gt_labels [B, G] (class ids >= 1);
        numpy or tensors. `draws` is the samplers' `TrainDraws`, or a
        `torch.Generator` on the detector's device to draw them from, or None
        for the detector's own `generator`. Metrics: those of
        `ServingDetector._detection_loss`.
        """
        images, image_hw, *gt = self._train_inputs(images, image_hw, gt_boxes, gt_mask,
                                                   gt_labels)
        p_list, score_list, bbox_list = self._backbone_neck_rpn(images)
        scores2, deltas, grids = self._flatten_levels(score_list, bbox_list)

        def roi_outputs(rois, keep):  # keep: None, the FPN head has no dropout
            every = torch.ones(rois.shape[:2], dtype=torch.bool, device=rois.device)
            feats = self._roi_features(p_list, rois, every, image_hw)
            return self.roi_head(feats.reshape(-1, *feats.shape[2:]))

        return self._detection_loss(
            image_hw, *gt, draws, self.anchors_for_grids(grids), scores2, deltas,
            lambda: self._proposals(scores2, deltas, grids, image_hw, training=True),
            roi_outputs,
        )
