"""Faster R-CNN detector (VGG16, ResNet-50/101/152), serving and training
(port of `tf_eager_object_detection_tpu/models/faster_rcnn.py`).

One `nn.Module` holds the backbone (VGG16's 13 convolutions, 512 channels,
or ResNet's conv1..conv4, 1024 channels), the RPN head and the RoI head
(VGG16's fc layers with dropout, or ResNet's conv5 stack);
the detection logic runs on padded fixed-shape tensors with the batch
dimension explicit, so the RPN NMS of a whole batch is one call. Image
tensors are padded to a bucket shape; `image_hw` carries each image's valid
extent and anchors over the padding are masked out (score = -inf). The
serving entry points (`predict`, `im_detect`, `im_detect_batch`) are those
of `models/detector.py`.

`loss_fn` is the training loss, the JAX `loss_fn` with the batch explicit
instead of a per-image vmap: the proposals at the training sizes (one RPN
NMS per batch), the RPN and RoI targets and the four losses of
`models/detector.py::_detection_loss`, and the RoI crop
`roi_crop_faster_rcnn` (two matmuls) with autograd
through it into the backbone. VGG16's RoI head drops out only there, with
the keep masks of the step's `TrainDraws`, as JAX passes `train=True` in
`loss_fn` alone.

The debug entry points `predict_rpn` (positive anchors of one image) and
`predict_roi` (its RoI training batch from the training-size proposals)
take injectable draws like `loss_fn`; `test_one_image` is
`models/detector.py`'s.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from tf_eager_object_detection_tpu_torch.core.anchors import (
    generate_anchor_base,
    shift_anchor_base,
    valid_anchor_mask,
)
from tf_eager_object_detection_tpu_torch.models.backbones.resnet import (
    ResNetBackbone,
    ResNetRoiHead,
)
from tf_eager_object_detection_tpu_torch.models.backbones.vgg import (
    VGG16_HIDDEN,
    Vgg16Extractor,
    Vgg16RoiHead,
)
from tf_eager_object_detection_tpu_torch.models.detector import RESNET_DEPTHS, ServingDetector
from tf_eager_object_detection_tpu_torch.models.heads import (
    RpnHead,
    frcnn_score_logits,
    reshuffle_frcnn_scores,
)
from tf_eager_object_detection_tpu_torch.ops.region_proposal import region_proposal
from tf_eager_object_detection_tpu_torch.ops.roi_align import roi_crop_faster_rcnn

__all__ = ["FasterRCNNDetector"]


class FasterRCNNDetector(ServingDetector):
    model_type = "faster_rcnn"
    _FIXED_INIT_STD = {
        "rpn_head.rpn_first_conv": 0.01,
        "rpn_head.rpn_score_conv": 0.01,
        "rpn_head.rpn_bbox_conv": 0.01,
        "roi_head.roi_head_score": 0.01,
        "roi_head.roi_head_bboxes": 0.001,
    }

    def __init__(self, backbone: str, config: Dict[str, Any], device="cuda", seed: int = 0):
        super().__init__(backbone, config, device)
        cfg = self.cfg
        self.stride = cfg["extractor_stride"]
        self.extractor_levels = self.stride.bit_length() - 1  # log2 of the stride
        self.min_edge = float(self.stride)
        self.num_anchors = len(cfg["ratios"]) * len(cfg["scales"])
        self.anchor_base = generate_anchor_base(self.stride, cfg["ratios"], cfg["scales"])

        dt = self.compute_dtype
        if backbone == "vgg16":
            self.roi_max_pooling = cfg["vgg16_roi_pooling_max_pooling_flag"]
            self.extractor = Vgg16Extractor(dt)
            self.rpn_head = RpnHead(512, self.num_anchors, dt)
            h, w, c = cfg["vgg16_roi_feature_size"]
            self.roi_head = Vgg16RoiHead(self.num_classes, cfg["roi_head_keep_dropout_rate"],
                                         h * w * c, dt)
            self.roi_dropout = (self.roi_head.keep_prob, VGG16_HIDDEN)
        else:
            self.roi_max_pooling = cfg["resnet_roi_pooling_max_pooling_flag"]
            self.extractor = ResNetBackbone(RESNET_DEPTHS[backbone], compute_dtype=dt)
            self.rpn_head = RpnHead(1024, self.num_anchors, dt)
            self.roi_head = ResNetRoiHead(self.num_classes, dt)
        self._anchor_cache: dict = {}
        self._place(seed)

    # --------------------------------------------------------------- anchors
    def anchors_for_grid(self, grid_h: int, grid_w: int) -> torch.Tensor:
        """[gh * gw * A, 4] anchors, cached as a normal tensor even when first
        asked for under serving's `torch.inference_mode`."""
        key = (grid_h, grid_w)
        if key not in self._anchor_cache:
            with torch.inference_mode(False):
                self._anchor_cache[key] = torch.as_tensor(
                    shift_anchor_base(self.anchor_base, self.stride, grid_h, grid_w),
                    device=self.device,
                )
        return self._anchor_cache[key]

    def feature_grids(self, height: int, width: int) -> list:
        """The one stride-16 map: every stride-2 stage of the extractor
        rounds up (SAME padding, or an explicit pad of the same effect)."""
        return [(-(-height // self.stride), -(-width // self.stride))]

    # ----------------------------------------------------------- shared path
    def _backbone_rpn(self, images: torch.Tensor):
        """-> (feats [B, h, w, 512 or 1024] in the compute dtype, score and bbox maps
        float32), feats gathered whole under `row_shard`. With `tpu_remat`,
        a training forward keeps no activation of the extractor and
        recomputes them in the backward."""
        if self.cfg.get("tpu_remat", False) and torch.is_grad_enabled():
            # under spatial partitioning the recompute repeats the halo
            # exchanges and the gather, in the same order on every rank
            feats = checkpoint(self._extract, images, use_reentrant=False)
        else:
            feats = self._extract(images)
        score_map, bbox_map = self.rpn_head(feats)
        return feats, score_map.float(), bbox_map.float()

    def _proposals(self, score_map, bbox_map, image_hw, training: bool = False):
        """Batched proposals at the test or the training sizes. score/bbox
        maps: [B, h, w, *]."""
        cfg = self.cfg
        phase = "train" if training else "test"
        b, gh, gw, _ = score_map.shape
        scores = reshuffle_frcnn_scores(score_map, self.num_anchors)
        deltas = bbox_map.reshape(b, -1, 4)
        h, w = image_hw[:, 0], image_hw[:, 1]
        avalid = valid_anchor_mask(
            gh, gw, self.num_anchors,
            (h + self.stride - 1) // self.stride, (w + self.stride - 1) // self.stride,
        )
        return region_proposal(
            deltas,
            self.anchors_for_grid(gh, gw),
            scores,
            avalid,
            h,
            w,
            num_post_nms=cfg[f"rpn_proposal_{phase}_after_nms_sample_number"],
            nms_iou_threshold=cfg["rpn_proposal_nms_iou_threshold"],
            num_pre_nms=min(cfg[f"rpn_proposal_{phase}_pre_nms_sample_number"], deltas.shape[1]),
            target_means=cfg["rpn_proposal_means"],
            target_stds=cfg["rpn_proposal_stds"],
            clip_deltas=self.clip_deltas,
        )

    def _roi_outputs(self, feats, rois, keep=None):
        """RoI crops of `rois` [B, R, 4] through the RoI head ->
        (roi_scores [B * R, C], roi_deltas [B * R, 4C]). `keep`: VGG16's
        dropout masks [2, B * R, 4096] in training, else None."""
        roi_feats = roi_crop_faster_rcnn(
            feats, rois, self.stride, self.cfg["roi_pooling_size"], self.roi_max_pooling
        )
        roi_feats = roi_feats.reshape(-1, *roi_feats.shape[2:])
        if keep is None:
            return self.roi_head(roi_feats)
        return self.roi_head(roi_feats, keep)

    def _roi_forward(self, feats, score_map, bbox_map, image_hw):
        """Batched eval path up to the raw RoI head outputs."""
        rois, roi_valid = self._proposals(score_map, bbox_map, image_hw)
        b, r, _ = rois.shape
        roi_scores, roi_deltas = self._roi_outputs(feats, rois)
        roi_softmax = torch.softmax(roi_scores, dim=-1).reshape(b, r, self.num_classes)
        return rois, roi_valid, roi_softmax, roi_deltas.reshape(b, r, self.num_classes, 4)

    def _detect(self, images, image_hw):
        return self._roi_forward(*self._backbone_rpn(images), image_hw)

    # ------------------------------------------------------------ debug APIs
    @torch.inference_mode()
    def predict_rpn(self, image, image_hw, gt_boxes, gt_mask, draws=None):
        """Positive RPN anchors for one image (JAX `predict_rpn`, reference
        base_faster_rcnn_model.py:226-241) -> (anchors [A, 4], positive
        mask [A]). image [Hp, Wp, 3]; image_hw [2]; gt_boxes [G, 4] xyxy
        pixels with gt_mask [G]. `draws`: a `TrainDraws` of one image (its
        anchor_fg / anchor_bg [1, A] are read), a `torch.Generator` on the
        device to draw them from, or None for the detector's own."""
        images, hw, boxes, mask, _ = self._debug_inputs(image, image_hw, gt_boxes, gt_mask)
        feats, _, _ = self._backbone_rpn(images)
        anchors = self.anchors_for_grid(feats.shape[1], feats.shape[2])
        return self._anchor_targets_one(anchors, hw, boxes, mask, draws)

    @torch.inference_mode()
    def predict_roi(self, image, image_hw, gt_boxes, gt_mask, gt_labels, draws=None):
        """The proposal-target training batch of one image (JAX
        `predict_roi`, reference base_faster_rcnn_model.py:243-265): the
        proposals at the training sizes, then `proposal_target` ->
        `ProposalTargets` without the batch axis. `draws` as in
        `predict_rpn`, of which roi_fg / roi_bg [1, R] and roi_bg_gumbel
        [1, S, R] are read."""
        images, hw, boxes, mask, labels = self._debug_inputs(image, image_hw, gt_boxes, gt_mask,
                                                             gt_labels)
        _, score_map, bbox_map = self._backbone_rpn(images)
        rois, roi_valid = self._proposals(score_map, bbox_map, hw, training=True)
        return self._proposal_targets_one(rois, roi_valid, boxes, mask, labels, draws)

    # ------------------------------------------------------------------ loss
    def loss_fn(self, images, image_hw, gt_boxes, gt_mask, gt_labels, draws=None):
        """One training batch -> (total loss, metrics).

        images [B, Hp, Wp, 3]; image_hw [B, 2]; gt_boxes [B, G, 4] xyxy
        pixels with gt_mask [B, G] and gt_labels [B, G] (class ids >= 1);
        numpy or tensors. `draws` is the samplers' `TrainDraws`, or a
        `torch.Generator` on the detector's device to draw them from, or None
        for the detector's own `generator`; with VGG16 the draws carry the
        RoI head's dropout masks. Metrics: those of
        `ServingDetector._detection_loss`.
        """
        images, image_hw, *gt = self._train_inputs(images, image_hw, gt_boxes, gt_mask,
                                                   gt_labels)
        feats, score_map, bbox_map = self._backbone_rpn(images)
        b, gh, gw, _ = score_map.shape
        return self._detection_loss(
            image_hw, *gt, draws, self.anchors_for_grid(gh, gw),
            frcnn_score_logits(score_map, self.num_anchors), bbox_map.reshape(b, -1, 4),
            lambda: self._proposals(score_map, bbox_map, image_hw, training=True),
            lambda rois, keep: self._roi_outputs(feats, rois, keep),
        )
