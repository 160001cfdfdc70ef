"""Faster R-CNN detector, serving path (port of `tf_eager_object_detection_tpu/models/faster_rcnn.py`).

One `nn.Module` holds the backbone, the RPN head and the RoI head; the
detection logic runs on padded fixed-shape tensors with the batch dimension
explicit, so the RPN NMS of a whole batch is one call. Image tensors are
padded to a bucket shape; `image_hw` carries each image's valid extent and
anchors over the padding are masked out (score = -inf). The serving entry
points (`predict`, `im_detect`, `im_detect_batch`) are those of
`models/detector.py`.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from tf_eager_object_detection_tpu_torch.core.anchors import (
    generate_anchor_base,
    shift_anchor_base,
    valid_anchor_mask,
)
from tf_eager_object_detection_tpu_torch.models.backbones.resnet import (
    ResNetBackbone,
    ResNetRoiHead,
)
from tf_eager_object_detection_tpu_torch.models.detector import RESNET_DEPTHS, ServingDetector
from tf_eager_object_detection_tpu_torch.models.heads import RpnHead, reshuffle_frcnn_scores
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
        self.min_edge = float(self.stride)
        self.num_anchors = len(cfg["ratios"]) * len(cfg["scales"])
        self.anchor_base = generate_anchor_base(self.stride, cfg["ratios"], cfg["scales"])
        self.roi_max_pooling = cfg["resnet_roi_pooling_max_pooling_flag"]

        self.extractor = ResNetBackbone(RESNET_DEPTHS[backbone])
        self.rpn_head = RpnHead(1024, self.num_anchors)
        self.roi_head = ResNetRoiHead(self.num_classes)
        self._anchor_cache: dict = {}
        self._place(seed)

    # --------------------------------------------------------------- anchors
    def anchors_for_grid(self, grid_h: int, grid_w: int) -> torch.Tensor:
        key = (grid_h, grid_w)
        if key not in self._anchor_cache:
            self._anchor_cache[key] = torch.as_tensor(
                shift_anchor_base(self.anchor_base, self.stride, grid_h, grid_w),
                device=self.device,
            )
        return self._anchor_cache[key]

    # ----------------------------------------------------------- shared path
    def _backbone_rpn(self, images: torch.Tensor):
        feats = self.extractor(images)
        score_map, bbox_map = self.rpn_head(feats)
        return feats, score_map.float(), bbox_map.float()

    def _proposals(self, score_map, bbox_map, image_hw):
        """Batched test-time proposals. score/bbox maps: [B, h, w, *]."""
        cfg = self.cfg
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
            num_post_nms=cfg["rpn_proposal_test_after_nms_sample_number"],
            nms_iou_threshold=cfg["rpn_proposal_nms_iou_threshold"],
            num_pre_nms=min(cfg["rpn_proposal_test_pre_nms_sample_number"], deltas.shape[1]),
            target_means=cfg["rpn_proposal_means"],
            target_stds=cfg["rpn_proposal_stds"],
            clip_deltas=self.clip_deltas,
        )

    def _roi_forward(self, feats, score_map, bbox_map, image_hw):
        """Batched eval path up to the raw RoI head outputs."""
        rois, roi_valid = self._proposals(score_map, bbox_map, image_hw)
        b, r, _ = rois.shape
        roi_feats = roi_crop_faster_rcnn(
            feats, rois, self.stride, self.cfg["roi_pooling_size"], self.roi_max_pooling
        )
        roi_scores, roi_deltas = self.roi_head(roi_feats.reshape(b * r, *roi_feats.shape[2:]))
        roi_softmax = torch.softmax(roi_scores, dim=-1).reshape(b, r, self.num_classes)
        return rois, roi_valid, roi_softmax, roi_deltas.reshape(b, r, self.num_classes, 4)

    def _detect(self, images, image_hw):
        return self._roi_forward(*self._backbone_rpn(images), image_hw)
