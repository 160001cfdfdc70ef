"""Faster R-CNN detector, serving path (port of `tf_eager_object_detection_tpu/models/faster_rcnn.py`).

One `nn.Module` holds the backbone, the RPN head and the RoI head; the
detection logic runs on padded fixed-shape tensors with the batch dimension
explicit, so the RPN NMS of a whole batch is one call. Image tensors are
padded to a bucket shape; `image_hw` carries each image's valid extent and
anchors over the padding are masked out (score = -inf).

- `predict(image, image_hw)` -> padded `Detections` for one image.
- `im_detect(image, image_hw, scale)` / `im_detect_batch(images, image_hw,
  scales)` -> raw-head outputs with rois rescaled by 1/scale, for the eval
  writers.

Serving is float32 with TF32 off: on a CUDA device the constructor sets
`torch.backends.cudnn.allow_tf32` and `torch.backends.cuda.matmul.allow_tf32`
to False for the process.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch import nn

from tf_eager_object_detection_tpu_torch.core.anchors import (
    generate_anchor_base,
    shift_anchor_base,
    valid_anchor_mask,
)
from tf_eager_object_detection_tpu_torch.models.backbones.resnet import (
    ResNetBackbone,
    ResNetRoiHead,
)
from tf_eager_object_detection_tpu_torch.models.heads import RpnHead, reshuffle_frcnn_scores
from tf_eager_object_detection_tpu_torch.ops.prediction import Detections, post_ops_prediction
from tf_eager_object_detection_tpu_torch.ops.region_proposal import region_proposal
from tf_eager_object_detection_tpu_torch.ops.roi_align import roi_crop_faster_rcnn

__all__ = ["FasterRCNNDetector"]

_RESNET_DEPTHS = {"resnet50": 50, "resnet101": 101, "resnet152": 152}

# init std of the layers the flax modules initialize with a fixed normal;
# every other conv/dense gets lecun normal (std = fan_in ** -0.5)
_FIXED_INIT_STD = {
    "rpn_head.rpn_first_conv": 0.01,
    "rpn_head.rpn_score_conv": 0.01,
    "rpn_head.rpn_bbox_conv": 0.01,
    "roi_head.roi_head_score": 0.01,
    "roi_head.roi_head_bboxes": 0.001,
}


def _resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is False"
        )
    return device


class FasterRCNNDetector(nn.Module):
    model_type = "faster_rcnn"

    def __init__(self, backbone: str, config: Dict[str, Any], device="cpu", seed: int = 0):
        super().__init__()
        device = _resolve_device(device)
        cfg = dict(config)
        if backbone not in _RESNET_DEPTHS:
            raise NotImplementedError(
                f"backbone {backbone!r} is not ported yet (ROADMAP queue 1, other backbones)"
            )
        if cfg.get("tpu_compute_dtype", "float32") != "float32":
            raise NotImplementedError("the port serves float32 only; bf16 is a later item")
        self.cfg = cfg
        self.backbone_name = backbone
        self.num_classes = cfg["num_classes"]
        self.stride = cfg["extractor_stride"]
        self.num_anchors = len(cfg["ratios"]) * len(cfg["scales"])
        self.anchor_base = generate_anchor_base(self.stride, cfg["ratios"], cfg["scales"])
        self.roi_max_pooling = cfg["resnet_roi_pooling_max_pooling_flag"]
        self.clip_deltas = not cfg.get("strict_reference_parity", False)

        self.extractor = ResNetBackbone(_RESNET_DEPTHS[backbone])
        self.rpn_head = RpnHead(1024, self.num_anchors)
        self.roi_head = ResNetRoiHead(self.num_classes)
        self._init_weights(seed)
        self.to(device).eval()
        self.device = device
        self._anchor_cache: dict = {}
        if device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        """Seeded random init (normal draws from a CPU torch.Generator)."""
        gen = torch.Generator().manual_seed(seed)
        for name, mod in self.named_modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                fan_in = mod.weight[0].numel()
                std = _FIXED_INIT_STD.get(name, 1.0 / math.sqrt(fan_in))
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen) * std)
                mod.bias.zero_()

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

    def _as_inputs(self, images, image_hw):
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        image_hw = torch.as_tensor(image_hw, device=self.device).long()
        return images, image_hw

    # --------------------------------------------------------------- predict
    @torch.inference_mode()
    def predict(self, image, image_hw) -> Detections:
        """Single padded image [Hp, Wp, 3] -> padded Detections."""
        cfg = self.cfg
        images, hw = self._as_inputs(image, image_hw)
        images, hw = images[None], hw[None]
        rois, roi_valid, roi_softmax, roi_deltas = self._roi_forward(
            *self._backbone_rpn(images), hw
        )
        return post_ops_prediction(
            roi_softmax[0],
            roi_deltas[0],
            rois[0],
            roi_valid[0],
            hw[0, 0],
            hw[0, 1],
            target_means=tuple(cfg["roi_proposal_means"]),
            target_stds=tuple(cfg["roi_proposal_stds"]),
            max_num_per_class=cfg["max_objects_per_class_per_image"],
            max_num_per_image=cfg["max_objects_per_image"],
            nms_iou_threshold=cfg["prediction_nms_iou_threshold"],
            score_threshold=cfg["prediction_score_threshold"],
            min_edge=float(self.stride),
            num_classes=self.num_classes,
            clip_deltas=self.clip_deltas,
        )

    @torch.inference_mode()
    def im_detect_batch(self, images, image_hw, scales):
        """images [B, Hp, Wp, 3], image_hw [B, 2], scales [B] ->
        (roi_softmax [B, R, C], roi_deltas [B, R, C, 4], rois/scale [B, R, 4],
        roi_valid [B, R])."""
        images, hw = self._as_inputs(images, image_hw)
        scales = torch.as_tensor(scales, dtype=torch.float32, device=self.device)
        rois, roi_valid, roi_softmax, roi_deltas = self._roi_forward(
            *self._backbone_rpn(images), hw
        )
        return roi_softmax, roi_deltas, rois / scales[:, None, None], roi_valid

    def im_detect(self, image, image_hw, scale):
        """Raw-head eval API for one image: (roi_softmax [R, C], roi_deltas
        [R, C, 4], rois/scale [R, 4], roi_valid [R])."""
        out = self.im_detect_batch(
            torch.as_tensor(image)[None], torch.as_tensor(image_hw)[None],
            torch.as_tensor(scale, dtype=torch.float32)[None],
        )
        return tuple(t[0] for t in out)
