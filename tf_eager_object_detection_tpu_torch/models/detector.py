"""What the port's two detectors share: device placement, seeded random
weights, the freeze policy, the serving entry points and the training loss
around the RPN and RoI heads.

- `predict(image, image_hw)` -> padded `Detections` for one image.
- `im_detect(image, image_hw, scale)` / `im_detect_batch(images, image_hw,
  scales)` -> raw-head outputs with rois rescaled by 1/scale, for the eval
  writers.
- `test_one_image(img_path, preprocessing_type, image_format)` -> the valid
  detections of one image file on its own coordinates (`test_one_image_impl`).
- `_anchor_targets_one` / `_proposal_targets_one`: the debug entry points
  of the subclasses (`predict_rpn(s)`, `predict_roi(s)`) build one image's
  RPN or RoI targets with them.
- `_detection_loss(...)`: a subclass's `loss_fn` hands it the RPN outputs,
  its proposals and its RoI head; it draws the samplers' random numbers,
  builds the RPN and RoI targets, and returns the four losses and the
  sample counts under the JAX metric names.

A subclass builds its modules, calls `_place(seed)`, and defines
`_detect(images, image_hw) -> (rois [B, R, 4], roi_valid [B, R],
roi_softmax [B, R, C], roi_deltas [B, R, C, 4])` and `min_edge`, the
smallest box side `predict` keeps; a detector whose RoI head has dropout
(VGG16) sets `roi_dropout`, and `_detection_loss` draws the head's keep
masks with the samplers' numbers. Serving never drops out.

The config's `tpu_compute_dtype` ("float32" or "bfloat16"; anything else
raises) is the detector's `compute_dtype`, the flax modules' `dtype`: with
"bfloat16" the backbone, the neck, the RPN's first conv and the RoI heads'
convolutions and hidden dense layers compute in bfloat16 (see each
module), while parameters, gradients, momentum, checkpoints and all
detection geometry (anchors, deltas, proposals, NMS, targets, losses,
post-processing) stay float32, with no loss scaling. The float32 stages run
with TF32 off: on a CUDA device `_place` sets
`torch.backends.cudnn.allow_tf32` and
`torch.backends.cuda.matmul.allow_tf32` to False for the process. `_place`
also marks the frozen parameters (`models/freeze.py`). Entry points run on
the card unless the caller asks for the CPU; asking for CUDA where there is
none raises. The serving entry points run under `torch.inference_mode`; a
training loss (`loss_fn`) does not.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from tf_eager_object_detection_tpu_torch.models.freeze import freeze_
from tf_eager_object_detection_tpu_torch.models.layers import (
    FrozenBatchNorm,
    resolve_compute_dtype,
)
from tf_eager_object_detection_tpu_torch.ops.losses import cls_loss, smooth_l1_loss
from tf_eager_object_detection_tpu_torch.ops.prediction import Detections, post_ops_prediction
from tf_eager_object_detection_tpu_torch.ops.sampling import (
    TrainDraws,
    anchor_target,
    proposal_target,
)

__all__ = ["ServingDetector", "resolve_device", "read_image_file", "test_one_image_impl",
           "RESNET_DEPTHS", "BACKBONES"]

RESNET_DEPTHS = {"resnet50": 50, "resnet101": 101, "resnet152": 152}
# the backbones of each model type, as the JAX `model_factory` builds them
BACKBONES = {"faster_rcnn": ("vgg16", *RESNET_DEPTHS), "fpn": tuple(RESNET_DEPTHS)}


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def read_image_file(path: str) -> np.ndarray:
    """An image file -> RGB uint8 [H, W, 3], as JAX `test_one_image_impl`
    reads it: cv2, and on any exception (no cv2, or cv2 returning None for
    a format it cannot decode, such as TGA) PIL."""
    try:
        import cv2

        return cv2.imread(path)[..., ::-1]
    except Exception:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))


def test_one_image_impl(detector, img_path, preprocessing_type="caffe", image_format=None):
    """Load + preprocess + predict one image file with `detector.predict`
    (JAX `models/faster_rcnn.py::test_one_image_impl`, reference
    base_faster_rcnn_model.py:267-277) -> (boxes [N, 4] on the raw image's
    coordinates, labels [N], scores [N]) of the valid detections, numpy."""
    from tf_eager_object_detection_tpu_torch.data.preprocessing import preprocess_eval_image

    padded, hw, scale, _, _ = preprocess_eval_image(
        read_image_file(img_path), detector.cfg, preprocessing_type, image_format=image_format)
    det = detector.predict(padded, hw)
    v = det.valid.cpu().numpy()
    return (det.boxes.cpu().numpy()[v] / scale, det.labels.cpu().numpy()[v],
            det.scores.cpu().numpy()[v])


class ServingDetector(nn.Module):
    model_type: str
    min_edge: float
    # (keep probability, hidden width) of the RoI head's dropout layers, or
    # None for a head without dropout; `loss_fn` draws their masks
    roi_dropout: tuple[float, int] | None = None
    # init std of the layers the flax modules initialize with a fixed normal
    _FIXED_INIT_STD: Dict[str, float] = {}

    def __init__(self, backbone: str, config: Dict[str, Any], device):
        super().__init__()
        if backbone not in BACKBONES[self.model_type]:
            raise ValueError(f"unknown backbone {backbone} for {self.model_type}")
        self.device = resolve_device(device)
        cfg = dict(config)
        self.compute_dtype = resolve_compute_dtype(cfg.get("tpu_compute_dtype", "float32"))
        self.cfg = cfg
        self.backbone_name = backbone
        self.num_classes = cfg["num_classes"]
        self.clip_deltas = not cfg.get("strict_reference_parity", False)

    def _init_std(self, name: str, fan_in: int) -> float:
        """Lecun normal (std = fan_in ** -0.5) unless the layer has a fixed std."""
        return self._FIXED_INIT_STD.get(name, 1.0 / math.sqrt(fan_in))

    @torch.no_grad()
    def init_params(self, seed: int) -> None:
        """Seeded random weights, in place: convolution and dense weights
        from normal draws of a CPU torch.Generator, biases 0, FrozenBatchNorm
        statistics at the identity (gamma 1, beta 0, mean 0, variance 1), as
        the JAX `init_params` initializes them."""
        gen = torch.Generator().manual_seed(seed)
        for name, mod in self.named_modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                std = self._init_std(name, mod.weight[0].numel())
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen) * std)
                mod.bias.zero_()
            elif isinstance(mod, FrozenBatchNorm):
                for buf, value in (("gamma", 1.0), ("beta", 0.0), ("moving_mean", 0.0),
                                   ("moving_variance", 1.0)):
                    getattr(mod, buf).fill_(value)

    @torch.no_grad()
    def _place(self, seed: int) -> None:
        """`init_params(seed)`, the freeze policy, then move to `self.device`
        and switch to eval: no layer of the port reads `self.training`, and
        the only layer that differs in training, VGG16's dropout, is on
        exactly where `loss_fn` hands the RoI head its keep masks.
        `generator`, on the device and seeded alike, draws the samplers'
        random numbers and those masks when `loss_fn` is given none."""
        self.init_params(seed)
        freeze_(self)
        self.to(self.device).eval()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False

    def _as_inputs(self, images, image_hw):
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        image_hw = torch.as_tensor(image_hw, device=self.device).long()
        return images, image_hw

    def _train_inputs(self, images, image_hw, gt_boxes, gt_mask, gt_labels):
        images, image_hw = self._as_inputs(images, image_hw)
        return (images, image_hw,
                torch.as_tensor(gt_boxes, dtype=torch.float32, device=self.device),
                torch.as_tensor(gt_mask, device=self.device).bool(),
                torch.as_tensor(gt_labels, device=self.device).long())

    def _detect(self, images: torch.Tensor, image_hw: torch.Tensor):
        raise NotImplementedError

    def test_one_image(self, img_path, preprocessing_type="caffe", image_format=None):
        """One image file -> its valid detections (`test_one_image_impl`)."""
        return test_one_image_impl(self, img_path, preprocessing_type, image_format)

    def _debug_inputs(self, image, image_hw, gt_boxes, gt_mask, gt_labels=None):
        """One image's debug-API inputs as the batch of one `_train_inputs` gives."""
        labels = gt_labels if gt_labels is not None else np.zeros(np.shape(gt_mask), np.int64)
        return self._train_inputs(torch.as_tensor(image)[None], torch.as_tensor(image_hw)[None],
                                  torch.as_tensor(gt_boxes)[None],
                                  torch.as_tensor(gt_mask)[None], torch.as_tensor(labels)[None])

    def _draws_for_one(self, draws, num_anchors: int, num_rois: int) -> TrainDraws:
        """`draws` as `loss_fn` takes it, for one image, on the device."""
        if isinstance(draws, TrainDraws):
            return draws.to(self.device)
        return TrainDraws.sample(self.generator if draws is None else draws, 1, num_anchors,
                                 num_rois, self.cfg["roi_total_sample_number"])

    def _anchor_targets_one(self, anchors, image_hw, gt_boxes, gt_mask, draws):
        """(anchors [A, 4], positive mask [A]) of one image's RPN targets
        (JAX `predict_rpn(s)`: `anchor_target`'s labels == 1)."""
        cfg = self.cfg
        draws = self._draws_for_one(draws, anchors.shape[0],
                                    cfg["rpn_proposal_train_after_nms_sample_number"])
        at = anchor_target(
            anchors, gt_boxes, gt_mask, image_hw[:, 0], image_hw[:, 1],
            draws.anchor_fg, draws.anchor_bg,
            pos_iou_threshold=cfg["rpn_pos_iou_threshold"],
            neg_iou_threshold=cfg["rpn_neg_iou_threshold"],
            total_num_samples=cfg["rpn_total_sample_number"],
            max_pos_samples=cfg["rpn_pos_sample_max_number"],
        )
        return anchors, at.labels[0] == 1

    def _proposal_targets_one(self, rois, roi_valid, gt_boxes, gt_mask, gt_labels, draws):
        """One image's RoI training batch (`ProposalTargets` without the batch
        axis) from its proposals rois [1, R, 4] / roi_valid [1, R]."""
        cfg = self.cfg
        draws = self._draws_for_one(draws, 1, rois.shape[1])
        pt = proposal_target(
            rois, roi_valid, gt_boxes, gt_mask, gt_labels,
            draws.roi_fg, draws.roi_bg, draws.roi_bg_gumbel,
            num_classes=self.num_classes,
            pos_iou_threshold=cfg["roi_pos_iou_threshold"],
            neg_iou_threshold=cfg["roi_neg_iou_threshold"],
            total_num_samples=cfg["roi_total_sample_number"],
            max_pos_samples=cfg["roi_pos_sample_max_number"],
            target_means=tuple(cfg["roi_proposal_means"]),
            target_stds=tuple(cfg["roi_proposal_stds"]),
            strict_class_column=bool(cfg.get("strict_reference_parity", False)),
        )
        return type(pt)(*(t[0] for t in pt))

    def _detection_loss(self, image_hw, gt_boxes, gt_mask, gt_labels, draws, anchors,
                        rpn_logits, rpn_deltas, propose, roi_outputs):
        """The training losses of a batch from its RPN outputs -> (total, metrics).

        image_hw [B, 2] and the gt tensors as `_train_inputs` gives them;
        `draws` as `loss_fn` takes it; anchors [A, 4]; rpn_logits [B, A, 2]
        and rpn_deltas [B, A, 4] in anchor order; `propose()` -> (rois
        [B, R, 4], roi_valid [B, R]), the proposals at the training sizes;
        `roi_outputs(rois [B, S, 4], keep)` -> (roi_scores [B * S, C],
        roi_deltas [B * S, 4C]) for every sampled slot (as in JAX, none is
        masked), with `keep` the draws' dropout masks (None without dropout).
        Proposals and targets carry no gradient. Metrics (0-dim tensors,
        read nothing back): rpn_cls_loss, rpn_reg_loss, roi_cls_loss,
        roi_reg_loss, total_loss, and the per-image means of num_proposals,
        num_rpn_fg, num_rpn_bg, num_roi_fg.
        """
        cfg = self.cfg
        b = image_hw.shape[0]
        s = cfg["roi_total_sample_number"]
        if not isinstance(draws, TrainDraws):
            draws = TrainDraws.sample(
                self.generator if draws is None else draws, b, anchors.shape[0],
                cfg["rpn_proposal_train_after_nms_sample_number"], s, self.roi_dropout,
            )
        with torch.no_grad():
            rois, roi_valid = propose()
            at = anchor_target(
                anchors, gt_boxes, gt_mask, image_hw[:, 0], image_hw[:, 1],
                draws.anchor_fg, draws.anchor_bg,
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
        rpn_cls = cls_loss(rpn_logits, at.labels, at.labels >= 0).mean()
        rpn_reg = smooth_l1_loss(rpn_deltas, at.bbox_targets, at.in_weights, at.out_weights,
                                 sigma=cfg["rpn_sigma"], dim=(1, 2))
        roi_scores, roi_deltas = roi_outputs(pt.rois, draws.dropout_keep)
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

    @torch.inference_mode()
    def predict(self, image, image_hw) -> Detections:
        """Single padded image [Hp, Wp, 3] -> padded Detections."""
        cfg = self.cfg
        images, hw = self._as_inputs(image, image_hw)
        rois, roi_valid, roi_softmax, roi_deltas = self._detect(images[None], hw[None])
        return post_ops_prediction(
            roi_softmax[0],
            roi_deltas[0],
            rois[0],
            roi_valid[0],
            hw[0],
            hw[1],
            target_means=tuple(cfg["roi_proposal_means"]),
            target_stds=tuple(cfg["roi_proposal_stds"]),
            max_num_per_class=cfg["max_objects_per_class_per_image"],
            max_num_per_image=cfg["max_objects_per_image"],
            nms_iou_threshold=cfg["prediction_nms_iou_threshold"],
            score_threshold=cfg["prediction_score_threshold"],
            min_edge=self.min_edge,
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
        rois, roi_valid, roi_softmax, roi_deltas = self._detect(images, hw)
        return roi_softmax, roi_deltas, rois / scales[:, None, None], roi_valid

    def im_detect(self, image, image_hw, scale):
        """Raw-head eval API for one image: (roi_softmax [R, C], roi_deltas
        [R, C, 4], rois/scale [R, 4], roi_valid [R])."""
        out = self.im_detect_batch(
            torch.as_tensor(image)[None], torch.as_tensor(image_hw)[None],
            torch.as_tensor(scale, dtype=torch.float32)[None],
        )
        return tuple(t[0] for t in out)
