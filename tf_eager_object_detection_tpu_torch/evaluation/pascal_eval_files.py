"""VOC detection files of an eval run
(port of `tf_eager_object_detection_tpu/evaluation/pascal_eval_files.py`).

Per eval image: the detector's raw head outputs (`batched_im_detect`, one
batch per bucket) -> per-class decode, clip to the raw image, drop boxes
with a side under `min_size`, and ONE NMS call over all foreground classes
at once (the NMS kernel K1 on the card; JAX vmaps its NMS over the classes)
-> a per-image score cap -> per-class `{cls}.txt` files in the VOC devkit's
format (1-based coordinates). `data_parallel` / `devices` and
`spatial_partition` go to `batched_im_detect`; under spatial partitioning
every rank of the process group computes every image's detections and
rank 0 alone writes the files.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tf_eager_object_detection_tpu_torch.core.boxes import clip_boxes, min_edge_mask
from tf_eager_object_detection_tpu_torch.core.transforms import decode_boxes
from tf_eager_object_detection_tpu_torch.data.label_map import PASCAL_CLASSES
from tf_eager_object_detection_tpu_torch.evaluation.batched_inference import batched_im_detect
from tf_eager_object_detection_tpu_torch.ops.nms import non_max_suppression

__all__ = ["eval_post_process", "get_prediction_files", "write_voc_detection_files"]


def eval_post_process(
    scores: torch.Tensor,
    deltas: torch.Tensor,
    rois: torch.Tensor,
    roi_valid: torch.Tensor,
    raw_h,
    raw_w,
    max_per_class: int,
    score_threshold: float = 0.0,
    nms_iou_threshold: float = 0.3,
    min_size: float = 10.0,
    target_means=(0.0, 0.0, 0.0, 0.0),
    target_stds=(0.1, 0.1, 0.2, 0.2),
    clip_deltas: bool = True,
):
    """One image's detections per foreground class.

    scores [R, C] softmax; deltas [R, C, 4]; rois [R, 4] on the raw image
    (divided by the scale); roi_valid [R]. Returns (boxes [C-1, K, 4],
    scores [C-1, K], valid [C-1, K]), K = max_per_class, score-descending
    in each class.
    """
    fg_scores = scores[:, 1:].transpose(0, 1)  # [C-1, R]
    fg_deltas = deltas[:, 1:, :].transpose(0, 1)  # [C-1, R, 4]
    boxes = decode_boxes(rois.unsqueeze(0), fg_deltas, target_means, target_stds,
                         clip_deltas=clip_deltas)
    boxes = clip_boxes(boxes, raw_h, raw_w)
    keep = roi_valid & (fg_scores > score_threshold) & min_edge_mask(boxes, min_size)
    idx, ok = non_max_suppression(boxes, fg_scores, keep, max_per_class, nms_iou_threshold)
    c, k = idx.shape
    return (torch.gather(boxes, 1, idx.unsqueeze(-1).expand(c, k, 4)),
            torch.gather(fg_scores, 1, idx), ok)


def _cap_per_image(per_class_dets: List[np.ndarray], max_per_image: int):
    """Keep the detections scoring at least the max_per_image-th score of
    the image (a threshold, not an exact top-k, as in the reference)."""
    if max_per_image <= 0:
        return per_class_dets
    all_scores = (np.concatenate([d[:, 4] for d in per_class_dets]) if per_class_dets
                  else np.zeros(0))
    if len(all_scores) <= max_per_image:
        return per_class_dets
    thresh = np.sort(all_scores)[-max_per_image]
    return [d[d[:, 4] >= thresh] for d in per_class_dets]


def get_prediction_files(
    detector,
    eval_iterator: Iterable,
    image_ids: Sequence[str],
    result_file_format: str,
    class_names: Sequence[str] = PASCAL_CLASSES,
    score_threshold: float = 0.0,
    nms_iou_threshold: float = 0.3,
    max_objects_per_class: int = 50,
    max_objects_per_image: int = 50,
    min_size: float = 10.0,
    batch_size: int = 8,
    data_parallel: int = 0,
    devices: Optional[Sequence] = None,
    spatial_partition: int = 0,
) -> List[str]:
    """Runs eval inference and writes per-class VOC result files; returns
    their paths. `eval_iterator` yields (image [Hp, Wp, 3], image_hw [2],
    scale, raw_h, raw_w) in the order of `image_ids`. `data_parallel` > 0
    splits each batch over that many replicas, `spatial_partition` > 1
    each image's rows over the ranks of the process group
    (`batched_im_detect`)."""
    cfg = detector.cfg
    per_image: List[List[np.ndarray] | None] = [None] * len(image_ids)
    for img_idx, item, (sm, deltas, rois, roi_valid) in batched_im_detect(
        detector, eval_iterator, batch_size, data_parallel, devices, spatial_partition
    ):
        boxes_c, scores_c, valid_c = (t.cpu().numpy() for t in eval_post_process(
            sm, deltas, rois, roi_valid, float(item[3]), float(item[4]),
            max_per_class=max_objects_per_class,
            score_threshold=score_threshold,
            nms_iou_threshold=nms_iou_threshold,
            min_size=min_size,
            target_means=tuple(cfg["roi_proposal_means"]),
            target_stds=tuple(cfg["roi_proposal_stds"]),
            clip_deltas=not cfg.get("strict_reference_parity", False),
        ))
        dets = [np.concatenate([boxes_c[j][valid_c[j]], scores_c[j][valid_c[j], None]], axis=1)
                for j in range(detector.num_classes - 1)]
        per_image[img_idx] = _cap_per_image(dets, max_objects_per_image)
    if spatial_partition > 1 and dist.get_rank() != 0:
        return [result_file_format.format(cls) for cls in class_names]
    return write_voc_detection_files(per_image, image_ids, class_names, result_file_format)


def write_voc_detection_files(
    per_image: List[List[np.ndarray]],
    image_ids: Sequence[str],
    class_names: Sequence[str],
    result_file_format: str,
) -> List[str]:
    """per_image[i][c] = [N, 5] (x1, y1, x2, y2, score) on the raw image ->
    one file per class, `result_file_format.format(class name)`, of lines
    `image_id score x1 y1 x2 y2` with 1-based coordinates."""
    paths = []
    for c, cls in enumerate(class_names):
        path = result_file_format.format(cls)
        paths.append(path)
        with open(path, "w") as f:
            for img_idx, image_id in enumerate(image_ids):
                if img_idx >= len(per_image) or per_image[img_idx] is None:
                    continue
                for d in per_image[img_idx][c]:
                    f.write("{:s} {:.3f} {:.1f} {:.1f} {:.1f} {:.1f}\n".format(
                        image_id, d[4], d[0] + 1, d[1] + 1, d[2] + 1, d[3] + 1))
    return paths
