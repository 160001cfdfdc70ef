"""Pascal VOC mAP (port of `tf_eager_object_detection_tpu/evaluation/voc_eval.py`; numpy only).

Both of the reference's evaluators, with the JAX module's semantics:

- `voc_eval`, file based (per-class detection files, ground-truth XMLs, a
  pickled annotation cache): detections in global score order, each to its
  highest-IoU ground truth, IoU with the +1 pixel convention, a match needs
  IoU > threshold; difficult ground truths are neither TP nor FP;
  duplicates are FP.
- `eval_detection_voc`, in memory: the box maxima shifted by +1 before an
  IoU that adds +1 again, a match at IoU >= threshold, and detections on
  difficult ground truths as curve positions with neither TP nor FP (their
  0/0 precisions become 0).

AP is 11-point interpolated (`use_07_metric`) or the area under the
monotone precision-recall curve.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Sequence

import numpy as np

from tf_eager_object_detection_tpu_torch.data.voc import parse_voc_xml

__all__ = ["voc_ap", "voc_eval_class", "voc_eval", "eval_detection_voc"]


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _iou_one_to_many(box: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """IoU of one box against [G, 4] boxes, +1 pixel convention."""
    ixmin = np.maximum(gts[:, 0], box[0])
    iymin = np.maximum(gts[:, 1], box[1])
    ixmax = np.minimum(gts[:, 2], box[2])
    iymax = np.minimum(gts[:, 3], box[3])
    iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
    ih = np.maximum(iymax - iymin + 1.0, 0.0)
    inter = iw * ih
    union = (
        (box[2] - box[0] + 1.0) * (box[3] - box[1] + 1.0)
        + (gts[:, 2] - gts[:, 0] + 1.0) * (gts[:, 3] - gts[:, 1] + 1.0)
        - inter
    )
    return inter / np.maximum(union, 1e-12)


def voc_eval_class(
    det_image_ids: Sequence,
    det_scores: np.ndarray,
    det_boxes: np.ndarray,
    gt_by_image: Dict,
    iou_thresh: float = 0.5,
    use_07_metric: bool = False,
):
    """The greedy matcher of one class -> (recall, precision, ap).

    gt_by_image: image id -> {'bbox': [G, 4], 'difficult': [G] bool}.
    """
    npos = sum(int((~np.asarray(g["difficult"], bool)).sum()) for g in gt_by_image.values())
    matched = {k: np.zeros(len(g["bbox"]), bool) for k, g in gt_by_image.items()}
    order = np.argsort(-np.asarray(det_scores))
    tp = np.zeros(len(order))
    fp = np.zeros(len(order))
    for rank, d in enumerate(order):
        img = det_image_ids[d]
        g = gt_by_image.get(img)
        if g is None or len(g["bbox"]) == 0:
            fp[rank] = 1.0
            continue
        overlaps = _iou_one_to_many(np.asarray(det_boxes[d], np.float64),
                                    np.asarray(g["bbox"], np.float64))
        jmax = int(np.argmax(overlaps))
        if not overlaps[jmax] > iou_thresh:
            fp[rank] = 1.0
        elif not g["difficult"][jmax]:  # a difficult ground truth ignores the detection
            if matched[img][jmax]:
                fp[rank] = 1.0
            else:
                matched[img][jmax] = True
                tp[rank] = 1.0
    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / np.maximum(float(npos), np.finfo(np.float64).eps)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def voc_eval(
    detpath: str,
    annopath: str,
    imagesetfile: str,
    classname: str,
    cachedir: str,
    ovthresh: float = 0.5,
    use_07_metric: bool = False,
):
    """File-based AP of one class -> (recall, precision, ap). `detpath` and
    `annopath` are format strings (class name, image id); the ground truth
    is cached as a pickle under `cachedir`."""
    os.makedirs(cachedir, exist_ok=True)
    imageset = os.path.splitext(os.path.basename(imagesetfile))[0]
    cachefile = os.path.join(cachedir, f"{imageset}_annots.pkl")
    with open(imagesetfile) as f:
        imagenames = [line.strip() for line in f if line.strip()]
    if os.path.isfile(cachefile):
        with open(cachefile, "rb") as f:
            recs = pickle.load(f)
    else:
        recs = {name: parse_voc_xml(annopath.format(name))["objects"] for name in imagenames}
        with open(cachefile, "wb") as f:
            pickle.dump(recs, f)

    gt_by_image = {}
    for name in imagenames:
        objs = [o for o in recs[name] if o["name"] == classname]
        gt_by_image[name] = {
            "bbox": np.asarray([o["bbox"] for o in objs]).reshape(-1, 4),
            "difficult": np.asarray([bool(o["difficult"]) for o in objs], bool),
        }
    with open(detpath.format(classname)) as f:
        lines = [line.strip().split(" ") for line in f if line.strip()]
    if not lines:
        return np.zeros(0), np.zeros(0), 0.0
    image_ids = [x[0] for x in lines]
    scores = np.asarray([float(x[1]) for x in lines])
    boxes = np.asarray([[float(v) for v in x[2:6]] for x in lines])
    return voc_eval_class(image_ids, scores, boxes, gt_by_image, ovthresh, use_07_metric)


def eval_detection_voc(
    pred_bboxes: List[np.ndarray],
    pred_labels: List[np.ndarray],
    pred_scores: List[np.ndarray],
    gt_bboxes: List[np.ndarray],
    gt_labels: List[np.ndarray],
    gt_difficults: List[np.ndarray] | None = None,
    iou_thresh: float = 0.5,
    use_07_metric: bool = False,
):
    """In-memory AP per class over per-image xyxy arrays -> {'ap': [C],
    'map': float, 'classes': the sorted union of ground-truth and predicted
    labels}."""
    n = len(pred_bboxes)
    if gt_difficults is None:
        gt_difficults = [np.zeros(len(np.asarray(b)), bool) for b in gt_bboxes]
    classes = set()
    for lbl in list(pred_labels) + list(gt_labels):
        classes.update(np.unique(np.asarray(lbl)).tolist())
    classes = sorted(int(c) for c in classes)

    aps = []
    for cls in classes:
        n_pos = 0
        scores: list = []
        match: list = []
        for i in range(n):
            pm = np.asarray(pred_labels[i]) == cls
            boxes_i = np.asarray(pred_bboxes[i], np.float64)[pm]
            scores_i = np.asarray(pred_scores[i], np.float64)[pm]
            order = scores_i.argsort()[::-1]
            boxes_i, scores_i = boxes_i[order], scores_i[order]
            gm = np.asarray(gt_labels[i]) == cls
            gts_i = np.asarray(gt_bboxes[i], np.float64).reshape(-1, 4)[gm]
            diff_i = np.asarray(gt_difficults[i], bool)[gm]
            n_pos += int((~diff_i).sum())
            scores.extend(scores_i.tolist())
            if len(boxes_i) == 0:
                continue
            if len(gts_i) == 0:
                match.extend([0] * len(boxes_i))
                continue
            boxes_i = boxes_i.copy()
            boxes_i[:, 2:] += 1
            gts_i = gts_i.copy()
            gts_i[:, 2:] += 1
            selec = np.zeros(len(gts_i), bool)
            for bb in boxes_i:
                overlaps = _iou_one_to_many(bb, gts_i)
                jmax = int(np.argmax(overlaps))
                if overlaps[jmax] < iou_thresh:
                    match.append(0)
                    continue
                if diff_i[jmax]:
                    match.append(-1)
                elif not selec[jmax]:
                    match.append(1)
                else:
                    match.append(0)
                selec[jmax] = True
        # no detection where ground truth exists gives an empty curve and AP
        # 0; only a class with no positive gives nan
        order = np.asarray(scores).argsort()[::-1]
        match_arr = np.asarray(match, np.int8)[order]
        tp = np.cumsum(match_arr == 1)
        fp = np.cumsum(match_arr == 0)
        with np.errstate(invalid="ignore"):
            prec = tp / (fp + tp)
        if n_pos == 0:
            aps.append(np.nan)
            continue
        rec = tp / n_pos
        aps.append(voc_ap(rec, np.nan_to_num(prec), use_07_metric))
    aps = np.asarray(aps)
    return {"ap": aps, "map": float(np.nanmean(aps)), "classes": classes}
