"""COCO bbox evaluation without pycocotools
(port of `tf_eager_object_detection_tpu/evaluation/coco_eval.py`).

A numpy implementation of pycocotools' COCOeval bbox pipeline: the 12
standard stats (AP @[.50:.95], AP @.50, AP @.75, AP small / medium /
large, AR at 1 / 10 / 100 detections, AR small / medium / large), with
crowd handling, area-range ignores of ground truth and detections,
per-maxDets truncation before matching and 101-point interpolated
precision. The loops follow the JAX module line for line, in float64, so
the stats are equal to its stats.

Detection results are the reference's JSON entries: [{image_id,
category_id, bbox [x, y, w, h], score}].
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, Sequence

import numpy as np

__all__ = [
    "CocoBboxEval",
    "coco_results_for_image",
    "evaluate_coco_detections",
]


def coco_results_for_image(
    boxes_c, scores_c, valid_c, img_id, label_to_cat_id, max_per_image
):
    """Results-JSON entries for one image from `eval_post_process` outputs.

    Reproduces the reference's per-image result building
    (scripts/eval_coco.py:117-164): per-class NMS survivors are
    class-concatenated, capped with an exact per-image top-k
    (tf.nn.top_k over the concatenated scores, :153-158 — unlike the VOC
    writer's threshold-style cap), and written as xywh with the +1 w/h
    pixel convention (:160-163). Ties at the cap keep the earlier
    class-major entry, matching top_k's stable index order.

    boxes_c: [C-1, K, 4]; scores_c/valid_c: [C-1, K]; label_to_cat_id maps
    contiguous labels (1-based) to COCO category ids — labels without a
    mapping (category-subset annotation files) are skipped.
    """
    results = []
    for j in range(len(boxes_c)):
        cat_id = label_to_cat_id.get(j + 1)
        if cat_id is None:
            continue
        for box, score in zip(boxes_c[j][valid_c[j]], scores_c[j][valid_c[j]]):
            x1, y1, x2, y2 = (float(v) for v in box)
            results.append(
                {
                    "image_id": int(img_id),
                    "category_id": int(cat_id),
                    "bbox": [x1, y1, x2 - x1 + 1, y2 - y1 + 1],
                    "score": float(score),
                }
            )
    if max_per_image > 0 and len(results) > max_per_image:
        order = sorted(
            range(len(results)), key=lambda i: (-results[i]["score"], i)
        )
        results = [results[i] for i in sorted(order[:max_per_image])]
    return results


IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _bbox_iou(dts: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """xywh IoU [D, G]; crowd gt uses intersection / det area."""
    if len(dts) == 0 or len(gts) == 0:
        return np.zeros((len(dts), len(gts)))
    dx1, dy1 = dts[:, 0:1], dts[:, 1:2]
    dx2, dy2 = dx1 + dts[:, 2:3], dy1 + dts[:, 3:4]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gx1 + gts[:, 2], gy1 + gts[:, 3]
    iw = np.maximum(0.0, np.minimum(dx2, gx2[None]) - np.maximum(dx1, gx1[None]))
    ih = np.maximum(0.0, np.minimum(dy2, gy2[None]) - np.maximum(dy1, gy1[None]))
    inter = iw * ih
    darea = (dts[:, 2] * dts[:, 3])[:, None]
    garea = (gts[:, 2] * gts[:, 3])[None, :]
    union = np.where(iscrowd[None, :], darea, darea + garea - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class CocoBboxEval:
    """evaluate() over gt JSON dict + results list -> .stats (12 floats)."""

    def __init__(self, gt: dict, results: Sequence[dict]):
        self.cat_ids = sorted(c["id"] for c in gt["categories"])
        self.img_ids = sorted(img["id"] for img in gt["images"])
        self._gts = defaultdict(list)
        for ann in gt["annotations"]:
            a = dict(ann)
            a.setdefault("iscrowd", 0)
            a.setdefault("area", a["bbox"][2] * a["bbox"][3])
            self._gts[(a["image_id"], a["category_id"])].append(a)
        self._dts = defaultdict(list)
        for det in results:
            self._dts[(det["image_id"], det["category_id"])].append(det)
        self.stats: np.ndarray | None = None

    def _eval_img(self, img_id, cat_id, area_rng, max_det):
        gts = self._gts[(img_id, cat_id)]
        dts = sorted(
            self._dts[(img_id, cat_id)], key=lambda d: -d["score"]
        )[:max_det]
        if not gts and not dts:
            return None
        gt_ignore = np.asarray(
            [
                bool(g["iscrowd"])
                or g["area"] < area_rng[0]
                or g["area"] > area_rng[1]
                for g in gts
            ],
            bool,
        )
        # ignored gts last (stable)
        order = np.argsort(gt_ignore, kind="stable")
        gts = [gts[i] for i in order]
        gt_ignore = gt_ignore[order]
        iscrowd = np.asarray([bool(g["iscrowd"]) for g in gts])
        gt_boxes = np.asarray([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
        dt_boxes = np.asarray([d["bbox"] for d in dts], np.float64).reshape(-1, 4)
        ious = _bbox_iou(dt_boxes, gt_boxes, iscrowd)

        t_count = len(IOU_THRS)
        d_count, g_count = len(dts), len(gts)
        dt_m = np.zeros((t_count, d_count), np.int64)  # matched gt index + 1
        gt_m = np.zeros((t_count, g_count), np.int64)
        dt_ig = np.zeros((t_count, d_count), bool)
        for ti, t in enumerate(IOU_THRS):
            for di in range(d_count):
                best_iou = min(t, 1 - 1e-10)
                best_g = -1
                for gi in range(g_count):
                    if gt_m[ti, gi] and not iscrowd[gi]:
                        continue
                    if best_g > -1 and not gt_ignore[best_g] and gt_ignore[gi]:
                        break  # remaining gts are all ignored; keep the match
                    if ious[di, gi] < best_iou:
                        continue
                    best_iou = ious[di, gi]
                    best_g = gi
                if best_g == -1:
                    continue
                dt_ig[ti, di] = gt_ignore[best_g]
                dt_m[ti, di] = best_g + 1
                gt_m[ti, best_g] = di + 1
        # unmatched dets outside the area range are ignored
        dt_areas = dt_boxes[:, 2] * dt_boxes[:, 3]
        out_of_rng = (dt_areas < area_rng[0]) | (dt_areas > area_rng[1])
        dt_ig = dt_ig | ((dt_m == 0) & out_of_rng[None, :])
        return {
            "scores": np.asarray([d["score"] for d in dts]),
            "dt_m": dt_m,
            "dt_ig": dt_ig,
            "gt_ig": gt_ignore,
        }

    def _accumulate(self, area_name: str, max_det: int):
        """-> (precision [T, R, K], recall [T, K]) over cats K."""
        t_count, r_count = len(IOU_THRS), len(REC_THRS)
        k_count = len(self.cat_ids)
        precision = -np.ones((t_count, r_count, k_count))
        recall = -np.ones((t_count, k_count))
        rng = AREA_RNG[area_name]
        for ki, cat_id in enumerate(self.cat_ids):
            evals = [
                e
                for img_id in self.img_ids
                if (e := self._eval_img(img_id, cat_id, rng, max_det)) is not None
            ]
            if not evals:
                continue
            scores = np.concatenate([e["scores"] for e in evals])
            order = np.argsort(-scores, kind="mergesort")
            dt_m = np.concatenate([e["dt_m"] for e in evals], axis=1)[:, order]
            dt_ig = np.concatenate([e["dt_ig"] for e in evals], axis=1)[:, order]
            npig = int(sum((~e["gt_ig"]).sum() for e in evals))
            if npig == 0:
                continue
            tps = (dt_m > 0) & ~dt_ig
            fps = (dt_m == 0) & ~dt_ig
            tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
            fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
            for ti in range(t_count):
                tp, fp = tp_sum[ti], fp_sum[ti]
                rc = tp / npig
                pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
                recall[ti, ki] = rc[-1] if len(rc) else 0.0
                # make precision monotone decreasing from the right
                pr = pr.tolist()
                for i in range(len(pr) - 1, 0, -1):
                    pr[i - 1] = max(pr[i - 1], pr[i])
                inds = np.searchsorted(rc, REC_THRS, side="left")
                q = np.zeros(r_count)
                for ri, pi in enumerate(inds):
                    if pi < len(pr):
                        q[ri] = pr[pi]
                precision[ti, :, ki] = q
        return precision, recall

    @staticmethod
    def _mean(x: np.ndarray) -> float:
        valid = x[x > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    def evaluate(self) -> np.ndarray:
        """Returns the 12 standard COCO stats."""
        p_all, r_all = self._accumulate("all", 100)
        p_small, r_small = self._accumulate("small", 100)
        p_medium, r_medium = self._accumulate("medium", 100)
        p_large, r_large = self._accumulate("large", 100)
        _, r1 = self._accumulate("all", 1)
        _, r10 = self._accumulate("all", 10)
        self.stats = np.asarray(
            [
                self._mean(p_all),
                self._mean(p_all[0]),  # IoU=.5
                self._mean(p_all[5]),  # IoU=.75
                self._mean(p_small),
                self._mean(p_medium),
                self._mean(p_large),
                self._mean(r1),
                self._mean(r10),
                self._mean(r_all),
                self._mean(r_small),
                self._mean(r_medium),
                self._mean(r_large),
            ]
        )
        return self.stats

    def per_category_ap(self, iou_index: int = 0) -> Dict[int, float]:
        """AP per category id at IOU_THRS[iou_index] (default 0.50),
        area=all, maxDets=100. -1.0 for categories with no gt."""
        precision, _ = self._accumulate("all", 100)
        return {
            cat_id: self._mean(precision[iou_index][:, ki])
            for ki, cat_id in enumerate(self.cat_ids)
        }

    def summarize(self) -> str:
        if self.stats is None:
            self.evaluate()
        names = [
            "AP @[.50:.95]", "AP @.50", "AP @.75", "AP small", "AP medium",
            "AP large", "AR maxDets=1", "AR maxDets=10", "AR maxDets=100",
            "AR small", "AR medium", "AR large",
        ]
        return "\n".join(
            f"{n:<16s} = {v:.3f}" for n, v in zip(names, self.stats)
        )


def evaluate_coco_detections(
    annotation_file: str, results: Sequence[dict] | str
) -> np.ndarray:
    """File-level API: gt JSON path + results (list or JSON path) -> stats."""
    with open(annotation_file) as f:
        gt = json.load(f)
    if isinstance(results, str):
        with open(results) as f:
            results = json.load(f)
    ev = CocoBboxEval(gt, results)
    stats = ev.evaluate()
    print(ev.summarize())
    return stats
