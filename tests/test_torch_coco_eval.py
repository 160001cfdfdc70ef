"""The port's COCO evaluation against the JAX package's, on the CPU.

- `CocoBboxEval`: the 12 stats of `evaluate`, `per_category_ap` at IoU
  .50 and .75 and the `summarize` text equal to JAX's (`==`: both are the
  same float64 numpy, so any difference is a porting fault) on seeded
  random scenarios (crowds, areas across the small / medium / large
  boundaries, score ties, more than 100 detections an image and
  category, empty images) and on every fixture of
  tests/test_coco_eval_adversarial.py (f1-f20, each run with the JAX
  evaluator replaced by one that also runs the port's and compares);
- `evaluate_coco_detections` from files;
- `coco_results_for_image` on `eval_post_process` outputs of both
  frameworks from the same numpy head outputs at the COCO shapes
  (softmax [300, 81], deltas [300, 81, 4], caps of 100 a class and an
  image, a label without a category id): image ids, categories and
  scores equal, boxes within 1e-3 px (XLA:CPU's `exp` differs from
  torch's in the last bit for some inputs, so decoded boxes differ by a
  few ulps), and the stats of the two results within 1e-6; the exact
  top-k's tie order on tied scores.
"""

import inspect
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_coco_eval_adversarial as adversarial
from tf_eager_object_detection_tpu.evaluation import coco_eval as jax_coco_eval
from tf_eager_object_detection_tpu.evaluation import pascal_eval_files as jax_files
from tf_eager_object_detection_tpu_torch.evaluation import coco_eval
from tf_eager_object_detection_tpu_torch.evaluation import pascal_eval_files as port_files

BOX_TOL = dict(rtol=0, atol=1e-3)
MEANS, STDS = (0.0, 0.0, 0.0, 0.0), (0.1, 0.1, 0.2, 0.2)


def _random_scenario(rng, n_imgs, n_cats, crowd_p=0.15, tie_scores=False, dets_per_image=10):
    """Random ground truth and results (the generator of
    tests/test_coco_eval_differential.py, with the detections an image as a
    parameter): crowds, areas across the S/M/L boundaries (and area fields
    that differ from w * h, as segmentation areas do), empty images, images
    with detections and no ground truth and the reverse, duplicates, ties."""
    images = [{"id": i + 1, "height": 480, "width": 640} for i in range(n_imgs)]
    cats = [{"id": 10 * (c + 1), "name": f"c{c}"} for c in range(n_cats)]
    annotations, results = [], []
    for img in images:
        if rng.rand() < 0.15:
            continue  # empty image
        for _ in range(rng.randint(0, 6)):
            w = float(rng.choice([8, 20, 31, 33, 60, 95, 97, 200]))
            h = float(rng.choice([8, 20, 31, 33, 60, 95, 97, 200]))
            x = float(rng.uniform(0, 640 - w))
            y = float(rng.uniform(0, 480 - h))
            area = w * h
            if rng.rand() < 0.3:
                area *= rng.uniform(0.5, 1.0)
            annotations.append({
                "id": len(annotations) + 1,
                "image_id": img["id"],
                "category_id": int(rng.choice([c["id"] for c in cats])),
                "bbox": [x, y, w, h],
                "area": float(area),
                "iscrowd": int(rng.rand() < crowd_p),
            })
    for img in images:
        for _ in range(rng.randint(0, dets_per_image)):
            if annotations and rng.rand() < 0.6:
                a = annotations[rng.randint(0, len(annotations))]
                x, y, w, h = a["bbox"]
                cat = (a["category_id"] if rng.rand() < 0.8
                       else int(rng.choice([c["id"] for c in cats])))
                jitter = rng.uniform(-10, 10, 4)
                bbox = [x + jitter[0], y + jitter[1], max(2.0, w + jitter[2]),
                        max(2.0, h + jitter[3])]
            else:
                w, h = float(rng.uniform(5, 200)), float(rng.uniform(5, 200))
                cat = int(rng.choice([c["id"] for c in cats]))
                bbox = [float(rng.uniform(0, 640 - w)), float(rng.uniform(0, 480 - h)), w, h]
            results.append({"image_id": img["id"], "category_id": cat,
                            "bbox": [float(v) for v in bbox],
                            "score": float(rng.uniform(0.05, 1.0))})
    if tie_scores:
        for r in results:
            r["score"] = round(r["score"], 1)
    return {"images": images, "annotations": annotations, "categories": cats}, results


def _assert_same_evaluation(gt, results):
    """Both evaluators on the same inputs: stats, per-category APs and the
    summary text equal. Returns the stats."""
    port, ref = coco_eval.CocoBboxEval(gt, results), jax_coco_eval.CocoBboxEval(gt, results)
    got, want = port.evaluate(), ref.evaluate()
    assert got.dtype == want.dtype and got.shape == (12,)
    np.testing.assert_array_equal(got, want)
    for iou_index in (0, 5):
        assert port.per_category_ap(iou_index) == ref.per_category_ap(iou_index)
    assert port.summarize() == ref.summarize()
    return got


# (seed, images, categories, crowd share, ties, detections an image below)
SCENARIOS = [(s, 2 + s % 5, 1 + s % 4, [0.0, 0.15, 0.5][s % 3], s % 2 == 0, 10)
             for s in range(12)]
SCENARIOS += [(100 + s, 3, 2, 0.15, s % 2 == 0, 600) for s in range(4)]  # > 100 an image


@pytest.mark.parametrize("seed,n_imgs,n_cats,crowd_p,ties,per_image", SCENARIOS)
def test_random_scenarios_equal_jax(seed, n_imgs, n_cats, crowd_p, ties, per_image):
    gt, results = _random_scenario(np.random.RandomState(seed), n_imgs, n_cats, crowd_p, ties,
                                   per_image)
    stats = _assert_same_evaluation(gt, results)
    if per_image > 100:  # the scenario reaches the maxDets truncation
        counts = {}
        for r in results:
            key = (r["image_id"], r["category_id"])
            counts[key] = counts.get(key, 0) + 1
        assert max(counts.values()) > 100
    assert np.isfinite(stats).all()


class _BothEvaluators(jax_coco_eval.CocoBboxEval):
    """The JAX evaluator that also runs the port's on the same inputs and
    holds each result equal to its own."""

    calls = 0

    def __init__(self, gt, results):
        super().__init__(gt, results)
        self.port = coco_eval.CocoBboxEval(gt, results)

    def evaluate(self):
        want = super().evaluate()
        np.testing.assert_array_equal(self.port.evaluate(), want)
        type(self).calls += 1
        return want

    def per_category_ap(self, iou_index=0):
        want = super().per_category_ap(iou_index)
        assert self.port.per_category_ap(iou_index) == want
        return want

    def summarize(self):
        want = super().summarize()
        assert self.port.summarize() == want
        return want


ADVERSARIAL = sorted(name for name, fn in inspect.getmembers(adversarial, inspect.isfunction)
                     if name.startswith("test_f"))


@pytest.mark.parametrize("fixture", ADVERSARIAL)
def test_adversarial_fixtures_equal_jax(fixture, monkeypatch):
    monkeypatch.setattr(_BothEvaluators, "calls", 0)
    monkeypatch.setattr(adversarial, "CocoBboxEval", _BothEvaluators)
    getattr(adversarial, fixture)()  # the fixture's own assertions, on JAX's stats
    assert _BothEvaluators.calls >= 1


def test_adversarial_fixtures_are_all_there():
    assert len(ADVERSARIAL) == 20  # f1-f20 with f4b; the file has no f14
    assert all(inspect.signature(getattr(adversarial, n)).parameters == {} for n in ADVERSARIAL)


def test_evaluate_coco_detections_from_files(tmp_path, capsys):
    gt, results = _random_scenario(np.random.RandomState(7), 5, 3, 0.15)
    (tmp_path / "gt.json").write_text(json.dumps(gt))
    (tmp_path / "res.json").write_text(json.dumps(results))
    got = coco_eval.evaluate_coco_detections(str(tmp_path / "gt.json"), str(tmp_path / "res.json"))
    port_out = capsys.readouterr().out
    want = jax_coco_eval.evaluate_coco_detections(str(tmp_path / "gt.json"), results)
    np.testing.assert_array_equal(got, want)
    assert port_out == capsys.readouterr().out
    assert port_out.count(" = ") == 12


def test_ground_truth_as_detections_scores_one():
    """The non-crowd ground truth as detections of score 1: AP @[.50:.95]
    exactly 1 (the check of chip_smoke.py's COCO eval phase)."""
    gt, _ = _random_scenario(np.random.RandomState(3), 6, 3, 0.2)
    dets = [{"image_id": a["image_id"], "category_id": a["category_id"], "bbox": a["bbox"],
             "score": 1.0} for a in gt["annotations"] if not a["iscrowd"]]
    stats = _assert_same_evaluation(gt, dets)
    assert stats[0] == 1.0 and stats[1] == 1.0


# ------------------------------------------------ results of one image
def _raw_outputs(seed, r=300, c=81):
    """Score-separated raw head outputs of one image at the COCO shapes:
    softmax [R, C] of distinct logits, deltas [R, C, 4], rois [R, 4] on a
    480x640 image, roi_valid [R] with a few invalid slots."""
    rng = np.random.RandomState(seed)
    logits = rng.permutation(r * c).reshape(r, c).astype(np.float32) * 1e-3
    sm = np.exp(logits - logits.max(1, keepdims=True))
    sm = (sm / sm.sum(1, keepdims=True)).astype(np.float32)
    deltas = rng.normal(0, 1, (r, c, 4)).astype(np.float32)
    xy = rng.uniform(0, 480, (r, 2))
    rois = np.concatenate([xy, xy + rng.uniform(10, 200, (r, 2))], 1).astype(np.float32)
    valid = rng.uniform(size=r) > 0.05
    return sm, deltas, rois, valid


KW = dict(score_threshold=0.0, nms_iou_threshold=0.3, min_size=10.0, target_means=MEANS,
          target_stds=STDS)


def _post_processed(seed):
    """(port, jax) `eval_post_process` outputs as numpy, caps of 100 a class."""
    sm, deltas, rois, valid = _raw_outputs(seed)
    got = port_files.eval_post_process(*map(torch.from_numpy, (sm, deltas, rois, valid)),
                                       480.0, 640.0, max_per_class=100, **KW)
    want = jax_files.eval_post_process(*map(jnp.asarray, (sm, deltas, rois, valid)), 480.0,
                                       640.0, num_classes=81, max_per_class=100, **KW)
    return [t.numpy() for t in got], [np.asarray(t) for t in want]


def _assert_results_close(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["image_id"], g["category_id"], g["score"]) == \
            (w["image_id"], w["category_id"], w["score"])
        np.testing.assert_allclose(g["bbox"], w["bbox"], **BOX_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_results_of_eval_post_process_match_jax(seed):
    (gb, gs, gv), (wb, ws, wv) = _post_processed(seed)
    assert gb.shape == (80, 100, 4)
    np.testing.assert_array_equal(gv, wv)
    assert gv.sum() > 100  # the per-image cap of 100 is reached
    np.testing.assert_array_equal(gs, ws)
    # COCO category ids with its gaps; label 80 has none (a category subset)
    from tf_eager_object_detection_tpu_torch.scripts.coco_rehearsal import COCO_CAT_IDS

    label_to_cat = {i + 1: c for i, c in enumerate(COCO_CAT_IDS[:79])}
    for cap in (100, 0):
        got = coco_eval.coco_results_for_image(gb, gs, gv, 7 + seed, label_to_cat, cap)
        want = jax_coco_eval.coco_results_for_image(wb, ws, wv, 7 + seed, label_to_cat, cap)
        _assert_results_close(got, want)
        assert all(r["category_id"] != COCO_CAT_IDS[79] for r in got)
        assert len(got) == (100 if cap else int(gv[:79].sum()))


def test_results_stats_match_jax():
    """Stats of the port's and JAX's results JSONs of the same detections
    (boxes a few ulps apart) against one ground truth: within 1e-6."""
    from tf_eager_object_detection_tpu_torch.scripts.coco_rehearsal import COCO_CAT_IDS

    label_to_cat = {i + 1: c for i, c in enumerate(COCO_CAT_IDS)}
    got, want, annotations = [], [], []
    rng = np.random.RandomState(5)
    for img_id in range(1, 4):
        (gb, gs, gv), (wb, ws, wv) = _post_processed(10 + img_id)
        got += coco_eval.coco_results_for_image(gb, gs, gv, img_id, label_to_cat, 100)
        mine = jax_coco_eval.coco_results_for_image(wb, ws, wv, img_id, label_to_cat, 100)
        want += mine
        for k in rng.choice(len(mine), 30, replace=False):  # ground truth near some detections
            annotations.append({"id": len(annotations) + 1, "image_id": img_id,
                                "category_id": mine[k]["category_id"],
                                "bbox": [float(v) for v in
                                         np.asarray(mine[k]["bbox"]) + rng.uniform(-4, 4, 4)],
                                "iscrowd": int(rng.rand() < 0.1)})
    gt = {"images": [{"id": i} for i in range(1, 4)], "annotations": annotations,
          "categories": [{"id": c} for c in COCO_CAT_IDS]}
    _assert_results_close(got, want)
    s_got = coco_eval.CocoBboxEval(gt, got).evaluate()
    s_want = jax_coco_eval.CocoBboxEval(gt, want).evaluate()
    np.testing.assert_allclose(s_got, s_want, rtol=0, atol=1e-6)
    assert s_want[1] > 0


def test_results_cap_keeps_class_major_ties():
    """The exact top-k of the per-image cap on tied scores keeps the earlier
    class-major entries (a threshold cap would keep all of them)."""
    boxes = np.tile(np.asarray([10.0, 20.0, 50.0, 80.0], np.float32), (4, 5, 1))
    scores = np.asarray([[0.9, 0.5, 0.5, 0.2, 0.1],
                         [0.5, 0.5, 0.3, 0.0, 0.0],
                         [0.8, 0.5, 0.0, 0.0, 0.0],
                         [0.5, 0.4, 0.0, 0.0, 0.0]], np.float32)
    valid = scores > 0
    label_to_cat = {1: 1, 2: 5, 3: 90, 4: 17}
    for cap in (3, 5, 6, 7, 100):
        got = coco_eval.coco_results_for_image(boxes, scores, valid, 3, label_to_cat, cap)
        want = jax_coco_eval.coco_results_for_image(boxes, scores, valid, 3, label_to_cat, cap)
        assert got == want and len(got) == min(cap, int(valid.sum()))
    kept = coco_eval.coco_results_for_image(boxes, scores, valid, 3, label_to_cat, 5)
    # 0.9, 0.8, then the first three of the six 0.5s in class-major order
    assert [(r["category_id"], round(r["score"], 2)) for r in kept] == \
        [(1, 0.9), (1, 0.5), (1, 0.5), (5, 0.5), (90, 0.8)]
    assert kept[0]["bbox"] == [10.0, 20.0, 41.0, 61.0]  # +1 width and height
