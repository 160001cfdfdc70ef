"""Faster R-CNN with the COCO config (12 anchors a cell, 81 classes, caps of
100), the port against the JAX detector on the CPU.

The weights are seeded numpy draws for each JAX detector's parameter tree
(`tests/torch_shared.py::numpy_params`), carried into the port by the weight
bridge; each comparison is one test (one JAX build and jit), so no xdist
worker waits for another's result. The config is
`config_factory("coco", "faster_rcnn")` cut as tests/test_torch_model.py
and tests/test_torch_faster_rcnn_train.py cut the Pascal one: a 128x128
bucket, anchor scales of four entries, (1, 2, 4, 8) (16-128 px anchors,
which fit the image; the stock (4, 8, 16, 32) keeps the count, 12 a cell,
but only its 64-px anchors would lie inside), small proposal and sample
counts, and the configured caps (100 a class and an image) and score
threshold (0.0).

- C4 ResNet-50: `predict` and `im_detect_batch`; one `loss_fn` step at
  B=1 with JAX's draws (rebuilt as tests/test_torch_faster_rcnn_train.py
  rebuilds them): losses, sample counts and every gradient;
- VGG16: `predict` on caffe-scaled pixels;
- the bridge both ways for both trees (RPN convs of 24 and 48 channels, a
  RoI head of 81 and 324 outputs): JAX leaves -> the port's state dict ->
  the same leaves, bit for bit.

Tolerances (those of tests/test_torch_model.py and
tests/test_torch_faster_rcnn_train.py): softmax and scores atol 1e-4,
deltas rtol/atol 1e-4, rois and boxes atol 1e-3 px, labels and validity
exact; losses rtol 1e-4, counts exact, every gradient within 2e-3 of its
tensor's largest absolute value. The premises are asserted: the RPN
probabilities separate at the pre-NMS cut (a tie may legitimately keep other
proposals), and no foreground score is denormal (XLA:CPU flushes denormals
and torch does not, so a score below 1e-38 is no detection in JAX and a
detection in the port: with these weights the smallest score is far above).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from tf_eager_object_detection_tpu.models.model_factory import model_factory as jax_factory
from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
from tf_eager_object_detection_tpu_torch.core.anchors import valid_anchor_mask
from tf_eager_object_detection_tpu_torch.models.heads import reshuffle_frcnn_scores
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.ref_import.from_jax import (
    flat_params_from_state_dict,
    load_jax_params,
    parameter_tree_from_jax,
)
from tf_eager_object_detection_tpu_torch.training.optimizer import make_optimizer
from tf_eager_object_detection_tpu_torch.training.train_step import make_train_step
from test_torch_faster_rcnn_train import jax_draws
from torch_shared import numpy_params

MAP_TOL = dict(rtol=1e-4, atol=1e-4)
BOX_TOL = dict(rtol=0, atol=1e-3)
SCORE_TOL = dict(rtol=0, atol=1e-4)
GRAD_TOL = 2e-3
SCALES = [1, 2, 4, 8]
PRE_NMS, POST_NMS, ROI_SAMPLES = 256, 64, 32
SEED, KEY = 3, 11
RPN_SCORE_SCALE = 5.0  # random-weight RPN probabilities separate at the pre-NMS cut (asserted)


def _config():
    cfg = dict(config_factory("coco", "faster_rcnn"))
    cfg.update(
        scales=SCALES,
        rpn_proposal_test_pre_nms_sample_number=PRE_NMS,
        rpn_proposal_test_after_nms_sample_number=50,
        rpn_proposal_train_pre_nms_sample_number=PRE_NMS,
        rpn_proposal_train_after_nms_sample_number=POST_NMS,
        rpn_total_sample_number=64,
        rpn_pos_sample_max_number=32,
        roi_total_sample_number=ROI_SAMPLES,
        roi_pos_sample_max_number=8,
        tpu_image_buckets=[[128, 128]],
        image_min_size=128,
        image_max_size=128,
        tpu_max_gt_boxes=8,
    )
    return cfg


def _images(pixel_scale=1.0):
    rng = np.random.RandomState(0)
    return ((rng.randn(2, 128, 128, 3) * pixel_scale).astype(np.float32),
            np.array([[120, 124], [128, 100]], np.int32))


def _flat(jdet):
    flat = numpy_params(jdet, seed=SEED)
    flat["rpn_head/rpn_score_conv/kernel"] *= RPN_SCORE_SCALE
    return flat


def _bridge_round_trip(det, flat):
    """(leaves equal after JAX -> port -> JAX, shapes of the COCO layers)."""
    back = flat_params_from_state_dict(det.state_dict())
    same = back.keys() == flat.keys() and all(np.array_equal(back[k], flat[k]) for k in flat)
    sd = det.state_dict()
    return same, {k: tuple(sd[k].shape) for k in sd
                  if k.startswith("rpn_head.rpn_") or k.startswith("roi_head.roi_head_")}


def _probs(det, images, hw):
    """The port's RPN foreground probabilities of the valid anchors (-1 elsewhere)."""
    with torch.no_grad():
        probs = reshuffle_frcnn_scores(det._backbone_rpn(torch.from_numpy(images))[1],
                                       det.num_anchors)
    cells = torch.from_numpy(-(-hw.astype(np.int64) // 16))
    valid = valid_anchor_mask(8, 8, det.num_anchors, cells[:, 0], cells[:, 1])
    return torch.where(valid, probs, torch.full_like(probs, -1.0)).numpy()


def _serving_both(backbone):
    cfg = _config()
    jdet = jax_factory("faster_rcnn", backbone, cfg)
    flat = _flat(jdet)
    images, hw = _images(50.0 if backbone == "vgg16" else 1.0)
    scales = np.array([1.0, 1.25], np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, unflatten_dict(flat, sep="/"))
    want_predict = [np.asarray(t) for t in
                    jdet.predict(params, jnp.asarray(images[0]), jnp.asarray(hw[0]))]
    want_batch = ([np.asarray(t) for t in jdet.im_detect_batch(
        params, jnp.asarray(images), jnp.asarray(hw), jnp.asarray(scales))]
        if backbone == "resnet50" else None)
    del params
    det = model_factory("faster_rcnn", backbone, cfg, device="cpu")
    load_jax_params(det, flat)
    got_predict = [t.numpy() for t in det.predict(images[0], hw[0])]
    got_batch = ([t.numpy() for t in det.im_detect_batch(images, hw, scales)]
                 if backbone == "resnet50" else None)
    same, shapes = _bridge_round_trip(det, flat)
    return dict(want_predict=want_predict, got_predict=got_predict, want_batch=want_batch,
                got_batch=got_batch, probs=_probs(det, images, hw), same=same, shapes=shapes,
                num_anchors=det.num_anchors)


def _batch():
    images, hw = _images()
    gt = np.zeros((1, 8, 4), np.float32)
    gt[0, :4] = [[10, 12, 60, 70], [40, 30, 118, 100], [5, 50, 50, 110], [70, 8, 110, 40]]
    mask = np.arange(8)[None] < 4
    labels = np.asarray([[3, 80, 12, 41, 0, 0, 0, 0]], np.int32)  # label 80: the last column
    return images[:1], hw[:1], gt, mask, labels


def _train_both():
    """JAX `loss_fn` and its gradients against the port's step with JAX's
    draws -> (metrics of both, {tensor: (max |got - want|, max |want|)})."""
    cfg = _config()
    jdet = jax_factory("faster_rcnn", "resnet50", cfg)
    flat = _flat(jdet)
    batch = _batch()
    params = jax.tree_util.tree_map(jnp.asarray, unflatten_dict(flat, sep="/"))

    def loss(p):
        return jdet.loss_fn(p, *map(jnp.asarray, batch), jax.random.PRNGKey(KEY))

    (_, jm), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    want_metrics = {k: float(v) for k, v in jm.items()}
    want = parameter_tree_from_jax({k: np.asarray(v) for k, v in
                                    flatten_dict(jg, sep="/").items()})
    del params, jg
    det = model_factory("faster_rcnn", "resnet50", cfg, device="cpu")
    load_jax_params(det, flat)
    draws = jax_draws(jax.random.PRNGKey(KEY), 1, 64 * det.num_anchors, POST_NMS, ROI_SAMPLES)
    metrics = make_train_step(det, make_optimizer(cfg, det))(batch, draws)
    got = {n: p.grad for n, p in det.named_parameters() if p.grad is not None}
    frozen = {n for n, p in det.named_parameters() if not p.requires_grad}
    errs = {n: (float((got[n] - w).abs().max()), float(w.abs().max()))
            for n, w in want.items() if n in got}
    return dict(want=want_metrics, got={k: float(v) for k, v in metrics.items()}, errs=errs,
                keys_ok=set(got) == set(want) - frozen,
                probs=_probs(det, batch[0], batch[1]))


def _assert_separate(probs):
    for p in probs:
        p = np.sort(p)[::-1]
        assert p[PRE_NMS - 1] - p[PRE_NMS] > 1e-4


@pytest.mark.parametrize("backbone", ["resnet50", "vgg16"])
def test_serving_and_bridge_match_jax(backbone):
    """`predict` (and for C4 `im_detect_batch`) against JAX, and the bridge
    both ways, on one set of weights."""
    out = _serving_both(backbone)
    assert out["num_anchors"] == 12
    _assert_separate(out["probs"])
    boxes, labels, scores, valid = out["got_predict"]
    jb, jl, js, jv = out["want_predict"]
    assert boxes.shape == (100, 4)
    np.testing.assert_array_equal(valid, jv)
    np.testing.assert_array_equal(labels, jl)
    np.testing.assert_allclose(scores, js, **SCORE_TOL)
    np.testing.assert_allclose(boxes, jb, **BOX_TOL)
    assert 0 < valid.sum() and labels[valid].max() <= 80
    assert scores[valid].min() > 1e-30  # no denormal score (see the module docstring)

    if backbone == "resnet50":
        sm, deltas, rois, roi_valid = out["got_batch"]
        jsm, jdeltas, jrois, jvalid = out["want_batch"]
        assert sm.shape == (2, 50, 81) and deltas.shape == (2, 50, 81, 4)
        np.testing.assert_array_equal(roi_valid, jvalid)
        np.testing.assert_allclose(sm, jsm, **SCORE_TOL)
        np.testing.assert_allclose(deltas, jdeltas, **MAP_TOL)
        np.testing.assert_allclose(rois, jrois, **BOX_TOL)
        assert sm[roi_valid][:, 1:].min() > 1e-30

    assert out["same"]
    shapes = out["shapes"]
    assert shapes["rpn_head.rpn_score_conv.weight"][0] == 24
    assert shapes["rpn_head.rpn_bbox_conv.weight"][0] == 48
    assert shapes["roi_head.roi_head_score.weight"][0] == 81
    assert shapes["roi_head.roi_head_bboxes.weight"][0] == 324


def test_training_step_matches_jax():
    """Losses rtol 1e-4, counts exact, every gradient within GRAD_TOL of its
    tensor's largest value (observed worst case 1.0e-3,
    `roi_head.conv5_block1_1_conv.weight`)."""
    train = _train_both()
    want, got = train["want"], train["got"]
    assert set(got) == set(want)
    for k, v in want.items():
        if k.startswith("num_"):
            assert got[k] == v, k
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
    assert want["num_roi_fg"] > 0 and want["num_rpn_fg"] > 0
    _assert_separate(train["probs"])
    assert train["keys_ok"]
    worst = max((e / m, n) for n, (e, m) in train["errs"].items() if m > 0)
    assert worst[0] <= GRAD_TOL, worst
    # the RoI branch at 81 classes reaches the backbone
    assert train["errs"]["roi_head.roi_head_score.weight"][1] > 0
    assert train["errs"]["extractor.conv4_block6_3_conv.weight"][1] > 0
