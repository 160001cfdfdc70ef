"""The port's core and ops modules against their JAX counterparts.

Same numpy inputs through both; the tolerance of each comparison is stated
where it is not exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_eager_object_detection_tpu.core import anchors as jax_anchors
from tf_eager_object_detection_tpu.core import boxes as jax_boxes
from tf_eager_object_detection_tpu.core import transforms as jax_tf
from tf_eager_object_detection_tpu.ops import prediction as jax_pred
from tf_eager_object_detection_tpu.ops import region_proposal as jax_rp
from tf_eager_object_detection_tpu.ops import roi_align as jax_ra
from tf_eager_object_detection_tpu_torch.core import anchors as t_anchors
from tf_eager_object_detection_tpu_torch.core import boxes as t_boxes
from tf_eager_object_detection_tpu_torch.core import transforms as t_tf
from tf_eager_object_detection_tpu_torch.ops import prediction as t_pred
from tf_eager_object_detection_tpu_torch.ops import region_proposal as t_rp
from tf_eager_object_detection_tpu_torch.ops import roi_align as t_ra

T = torch.from_numpy


def _boxes(rng, n, size=200.0):
    x1 = rng.uniform(-20, size, n)
    y1 = rng.uniform(-20, size, n)
    return np.stack(
        [x1, y1, x1 + rng.uniform(1, 80, n), y1 + rng.uniform(1, 80, n)], -1
    ).astype(np.float32)


def test_clip_boxes_and_min_edge_mask_exact():
    rng = np.random.RandomState(0)
    b = _boxes(rng, 500)
    got = t_boxes.clip_boxes(T(b), 150, 120).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_boxes.clip_boxes(jnp.asarray(b), 150, 120)))
    np.testing.assert_array_equal(
        t_boxes.min_edge_mask(T(b), 16.0).numpy(),
        np.asarray(jax_boxes.min_edge_mask(jnp.asarray(b), 16.0)),
    )
    # per-image extents broadcast: [B, 1] against [B, N]
    bb = b.reshape(2, 250, 4)
    got = t_boxes.clip_boxes(T(bb), torch.tensor([[150], [90]]), torch.tensor([[120], [60]]))
    for i, (h, w) in enumerate([(150, 120), (90, 60)]):
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(jax_boxes.clip_boxes(jnp.asarray(bb[i]), h, w))
        )


@pytest.mark.parametrize("clip_deltas", [True, False])
def test_decode_encode_boxes(clip_deltas):
    rng = np.random.RandomState(1)
    anchors = _boxes(rng, 400)
    deltas = rng.randn(400, 4).astype(np.float32) * 2.0
    deltas[:5, 2:] = 9.0  # beyond the log(1000/16) clamp
    means, stds = (0.0, 0.1, 0.0, -0.1), (0.1, 0.1, 0.2, 0.2)
    got = t_tf.decode_boxes(T(anchors), T(deltas), means, stds, clip_deltas=clip_deltas)
    ref = jax_tf.decode_boxes(
        jnp.asarray(anchors), jnp.asarray(deltas), means, stds, clip_deltas=clip_deltas
    )
    # exp() of XLA:CPU and of torch differ in the last bit for ~9% of inputs,
    # and x1 = cx - w/2 cancels: a few ulps of the box's extent, absolute
    _EXP_TOL = dict(rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **_EXP_TOL)

    gt = _boxes(rng, 400) + 30.0
    got = t_tf.encode_boxes(T(anchors), T(gt), means, stds)
    ref = jax_tf.encode_boxes(jnp.asarray(anchors), jnp.asarray(gt), means, stds)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **_EXP_TOL)


@pytest.mark.parametrize("scales", [(8, 16, 32), (4, 8, 16, 32)])
def test_anchors_exact(scales):
    base = t_anchors.generate_anchor_base(16, (0.5, 1.0, 2.0), scales)
    ref = jax_anchors.generate_anchor_base(16, (0.5, 1.0, 2.0), scales)
    np.testing.assert_array_equal(base, ref)
    np.testing.assert_array_equal(
        t_anchors.shift_anchor_base(base, 16, 7, 11),
        jax_anchors.shift_anchor_base(ref, 16, 7, 11),
    )
    got = t_anchors.valid_anchor_mask(7, 11, len(base), torch.tensor([5, 7]), torch.tensor([11, 3]))
    for i, (vh, vw) in enumerate([(5, 11), (7, 3)]):
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(jax_anchors.valid_anchor_mask(7, 11, len(base), vh, vw))
        )


def test_region_proposal_matches_per_image_jax():
    """Batched over two images; scores are well separated (a permutation of a
    grid), so the ordering is unambiguous: valid must agree exactly, rois to
    atol 1e-4 px (decode's exp() differs in the last bit between XLA:CPU and
    torch, a few ulps of a coordinate below 256)."""
    rng = np.random.RandomState(2)
    gh, gw = 10, 12
    base = jax_anchors.generate_anchor_base(16, (0.5, 1.0, 2.0), (2, 4, 8))
    anchors = jax_anchors.shift_anchor_base(base, 16, gh, gw)
    a = anchors.shape[0]
    deltas = (rng.randn(2, a, 4) * 0.3).astype(np.float32)
    scores = np.stack([rng.permutation(a) for _ in range(2)]).astype(np.float32) / a
    hw = np.array([[150, 190], [100, 120]], np.int32)
    avalid = np.stack([
        np.asarray(jax_anchors.valid_anchor_mask(gh, gw, 9, -(-h // 16), -(-w // 16)))
        for h, w in hw
    ])
    rois, valid = t_rp.region_proposal(
        T(deltas), T(anchors), T(scores), T(avalid), T(hw[:, 0]), T(hw[:, 1]),
        num_post_nms=60, nms_iou_threshold=0.7, num_pre_nms=400,
    )
    for i in range(2):
        r_j, v_j = jax_rp.region_proposal(
            jnp.asarray(deltas[i]), jnp.asarray(anchors), jnp.asarray(scores[i]),
            jnp.asarray(avalid[i]), hw[i, 0], hw[i, 1],
            num_post_nms=60, nms_iou_threshold=0.7, num_pre_nms=400,
        )
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(v_j))
        np.testing.assert_allclose(rois[i].numpy(), np.asarray(r_j), atol=1e-4, rtol=0)
        assert valid[i].sum() > 10


@pytest.mark.parametrize("crop", [7, 14, 1])
def test_crop_and_resize(crop):
    rng = np.random.RandomState(3)
    feats = rng.randn(2, 9, 13, 5).astype(np.float32)
    y1, x1 = rng.uniform(-0.2, 0.9, (2, 2, 6))
    boxes = np.stack(
        [y1, x1, y1 + rng.uniform(0.05, 0.6, (2, 6)), x1 + rng.uniform(0.05, 0.6, (2, 6))], -1
    ).astype(np.float32)
    boxes[0, 0] = [0.0, 0.0, 1.0, 1.0]  # samples exactly on the map's edges
    got = t_ra.crop_and_resize(T(feats), T(boxes), crop).numpy()
    for i in range(2):
        ref = jax_ra.crop_and_resize(jnp.asarray(feats[i]), jnp.asarray(boxes[i]), crop)
        # atol 1e-5: the two matmuls sum in another order than XLA's einsums
        np.testing.assert_allclose(got[i], np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("max_pooling", [False, True])
def test_roi_crop_faster_rcnn(max_pooling):
    rng = np.random.RandomState(4)
    feats = rng.randn(2, 10, 15, 8).astype(np.float32)
    rois = _boxes(rng, 2 * 20, size=200.0).reshape(2, 20, 4).clip(0, 230)
    got = t_ra.roi_crop_faster_rcnn(T(feats), T(rois), 16, 7, max_pooling).numpy()
    for i in range(2):
        ref = jax_ra.roi_crop_faster_rcnn(
            jnp.asarray(feats[i]), jnp.asarray(rois[i]), 16, 7, max_pooling
        )
        np.testing.assert_allclose(got[i], np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw", [(14, 14), (7, 9), (5, 4)])
def test_max_pool_2x2_same_pads_bottom_right(hw):
    rng = np.random.RandomState(5)
    x = rng.randn(3, *hw, 4).astype(np.float32)
    np.testing.assert_array_equal(
        t_ra.max_pool_2x2_same(T(x)).numpy(), np.asarray(jax_ra.max_pool_2x2_same(jnp.asarray(x)))
    )


def test_post_ops_prediction():
    rng = np.random.RandomState(6)
    n, c = 120, 6
    rois = _boxes(rng, n, size=180.0).clip(0, 199)
    logits = rng.randn(n, c).astype(np.float32) * 3
    softmax = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    deltas = (rng.randn(n, c, 4) * 0.5).astype(np.float32)
    valid = rng.uniform(0, 1, n) < 0.9
    kw = dict(max_num_per_class=15, max_num_per_image=25, nms_iou_threshold=0.3,
              score_threshold=0.05, min_edge=16.0, num_classes=c)
    got = t_pred.post_ops_prediction(T(softmax), T(deltas), T(rois), T(valid), 200, 190, **kw)
    ref = jax_pred.post_ops_prediction(
        jnp.asarray(softmax), jnp.asarray(deltas), jnp.asarray(rois), jnp.asarray(valid),
        200, 190, **kw,
    )
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(ref.scores))
    # atol 1e-5: decode's exp() may differ in the last bit between frameworks
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes), atol=1e-5, rtol=0)
    assert got.valid.sum() > 5
