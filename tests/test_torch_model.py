"""The port's ResNet-50 Faster R-CNN against the JAX detector, same weights.

JAX weights come from `init_params` and reach the port through the weight
bridge. Tolerances, with their reasons:

- feature and head maps, rtol/atol 1e-4: convolutions sum in another order
  (oneDNN vs XLA:CPU); observed ~1e-5 on features of magnitude ~10;
- RoI and detection boxes, atol 1e-3 px: an RPN box delta that differs by
  ~1e-6 (summation order) is multiplied by the anchor extent, up to 512 px;
  observed 1.4e-4 px;
- scores and softmax, atol 1e-4: observed ~3e-6;
- labels and validity: exact. With random weights the RPN scores tie near
  0.5, and a tie may legitimately pick other proposals, so the score layers
  are scaled until the scores separate; the test asserts that they do at the
  pre-NMS cut.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from tf_eager_object_detection_tpu.models.heads import reshuffle_frcnn_scores as jax_reshuffle
from tf_eager_object_detection_tpu.models.model_factory import model_factory as jax_factory
from tf_eager_object_detection_tpu_torch.models.layers import SameConv2d
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.ref_import.from_jax import load_jax_params

from test_faster_rcnn import _small_config

MAP_TOL = dict(rtol=1e-4, atol=1e-4)
BOX_TOL = dict(rtol=0, atol=1e-3)
SCORE_TOL = dict(rtol=0, atol=1e-4)
RPN_SCORE_SCALE = 5.0
ROI_SCORE_SCALE = 10.0


@pytest.fixture(scope="module")
def pair():
    """(jax detector, jax params, port detector) sharing one set of weights."""
    cfg = _small_config()
    jdet = jax_factory("faster_rcnn", "resnet50", cfg)
    flat = {
        k: np.array(v)
        for k, v in flatten_dict(jdet.init_params(jax.random.PRNGKey(0)), sep="/").items()
    }
    flat["rpn_head/rpn_score_conv/kernel"] *= RPN_SCORE_SCALE
    flat["roi_head/roi_head_score/kernel"] *= ROI_SCORE_SCALE
    params = jax.tree_util.tree_map(jnp.asarray, unflatten_dict(flat, sep="/"))
    tdet = model_factory("faster_rcnn", "resnet50", cfg, device="cpu")
    load_jax_params(tdet, flat)
    return jdet, params, tdet


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(0)
    return (
        rng.randn(2, 160, 160, 3).astype(np.float32),
        np.array([[144, 128], [160, 160]], np.int32),
    )


@pytest.mark.parametrize(
    "hw,kernel,stride", [((9, 12), 3, 2), ((10, 7), 3, 2), ((8, 8), 3, 1), ((7, 9), 1, 2), ((11, 6), 7, 2)]
)
def test_same_conv2d_matches_flax_same(hw, kernel, stride):
    """TF 'SAME' padding, including the odd extents at stride 2 where it pads
    one more row/column at the bottom/right (atol 1e-5: summation order)."""
    x = np.random.RandomState(2).randn(2, *hw, 3).astype(np.float32)
    conv = fnn.Conv(5, (kernel, kernel), strides=(stride, stride), padding="SAME")
    params = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = conv.apply({"params": params}, jnp.asarray(x))
    port = SameConv2d(3, 5, kernel, stride)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.asarray(params["kernel"]).transpose(3, 2, 0, 1)))
        port.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_backbone_and_rpn_maps(pair, images):
    jdet, params, tdet = pair
    img, _ = images
    ref = jdet._backbone_rpn(params, jnp.asarray(img))
    with torch.no_grad():
        got = tdet._backbone_rpn(torch.from_numpy(img))
    assert got[0].shape == (2, 10, 10, 1024)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **MAP_TOL)

    # the premise of the slice test: RPN scores separate at the pre-NMS cut
    k = tdet.cfg["rpn_proposal_test_pre_nms_sample_number"]
    for i in range(2):
        s = np.sort(np.asarray(jax_reshuffle(ref[1][i], 9)))[::-1]
        assert s[k - 1] - s[k] > 1e-4


def test_roi_head(pair):
    jdet, params, tdet = pair
    x = np.random.RandomState(1).randn(6, 7, 7, 1024).astype(np.float32)
    ref = jdet.roi_head.apply({"params": params["roi_head"]}, jnp.asarray(x))
    with torch.no_grad():
        got = tdet.roi_head(torch.from_numpy(x))
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **MAP_TOL)


def test_predict_matches_jax(pair, images):
    jdet, params, tdet = pair
    img, hw = images
    ref = jdet.predict(params, jnp.asarray(img[0]), jnp.asarray(hw[0]))
    got = tdet.predict(img[0], hw[0])
    assert got.boxes.shape == (10, 4)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), **SCORE_TOL)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes), **BOX_TOL)
    v = got.valid.numpy()
    assert v.sum() > 0
    assert got.boxes.numpy()[v, 2].max() <= 127.0 and got.boxes.numpy()[v, 3].max() <= 143.0


def test_im_detect_batch_matches_jax(pair, images):
    jdet, params, tdet = pair
    img, hw = images
    scales = np.array([1.0, 1.25], np.float32)
    ref = jdet.im_detect_batch(params, jnp.asarray(img), jnp.asarray(hw), jnp.asarray(scales))
    got = tdet.im_detect_batch(img, hw, scales)
    sm, deltas, rois, valid = (t.numpy() for t in got)
    assert sm.shape == (2, 50, 21) and deltas.shape == (2, 50, 21, 4)
    np.testing.assert_array_equal(valid, np.asarray(ref[3]))
    np.testing.assert_allclose(sm, np.asarray(ref[0]), **SCORE_TOL)
    np.testing.assert_allclose(deltas, np.asarray(ref[1]), **MAP_TOL)
    np.testing.assert_allclose(rois, np.asarray(ref[2]), **BOX_TOL)

    # the single-image API is the batch API on a batch of one
    one = tdet.im_detect(img[1], hw[1], scales[1])
    np.testing.assert_array_equal(one[3].numpy(), valid[1])
    np.testing.assert_allclose(one[2].numpy(), rois[1], **BOX_TOL)
