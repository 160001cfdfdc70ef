"""The port's FPN ResNet-50 against the JAX FPNDetector, same weights, on the CPU.

JAX weights come from `init_params` and reach the port through the weight
bridge; the JAX detector runs its default einsum RoIAlign path. Small size:
a 128x128 bucket, 512 pre-NMS and 64 post-NMS proposals. Tolerances, with
their reasons:

- feature, neck and head maps, rtol/atol 1e-4: convolutions and the
  upsampling matmuls sum in another order (oneDNN vs XLA:CPU);
- `resize_bilinear_tf1`, atol 1e-5 (summation order); anchors and level
  assignment: exact;
- RoI and detection boxes, atol 1e-3 px: an RPN box delta that differs by
  ~1e-6 is multiplied by the anchor extent, up to 512 px;
- scores and softmax, atol 1e-4; labels and validity: exact. With random
  weights the RPN scores tie near 0.5 and a tie may legitimately pick other
  proposals, so the score layers are scaled until the scores separate (the
  test asserts that they do at the pre-NMS cut), and no proposal may lie
  within 1e-4 of a level boundary (the test asserts that too);
- raw-head outputs (`im_detect*`) are compared on valid proposal slots: the
  port gives invalid slots zero RoI features, JAX crops them at the origin,
  and post-processing drops them either way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from tf_eager_object_detection_tpu.config.config_factory import config_factory as jax_config
from tf_eager_object_detection_tpu.core.anchors import make_level_anchors as jax_level_anchors
from tf_eager_object_detection_tpu.evaluation.batched_inference import (
    batched_im_detect as jax_batched_im_detect,
)
from tf_eager_object_detection_tpu.models.fpn import resize_bilinear_tf1 as jax_resize
from tf_eager_object_detection_tpu.models.model_factory import model_factory as jax_factory
from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
from tf_eager_object_detection_tpu_torch.core.anchors import make_level_anchors
from tf_eager_object_detection_tpu_torch.evaluation.batched_inference import batched_im_detect
from tf_eager_object_detection_tpu_torch.models.fpn import resize_bilinear_tf1
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.ref_import.from_jax import (
    load_jax_params,
    state_dict_from_jax,
)

MAP_TOL = dict(rtol=1e-4, atol=1e-4)
BOX_TOL = dict(rtol=0, atol=1e-3)
SCORE_TOL = dict(rtol=0, atol=1e-4)
RPN_SCORE_SCALE = 20.0
ROI_SCORE_SCALE = 10.0

# keys of the JAX preset that only select or tune TPU code paths
# read by JAX `models/fpn.py` with `cfg.get(key, default)`, absent from its preset
_JAX_DEFAULTS = {"tpu_fpn_backbone_style": "keras"}
_TPU_ONLY_KEYS = {
    "tpu_roi_align_window_dtype", "tpu_roi_align_window", "tpu_roi_align_contract",
    "tpu_fused_optimizer", "tpu_fpn_per_level_prenms", "tpu_native_decode",
}


def _small_config():
    cfg = dict(config_factory("pascal", "fpn"))
    cfg.update(
        rpn_proposal_test_pre_nms_sample_number=512,
        rpn_proposal_test_after_nms_sample_number=64,
        max_objects_per_image=10,
        max_objects_per_class_per_image=10,
        tpu_image_buckets=[[128, 128]],
        image_min_size=128,
        image_max_size=128,
    )
    return cfg


@pytest.fixture(scope="module")
def pair():
    """(jax detector, jax params, port detector) sharing one set of weights."""
    cfg = _small_config()
    jdet = jax_factory("fpn", "resnet50", cfg)
    flat = {
        k: np.array(v)
        for k, v in flatten_dict(jdet.init_params(jax.random.PRNGKey(0)), sep="/").items()
    }
    flat["rpn_head/rpn_score_conv/kernel"] *= RPN_SCORE_SCALE
    flat["roi_head/roi_head_score/kernel"] *= ROI_SCORE_SCALE
    params = jax.tree_util.tree_map(jnp.asarray, unflatten_dict(flat, sep="/"))
    tdet = model_factory("fpn", "resnet50", cfg, device="cpu")
    load_jax_params(tdet, flat)
    return jdet, params, tdet


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(0)
    return (
        rng.randn(2, 128, 128, 3).astype(np.float32),
        np.array([[120, 124], [128, 100]], np.int32),
    )


def _level_margin(rois):
    """Distance of each roi's unrounded level to the nearest integer."""
    r = np.asarray(rois, np.float64)
    v = 4.0 + np.log2(np.sqrt(np.maximum(r[..., 2] - r[..., 0], 0)
                              * np.maximum(r[..., 3] - r[..., 1], 0) + 1e-8) / 224.0)
    return np.abs(v - np.round(v))


def test_fpn_preset_matches_jax():
    """The port's preset is JAX's without the TPU-only keys, plus the keys
    the JAX detector reads with a default its preset does not list (the
    port's preset lists them at that default)."""
    ours = config_factory("pascal", "fpn")
    ref = jax_config("pascal", "fpn")
    assert set(ref) - set(ours) == _TPU_ONLY_KEYS
    assert set(ours) - set(ref) == set(_JAX_DEFAULTS)
    assert ours == {**{k: v for k, v in ref.items() if k in ours}, **_JAX_DEFAULTS}


@pytest.mark.parametrize("in_hw,out_hw", [((5, 7), (10, 14)), ((5, 7), (9, 13)), ((4, 8), (4, 8)),
                                          ((3, 2), (5, 4))])
def test_resize_bilinear_tf1_matches_jax(in_hw, out_hw):
    x = np.random.RandomState(sum(out_hw)).randn(2, *in_hw, 3).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), *out_hw))
    got = resize_bilinear_tf1(torch.from_numpy(x), *out_hw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("level", range(5))
def test_make_level_anchors_matches_jax(level):
    cfg = config_factory("pascal", "fpn")
    stride = cfg["anchor_stride_list"][level]
    args = (cfg["base_anchor_size_list"][level], cfg["scales"], cfg["ratios"],
            640 // stride, 1024 // stride, stride)
    got = make_level_anchors(*args)
    np.testing.assert_array_equal(got, jax_level_anchors(*args))
    # the enum_ratios swap: ratio 0.5 gives a box wider than it is high
    w, h = got[0, 2] - got[0, 0], got[0, 3] - got[0, 1]
    assert w < h and got.shape == (640 // stride * 1024 // stride * 3, 4)


def test_anchor_count_and_valid_mask(pair):
    jdet, _, tdet = pair
    grids = tuple((640 // s, 1024 // s) for s in tdet.strides)
    anchors = tdet.anchors_for_grids(grids)
    assert anchors.shape == (163680, 4)
    np.testing.assert_array_equal(anchors.numpy(), jdet.anchors_for_grids(grids))
    hw = np.array([[600, 800], [640, 1024]], np.int32)
    got = tdet._level_valid_mask(grids, torch.from_numpy(hw)).numpy()
    for i in range(2):
        np.testing.assert_array_equal(got[i], np.asarray(jdet._level_valid_mask(grids, hw[i])))


def test_roi_levels_match_jax(pair):
    jdet, _, tdet = pair
    rng = np.random.RandomState(5)
    side = np.exp(rng.uniform(np.log(4), np.log(1200), (500, 2)))
    xy = rng.uniform(0, 400, (500, 2))
    rois = np.concatenate([xy, xy + side], -1).astype(np.float32)
    rois = np.concatenate([rois, [[10, 10, 10, 10], [50, 50, 40, 40]]]).astype(np.float32)
    rois = rois[_level_margin(rois) > 1e-4]
    assert len(rois) > 450
    want = np.asarray(jdet._roi_levels(jnp.asarray(rois)))
    got = tdet._roi_levels(torch.from_numpy(rois)).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(got.tolist()) == {2, 3, 4, 5}


def test_backbone_neck_rpn_maps(pair, images):
    jdet, params, tdet = pair
    img, _ = images
    ref = jdet._backbone_neck_rpn(params, jnp.asarray(img))
    with torch.no_grad():
        got = tdet._backbone_neck_rpn(torch.from_numpy(img))
    assert [tuple(p.shape) for p in got[0]] == [(2, 32, 32, 256), (2, 16, 16, 256),
                                               (2, 8, 8, 256), (2, 4, 4, 256), (2, 2, 2, 256)]
    for g_list, r_list in zip(got, ref):
        for g, r in zip(g_list, r_list):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **MAP_TOL)

    # the premise of the slice tests: RPN scores separate at the pre-NMS cut
    k = tdet.cfg["rpn_proposal_test_pre_nms_sample_number"]
    for i in range(2):
        logits = np.concatenate([np.asarray(s[i]).reshape(-1, 2) for s in ref[1]])
        p = np.sort(np.asarray(jax.nn.softmax(logits, -1))[:, 1])[::-1]
        assert p[k - 1] - p[k] > 1e-4


def test_fpn_roi_head(pair):
    jdet, params, tdet = pair
    x = np.random.RandomState(1).randn(6, 7, 7, 256).astype(np.float32)
    ref = jdet.roi_head.apply({"params": params["roi_head"]}, jnp.asarray(x))
    with torch.no_grad():
        got = tdet.roi_head(torch.from_numpy(x))
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **MAP_TOL)


def _check_raw(got, ref):
    """im_detect outputs: validity exact, rois everywhere, heads on valid slots."""
    sm, deltas, rois, valid = (t.numpy() for t in got)
    ref = [np.asarray(r) for r in ref]
    np.testing.assert_array_equal(valid, ref[3])
    assert valid.any()
    np.testing.assert_allclose(rois, ref[2], **BOX_TOL)
    assert _level_margin(ref[2][ref[3]]).min() > 1e-4
    np.testing.assert_allclose(sm[valid], ref[0][valid], **SCORE_TOL)
    np.testing.assert_allclose(deltas[valid], ref[1][valid], **MAP_TOL)


def test_fpn_predict_matches_jax(pair, images):
    jdet, params, tdet = pair
    img, hw = images
    for i in range(2):
        ref = jdet.predict(params, jnp.asarray(img[i]), jnp.asarray(hw[i]))
        got = tdet.predict(img[i], hw[i])
        assert got.boxes.shape == (10, 4)
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
        np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), **SCORE_TOL)
        np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes), **BOX_TOL)
        v = got.valid.numpy()
        assert v.sum() > 0
        b = got.boxes.numpy()[v]
        assert b[:, 2].max() <= hw[i, 1] - 1 and b[:, 3].max() <= hw[i, 0] - 1


def test_fpn_im_detect_batch_matches_jax(pair, images):
    jdet, params, tdet = pair
    img, hw = images
    scales = np.array([1.0, 1.25], np.float32)
    ref = jdet.im_detect_batch(params, jnp.asarray(img), jnp.asarray(hw), jnp.asarray(scales))
    got = tdet.im_detect_batch(img, hw, scales)
    assert got[0].shape == (2, 64, 21) and got[1].shape == (2, 64, 21, 4)
    _check_raw(got, ref)


def test_fpn_im_detect_matches_jax(pair, images):
    jdet, params, tdet = pair
    img, hw = images
    ref = jdet.im_detect(params, jnp.asarray(img[1]), jnp.asarray(hw[1]), 1.5)
    got = tdet.im_detect(img[1], hw[1], 1.5)
    assert got[2].shape == (64, 4)
    _check_raw(got, ref)


def test_fpn_batched_im_detect_matches_jax(pair, images):
    """The bucket-grouped stream (one full batch of 2, one padded partial)
    serves FPN unchanged."""
    jdet, params, tdet = pair
    img, hw = images
    items = [(img[0], hw[0], 1.0), (img[1], hw[1], 1.25), (img[1][::-1].copy(), hw[0], 2.0)]
    ref = {i: out for i, _, out in jax_batched_im_detect(jdet, params, items, batch_size=2)}
    got = {i: out for i, _, out in batched_im_detect(tdet, items, batch_size=2)}
    assert sorted(got) == sorted(ref) == [0, 1, 2]
    for i in range(3):
        _check_raw(got[i], ref[i])


@pytest.mark.parametrize("backbone", ["resnet50", "resnet101", "resnet152"])
def test_fpn_state_dict_names_and_shapes_match_flax(backbone):
    """Every FPN leaf (extractor with conv5, neck, rpn_head, roi_head with
    Dense fc1/fc2) fills the port's state_dict exactly once."""
    jdet = jax_factory("fpn", backbone, _small_config())
    shapes = flatten_dict(jax.eval_shape(jdet.init_params, jax.random.PRNGKey(0)), sep="/")
    assert "extractor/conv5_block3_3_conv/kernel" in shapes
    converted = state_dict_from_jax({k: np.zeros(v.shape, np.float32) for k, v in shapes.items()})
    expected = model_factory("fpn", backbone, _small_config(), device="cpu").state_dict()
    assert len(shapes) == len(expected)
    assert converted.keys() == expected.keys()
    for name, tensor in converted.items():
        assert tensor.shape == expected[name].shape, name


def test_fpn_bridge_transposes_dense_and_conv_leaves(pair):
    jdet, params, tdet = pair
    fc1 = np.asarray(params["roi_head"]["fc1"]["kernel"])  # [7*7*256 in NHWC order, 1024]
    np.testing.assert_array_equal(tdet.roi_head.fc1.weight.detach().numpy(), fc1.T)
    k = np.asarray(params["neck"]["build_p3"]["kernel"])  # HWIO
    np.testing.assert_array_equal(tdet.neck.build_p3.weight.detach().numpy(),
                                  k.transpose(3, 2, 0, 1))
