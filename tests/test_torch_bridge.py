"""Weight bridge: flax params of the JAX detector -> the port's state_dict."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from tf_eager_object_detection_tpu.models.heads import RpnHead as JaxRpnHead
from tf_eager_object_detection_tpu.models.model_factory import model_factory as jax_factory
from tf_eager_object_detection_tpu.training.checkpoints import save_params
from tf_eager_object_detection_tpu_torch.models.heads import RpnHead
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.ref_import.from_jax import (
    load_jax_params,
    state_dict_from_jax,
)

from test_faster_rcnn import _small_config


@pytest.fixture(scope="module")
def flat_params():
    """The ResNet-50 detector's flat flax params: shapes from tracing init
    (no compile), values from a numpy seed."""
    jdet = jax_factory("faster_rcnn", "resnet50", _small_config())
    shapes = jax.eval_shape(jdet.init_params, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    return {
        k: rng.randn(*v.shape).astype(np.float32)
        for k, v in flatten_dict(shapes, sep="/").items()
    }


def test_every_leaf_consumed_once_and_transposed(flat_params):
    det = model_factory("faster_rcnn", "resnet50", _small_config(), device="cpu")
    assert len(flat_params) == len(det.state_dict())
    load_jax_params(det, flat_params)  # raises on any unused or missing leaf

    k = flat_params["extractor/conv2_block1_2_conv/kernel"]  # HWIO
    w = det.extractor.conv2_block1_2_conv.weight  # OIHW
    assert tuple(w.shape) == (k.shape[3], k.shape[2], k.shape[0], k.shape[1])
    np.testing.assert_array_equal(w[5, 7, 2, 1].item(), k[2, 1, 7, 5])
    d = flat_params["roi_head/roi_head_bboxes/kernel"]  # [in, out]
    np.testing.assert_array_equal(det.roi_head.roi_head_bboxes.weight.detach().numpy(), d.T)
    np.testing.assert_array_equal(
        det.extractor.conv3_block2_1_bn.moving_variance.numpy(),
        flat_params["extractor/conv3_block2_1_bn/moving_variance"],
    )


@pytest.mark.parametrize("backbone", ["resnet50", "resnet101", "resnet152"])
def test_state_dict_names_and_shapes_match_flax(backbone):
    """Every depth of RESNET_DEPTH_BLOCKS: the bridged flax leaves fill the
    port's state_dict exactly, name for name and shape for shape."""
    jdet = jax_factory("faster_rcnn", backbone, _small_config())
    shapes = flatten_dict(jax.eval_shape(jdet.init_params, jax.random.PRNGKey(0)), sep="/")
    converted = state_dict_from_jax(
        {k: np.zeros(v.shape, np.float32) for k, v in shapes.items()}
    )
    expected = model_factory(
        "faster_rcnn", backbone, _small_config(), device="cpu"
    ).state_dict()
    assert converted.keys() == expected.keys()
    for name, tensor in converted.items():
        assert tensor.shape == expected[name].shape, name


def test_bridged_conv_head_computes_what_flax_computes():
    """A 3x3 SAME conv and two 1x1 convs through the bridge give the flax
    outputs (atol 1e-5: summation order)."""
    head = JaxRpnHead(num_anchors=9)
    x = np.random.RandomState(1).randn(2, 6, 7, 64).astype(np.float32)
    params = head.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    ref = head.apply({"params": params}, jnp.asarray(x))
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    port = RpnHead(in_channels=64, num_anchors=9)
    load_jax_params(port, flat)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=0)


def test_save_params_npz_loads(flat_params, tmp_path):
    params = {}
    for path, value in flat_params.items():
        node = params
        *scope, leaf = path.split("/")
        for s in scope:
            node = node.setdefault(s, {})
        node[leaf] = value
    path = tmp_path / "params.npz"
    save_params(str(path), params)
    det = model_factory("faster_rcnn", "resnet50", _small_config(), device="cpu", seed=5)
    load_jax_params(det, path)
    np.testing.assert_array_equal(
        det.rpn_head.rpn_bbox_conv.bias.detach().numpy(), flat_params["rpn_head/rpn_bbox_conv/bias"]
    )


def test_unused_missing_or_misshapen_leaves_raise(flat_params):
    det = model_factory("faster_rcnn", "resnet50", _small_config(), device="cpu")
    before = det.rpn_head.rpn_first_conv.weight.clone()
    extra = dict(flat_params, **{"extractor/conv9_conv/kernel": np.zeros((1, 1, 1, 1), np.float32)})
    with pytest.raises(KeyError, match="conv9_conv"):
        load_jax_params(det, extra)
    missing = dict(flat_params)
    del missing["roi_head/roi_head_score/bias"]
    with pytest.raises(KeyError, match="roi_head_score"):
        load_jax_params(det, missing)
    bad = dict(flat_params)
    bad["rpn_head/rpn_first_conv/bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="rpn_first_conv"):
        load_jax_params(det, bad)
    with pytest.raises(ValueError, match="unknown flax leaf"):
        load_jax_params(det, {"extractor/conv1_bn/scale": np.zeros(3, np.float32)})
    torch.testing.assert_close(det.rpn_head.rpn_first_conv.weight, before, rtol=0, atol=0)
