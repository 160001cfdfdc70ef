"""ResNet-101 and ResNet-152, Faster R-CNN (C4) and FPN, the port's `predict`
against JAX's on the CPU.

The weights are seeded numpy draws for each JAX detector's parameter tree
(`tests/torch_shared.py::numpy_params`: lecun-normal kernels, random biases
and frozen-BatchNorm statistics, each bottleneck's last BatchNorm scaled
by 0.2 so that the residual stream stays of the order of its input through
the 50 blocks of ResNet-152; seed `SEED`), carried into the port by the
weight bridge.
One 128x128 image with a valid extent of 120x124, small proposal counts.
Each (model, depth) runs once per session, shared between xdist workers.

Tolerances (those of tests/test_torch_model.py): scores atol 1e-4, boxes
atol 1e-3 px, labels and validity exact. The premise that makes the
proposals comparable, RPN foreground probabilities that separate at the
pre-NMS cut, is asserted on the port's RPN maps; for FPN, that no kept
roi lies within 1e-4 of a level boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from tf_eager_object_detection_tpu.models.model_factory import model_factory as jax_factory
from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
from tf_eager_object_detection_tpu_torch.models.heads import reshuffle_frcnn_scores
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.ref_import.from_jax import load_jax_params
from torch_shared import numpy_params, shared

BOX_TOL = dict(rtol=0, atol=1e-3)
SCORE_TOL = dict(rtol=0, atol=1e-4)
PRE_NMS = 256
# a random network's RPN probabilities lie close together; with these
# weights they separate at the pre-NMS cut in all four cases (asserted), so
# that a tie decides no proposal in either framework
SEED = 1
CASES = [(m, d) for m in ("faster_rcnn", "fpn") for d in ("resnet101", "resnet152")]


def _config(model_type):
    cfg = dict(config_factory("pascal", model_type))
    cfg.update(
        rpn_proposal_test_pre_nms_sample_number=PRE_NMS,
        rpn_proposal_test_after_nms_sample_number=32,
        max_objects_per_image=10,
        max_objects_per_class_per_image=10,
        tpu_image_buckets=[[128, 128]],
        image_min_size=128,
        image_max_size=128,
    )
    if model_type == "faster_rcnn":
        cfg["scales"] = [2, 4, 8]
    return cfg


def _image():
    return (np.random.RandomState(0).randn(128, 128, 3).astype(np.float32),
            np.array([120, 124], np.int32))


def _predict_both(model_type, backbone):
    cfg = _config(model_type)
    jdet = jax_factory(model_type, backbone, cfg)
    flat = numpy_params(jdet, seed=SEED)
    image, hw = _image()
    params = jax.tree_util.tree_map(jnp.asarray, unflatten_dict(flat, sep="/"))
    want = [np.asarray(t) for t in jdet.predict(params, jnp.asarray(image), jnp.asarray(hw))]
    del params
    det = model_factory(model_type, backbone, cfg, device="cpu")
    load_jax_params(det, flat)
    got = [t.numpy() for t in det.predict(image, hw)]
    with torch.no_grad():
        x = torch.from_numpy(image[None])
        if model_type == "fpn":
            scores2 = det._flatten_levels(*det._backbone_neck_rpn(x)[1:])[0]
            probs = torch.softmax(scores2, dim=-1)[0, :, 1]
            rois = det._detect(x, torch.from_numpy(hw[None]).long())
            kept = rois[0][0][rois[1][0]].numpy()
        else:
            probs = reshuffle_frcnn_scores(det._backbone_rpn(x)[1], det.num_anchors)[0]
            kept = None
    return dict(want=want, got=got, probs=probs.numpy(), kept=kept,
                blocks=sum(name.endswith("_3_conv.weight") for name in det.state_dict()))


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def case(request, tmp_path_factory):
    model_type, backbone = request.param
    return model_type, backbone, shared(tmp_path_factory, f"torch_depths_{model_type}_{backbone}",
                                        lambda: _predict_both(model_type, backbone))


def test_predict_matches_jax(case):
    model_type, backbone, out = case
    boxes, labels, scores, valid = out["got"]
    jb, jl, js, jv = out["want"]
    # the depth really built: bottlenecks in the extractor (+ the C4 conv5 head)
    blocks = {"resnet101": 3 + 4 + 23 + 3, "resnet152": 3 + 8 + 36 + 3}[backbone]
    assert out["blocks"] == blocks
    p = np.sort(out["probs"])[::-1]
    assert p[PRE_NMS - 1] - p[PRE_NMS] > 1e-4
    if out["kept"] is not None:
        r = out["kept"].astype(np.float64)
        v = 4.0 + np.log2(np.sqrt(np.maximum(r[:, 2] - r[:, 0], 0)
                                  * np.maximum(r[:, 3] - r[:, 1], 0) + 1e-8) / 224.0)
        assert np.abs(v - np.round(v)).min() > 1e-4
    assert boxes.shape == (10, 4) and valid.sum() > 0
    np.testing.assert_array_equal(valid, jv)
    np.testing.assert_array_equal(labels, jl)
    np.testing.assert_allclose(scores, js, **SCORE_TOL)
    np.testing.assert_allclose(boxes, jb, **BOX_TOL)
