"""The port's VGG16 Faster R-CNN against the JAX detector, on the CPU.

Both frameworks run one JAX `init_params(PRNGKey(0))` of the VGG16
detector (138 M parameters, its RPN score layer scaled by 20 so that
random-weight proposals separate at the pre-NMS cut, which the tests
assert), computed once per session and shared between xdist workers
(`tests/torch_shared.py::shared`), carried into the port by the weight
bridge. The config is cut as in tests/test_torch_faster_rcnn_train.py: a
128x128 bucket, anchor scales (2, 4, 8), small proposal and sample counts.
The expensive comparisons (serving, one training step at B=1 and at B=2)
run once per session each, under the same lock, and hand the tests what
they compare.

Dropout: random streams cannot match across frameworks, so the port's
RoI head takes its keep masks from `TrainDraws`. The tests get JAX's masks
by interception: the key of the head's dropout is `split(key, b + 1)[b]`
in JAX `loss_fn`; `flax.linen.intercept_methods` runs each `nn.Dropout` on
ones (what is kept comes out > 0) and returns `where(mask, x / keep, 0)`,
bit-equal to a plain `apply` with the same key (asserted). The samplers'
draws come from `split(key, b + 1)[:b]` as in the C4 test.

Tolerances, with their reasons (those of tests/test_torch_model.py and
tests/test_torch_faster_rcnn_train.py):

- feature maps, RPN maps and head outputs rtol/atol 1e-4 (oneDNN and
  XLA:CPU sum in another order); boxes atol 1e-3 px (a delta times anchor
  extents); scores and softmax atol 1e-4; labels and validity exact;
- losses rtol 1e-4, counts exact; every trainable tensor's gradient and
  momentum trace within GRAD_TOL = 2e-3 of its largest absolute value
  (observed worst cases in the tests' docstrings), but block3_conv1 and
  block3_conv2 within FLIP_TOL = 5e-3: one block3_conv2 pre-activation of
  image 0 is -6.2e-6 in float64, -1.2e-6 in the port and +1.0e-5 in XLA
  (their float32 sums differ by up to 3.8e-5 at that layer), so only JAX's
  ReLU passes that unit, and the gradients of that layer and the one below
  it differ by up to 2.5e-3 of their largest value (observed); parameters
  after one momentum step atol 1e-6, 2.5e-6 for those two layers (lr 1e-3
  times the gradients' tolerances);
- blocks 1-2 (the VGG16 freeze policy) take no gradient and keep their
  bits;
- under bf16 compute, the dtype of every stage equals the flax modules'
  (the port's counterpart of tests/test_bf16.py's VGG16 case).
"""

import glob
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from tf_eager_object_detection_tpu.models import freeze as jax_freeze
from tf_eager_object_detection_tpu.models.layers import max_pool_same as jax_max_pool_same
from tf_eager_object_detection_tpu.models.model_factory import model_factory as jax_factory
from tf_eager_object_detection_tpu.ops.roi_align import roi_crop_faster_rcnn as jax_crop
from tf_eager_object_detection_tpu.training import checkpoints as jax_checkpoints
from tf_eager_object_detection_tpu.training.optimizer import make_optimizer as jax_optimizer
from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
from tf_eager_object_detection_tpu_torch.core.anchors import valid_anchor_mask
from tf_eager_object_detection_tpu_torch.data.voc import create_pascal_tf_records
from tf_eager_object_detection_tpu_torch.models.backbones.vgg import (
    VGG16_HIDDEN,
    Vgg16Extractor,
    Vgg16RoiHead,
)
from tf_eager_object_detection_tpu_torch.models.freeze import trainable_mask, weight_decay_mask
from tf_eager_object_detection_tpu_torch.models.heads import reshuffle_frcnn_scores
from tf_eager_object_detection_tpu_torch.models.layers import max_pool_same
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.ops.roi_align import roi_crop_faster_rcnn
from tf_eager_object_detection_tpu_torch.ops.sampling import TrainDraws
from tf_eager_object_detection_tpu_torch.ref_import.from_jax import (
    load_jax_params,
    parameter_tree_from_jax,
)
from tf_eager_object_detection_tpu_torch.scripts import eval_pascal
from tf_eager_object_detection_tpu_torch.scripts import train as train_cli
from tf_eager_object_detection_tpu_torch.scripts.voc_rehearsal import generate
from tf_eager_object_detection_tpu_torch.training.checkpoints import load_params, save_params
from tf_eager_object_detection_tpu_torch.training.optimizer import make_optimizer
from tf_eager_object_detection_tpu_torch.training.train_step import make_train_step
from tf_eager_object_detection_tpu_torch.training.trainer import Trainer
from test_torch_faster_rcnn_train import jax_draws
from torch_shared import shared

MAP_TOL = dict(rtol=1e-4, atol=1e-4)
BOX_TOL = dict(rtol=0, atol=1e-3)
SCORE_TOL = dict(rtol=0, atol=1e-4)
GRAD_TOL = 2e-3
FLIP_TOL = 5e-3
FLIPPED = ("extractor.block3_conv1.", "extractor.block3_conv2.")  # below the flipped ReLU
RPN_SCORE_SCALE = 20.0
ROI_SCORE_SCALE = 10.0  # serving only: spreads the random head's class scores
KEY = 11
PRE_NMS, POST_NMS, ROI_SAMPLES = 256, 64, 32
TEST_PRE_NMS = 256
BATCHES = [1, 2]
IMAGE_SCALE = 50.0


def _config(dtype="float32"):
    cfg = dict(config_factory("pascal", "faster_rcnn"))
    cfg.update(
        scales=[2, 4, 8],
        rpn_proposal_train_pre_nms_sample_number=PRE_NMS,
        rpn_proposal_train_after_nms_sample_number=POST_NMS,
        rpn_total_sample_number=64,
        rpn_pos_sample_max_number=32,
        roi_total_sample_number=ROI_SAMPLES,
        roi_pos_sample_max_number=8,
        rpn_proposal_test_pre_nms_sample_number=TEST_PRE_NMS,
        rpn_proposal_test_after_nms_sample_number=32,
        max_objects_per_image=10,
        max_objects_per_class_per_image=10,
        tpu_image_buckets=[[128, 128]],
        image_min_size=128,
        image_max_size=128,
        tpu_max_gt_boxes=8,
        tpu_compute_dtype=dtype,
    )
    return cfg


def _batch(b):
    rng = np.random.RandomState(0)
    # caffe-scaled pixels: 13 ReLU layers at lecun init shrink a unit input ~90x
    images = (rng.randn(2, 128, 128, 3) * IMAGE_SCALE).astype(np.float32)
    hw = np.asarray([[120, 124], [128, 100]], np.int32)
    gt = np.zeros((2, 8, 4), np.float32)
    gt[0, :3] = [[10, 12, 60, 70], [40, 30, 118, 100], [5, 50, 50, 110]]
    gt[1, :4] = [[20, 20, 90, 60], [0, 0, 99, 127], [60, 70, 95, 120], [30, 5, 70, 40]]
    mask = np.zeros((2, 8), bool)
    mask[0, :3] = mask[1, :4] = True
    labels = np.zeros((2, 8), np.int32)
    labels[0, :3] = [3, 7, 12]
    labels[1, :4] = [1, 20, 5, 7]
    return tuple(a[:b] for a in (images, hw, gt, mask, labels))


def _jax_init():
    jdet = jax_factory("faster_rcnn", "vgg16", _config())
    flat = {k: np.array(v) for k, v in
            flatten_dict(jax.jit(jdet.init_params)(jax.random.PRNGKey(0)), sep="/").items()}
    flat["rpn_head/rpn_score_conv/kernel"] *= RPN_SCORE_SCALE
    return flat


@pytest.fixture(scope="module")
def flat(tmp_path_factory):
    return shared(tmp_path_factory, "jax_init_faster_rcnn_vgg16_rpn_x20", _jax_init)


def _serving_flat(flat):
    return dict(flat, **{"roi_head/roi_head_score/kernel":
                         flat["roi_head/roi_head_score/kernel"] * ROI_SCORE_SCALE})


def _jax_params(flat):
    return jax.tree_util.tree_map(jnp.asarray, unflatten_dict(flat, sep="/"))


def _port(flat, dtype="float32", **overrides):
    det = model_factory("faster_rcnn", "vgg16", dict(_config(dtype), **overrides), device="cpu")
    load_jax_params(det, flat)
    return det


def _sub(flat, scope):
    """The leaves of one module (`extractor`, `roi_head`), prefix removed."""
    return {k.split("/", 1)[1]: v for k, v in flat.items() if k.startswith(scope + "/")}


def jax_dropout_keep(jdet, roi_params, key, b, s):
    """The keep masks [2, b * s, 4096] of the two dropout layers of JAX
    `loss_fn`'s RoI head under `key`: the head applied with `train=True`
    and the `loss_fn`'s dropout key `split(key, b + 1)[b]`, each
    `nn.Dropout` run on ones by an interceptor (a mask depends on the key,
    the module's path and the shape, not on the values)."""
    masks = []

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            masks.append(np.asarray(next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs) > 0))
            return args[0]
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(interceptor):
        jdet.roi_head.apply({"params": roi_params}, jnp.zeros((b * s, 7, 7, 512)), train=True,
                            rngs={"dropout": jax.random.split(key, b + 1)[b]})
    return torch.from_numpy(np.stack(masks))


# ------------------------------------------------------------ the layers
@pytest.mark.parametrize("shape", [(1, 3, 7, 9), (2, 4, 8, 6), (1, 2, 1, 5), (1, 3, 11, 11)])
def test_max_pool_same_matches_flax(shape):
    """keras SAME 2x2 / 2 pooling: an odd side gets its extra row or column
    on the bottom / right, padded with -inf (all-negative inputs show a 0 pad)."""
    x = -np.abs(np.random.RandomState(3).randn(*shape)).astype(np.float32) - 1.0
    want = np.asarray(jax_max_pool_same(jnp.asarray(x.transpose(0, 2, 3, 1)), 2, 2))
    got = max_pool_same(torch.from_numpy(x), 2, 2).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(75, 93), (50, 37), (64, 64)])
def test_extractor_matches_jax_on_odd_sides(flat, hw):
    """Stride 16 with four SAME pools: 75x93 pools through 38x47, 19x24 and
    10x12 to 5x6, each odd side with the bottom / right row."""
    jdet = jax_factory("faster_rcnn", "vgg16", _config())
    x = np.random.RandomState(1).randn(1, *hw, 3).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, unflatten_dict(_sub(flat, "extractor"), sep="/"))
    want = np.asarray(jax.jit(lambda p, v: jdet.extractor.apply({"params": p}, v))(
        params, jnp.asarray(x)))
    ext = Vgg16Extractor()
    load_jax_params(ext, _sub(flat, "extractor"))
    with torch.no_grad():
        got = ext(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, -(-hw[0] // 16), -(-hw[1] // 16), 512)
    np.testing.assert_allclose(got, want, **MAP_TOL)
    assert np.abs(want).max() > 0


@pytest.fixture(scope="module")
def head_pair(flat):
    jdet = jax_factory("faster_rcnn", "vgg16", _config())
    head = Vgg16RoiHead()
    load_jax_params(head, _sub(flat, "roi_head"))
    x = np.random.RandomState(2).randn(6, 7, 7, 512).astype(np.float32)
    return jdet, _jax_params(_sub(flat, "roi_head")), head, x


def test_fc1_takes_the_crop_flattened_in_nhwc_order(flat, head_pair):
    """The port flattens the [N, 7, 7, 512] crop as it is, (h, w, c), so
    the bridged fc1 weight's column (h * 7 + w) * 512 + c is the flax
    kernel's row of the same index, and a crop with one nonzero cell gives
    the flax head's output."""
    jdet, params, head, _ = head_pair
    kernel = flat["roi_head/fc1/kernel"]
    for h, w, c in [(0, 0, 0), (0, 1, 0), (1, 0, 0), (0, 0, 1), (6, 5, 300)]:
        idx = (h * 7 + w) * 512 + c
        np.testing.assert_array_equal(head.fc1.weight[:, idx].detach().numpy(), kernel[idx])
    x = np.zeros((2, 7, 7, 512), np.float32)
    x[0, 2, 5, 17] = 3.0
    x[1, 6, 0, 511] = -2.0
    want = jdet.roi_head.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = head(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MAP_TOL)


def test_head_without_dropout_matches_jax_eval(head_pair):
    jdet, params, head, x = head_pair
    want = jdet.roi_head.apply({"params": params}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = head(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MAP_TOL)


def test_head_with_intercepted_masks_matches_jax_train(head_pair):
    """JAX `train=True` with a dropout key against the port's head given the
    masks that key draws; the interception itself is bit-equal to a plain
    `apply`."""
    jdet, params, head, x = head_pair
    key = jax.random.PRNGKey(5)
    rngs = {"dropout": jax.random.split(key, 2)[1]}
    want = jdet.roi_head.apply({"params": params}, jnp.asarray(x), train=True, rngs=rngs)
    keep = jax_dropout_keep(jdet, params, key, 1, 6)
    assert keep.shape == (2, 6, VGG16_HIDDEN) and keep.dtype == torch.bool
    assert 0.45 < float(keep.float().mean()) < 0.55  # keep rate 0.5

    def select(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            mask = next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs) > 0
            return jnp.where(mask, args[0] / (1.0 - context.module.rate), 0)
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(select):
        intercepted = jdet.roi_head.apply({"params": params}, jnp.asarray(x), train=True,
                                          rngs=rngs)
    for a, b in zip(intercepted, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with torch.no_grad():
        got = head(torch.from_numpy(x), keep)
        plain = head(torch.from_numpy(x))
    for g, w, p in zip(got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MAP_TOL)
        assert not np.allclose(g.numpy(), p.numpy(), **MAP_TOL)


# --------------------------------------------------------------- serving
def _serving(flat, tmp):
    """JAX and port: backbone + RPN maps, `predict` and `im_detect_batch`
    on the same two images (the RoI score layer scaled by 10); then the
    port's `.npz` of these weights read by JAX `load_params` and served by
    the same JAX `predict`, and JAX's `.npz` read by the port. The port's
    detector also runs `_port_checks`."""
    sflat = _serving_flat(flat)
    jdet = jax_factory("faster_rcnn", "vgg16", _config())
    params = _jax_params(sflat)
    images, hw = _batch(2)[:2]
    scales = np.array([1.0, 1.25], np.float32)
    maps = jax.jit(jdet._backbone_rpn)(params, jnp.asarray(images))
    pred = jdet.predict(params, jnp.asarray(images[0]), jnp.asarray(hw[0]))
    batch = jdet.im_detect_batch(params, jnp.asarray(images), jnp.asarray(hw), jnp.asarray(scales))
    out = {"jax_maps": [np.asarray(m) for m in maps], "jax_predict": [np.asarray(t) for t in pred],
           "jax_batch": [np.asarray(t) for t in batch]}
    del params
    det = _port(sflat)
    with torch.no_grad():
        out["maps"] = [t.numpy() for t in det._backbone_rpn(torch.from_numpy(images))]
    out["predict"] = [t.numpy() for t in det.predict(images[0], hw[0])]
    out["batch"] = [t.numpy() for t in det.im_detect_batch(images, hw, scales)]
    out["one"] = [t.numpy() for t in det.im_detect(images[1], hw[1], scales[1])]
    out["predict_again"] = [t.numpy() for t in det.predict(images[0], hw[0])]
    out["training"] = det.training
    out["port_checks"] = _port_checks(det)

    save_params(str(tmp / "port.npz"), det)
    loaded = flatten_dict(jax_checkpoints.load_params(str(tmp / "port.npz")), sep="/")
    out["npz_keys_equal"] = set(loaded) == set(sflat)
    out["npz_leaves_unequal"] = [k for k, v in sflat.items()
                                 if not np.array_equal(np.asarray(loaded[k]), v)]
    pred = jdet.predict(_jax_params({k: np.asarray(v) for k, v in loaded.items()}),
                        jnp.asarray(images[0]), jnp.asarray(hw[0]))
    out["jax_predict_of_port_npz"] = [np.asarray(t) for t in pred]
    del loaded, pred

    (tmp / "port.npz").unlink()
    with torch.no_grad():
        for p in det.parameters():
            p.zero_()
    jax_checkpoints.save_params(str(tmp / "jax.npz"), unflatten_dict(sflat, sep="/"))
    load_params(str(tmp / "jax.npz"), det)
    state = det.state_dict()
    out["port_leaves_unequal"] = [k for k, v in parameter_tree_from_jax(sflat).items()
                                  if not torch.equal(state[k], v)]
    out["port_state_size"] = len(state)
    (tmp / "jax.npz").unlink()
    return out


@pytest.fixture(scope="module")
def serving(tmp_path_factory, flat):
    return shared(tmp_path_factory, "torch_vgg16_serving",
                  lambda: _serving(flat, tmp_path_factory.mktemp("vgg16_npz")))


def test_backbone_and_rpn_maps_match_jax(serving):
    got, want = serving["maps"], serving["jax_maps"]
    assert got[0].shape == (2, 8, 8, 512) and got[1].shape == (2, 8, 8, 18)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **MAP_TOL)
    # the premise: the RPN scores of the valid anchors separate at the pre-NMS cut
    probs = reshuffle_frcnn_scores(torch.tensor(want[1]), 9).numpy()
    for p in probs:
        p = np.sort(p)[::-1]
        assert p[TEST_PRE_NMS - 1] - p[TEST_PRE_NMS] > 1e-4


def test_predict_matches_jax(serving):
    boxes, labels, scores, valid = serving["predict"]
    jb, jl, js, jv = serving["jax_predict"]
    assert boxes.shape == (10, 4)
    np.testing.assert_array_equal(valid, jv)
    np.testing.assert_array_equal(labels, jl)
    np.testing.assert_allclose(scores, js, **SCORE_TOL)
    np.testing.assert_allclose(boxes, jb, **BOX_TOL)
    assert valid.sum() > 0 and boxes[valid, 2].max() <= 123.0 and boxes[valid, 3].max() <= 119.0


def test_im_detect_batch_matches_jax(serving):
    sm, deltas, rois, valid = serving["batch"]
    jsm, jdeltas, jrois, jvalid = serving["jax_batch"]
    assert sm.shape == (2, 32, 21) and deltas.shape == (2, 32, 21, 4)
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_allclose(sm, jsm, **SCORE_TOL)
    np.testing.assert_allclose(deltas, jdeltas, **MAP_TOL)
    np.testing.assert_allclose(rois, jrois, **BOX_TOL)
    one = serving["one"]  # the single-image API is the batch API on a batch of one
    np.testing.assert_array_equal(one[3], valid[1])
    np.testing.assert_allclose(one[2], rois[1], **BOX_TOL)


def test_serving_has_no_dropout(serving):
    """The detector stays in eval and serving gives the same detections
    call after call (no mask is drawn outside `loss_fn`)."""
    assert serving["training"] is False
    for a, b in zip(serving["predict"], serving["predict_again"]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------- training step
def _flat_np(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _rel_errors(got, want):
    """{name: max |got - want| / max |want|} over the tensors of `want`."""
    out = {}
    for name, w in want.items():
        w = w.numpy()
        out[name] = float(np.abs(got[name] - w).max()) / max(float(np.abs(w).max()), 1e-30)
    return out


def _train_step(flat, b):
    """JAX loss, gradients and one fused-momentum step against the port's
    `make_train_step` from the bridged weights with JAX's sampler draws and
    dropout masks; returns what the tests compare, the large trees reduced
    to per-tensor errors."""
    cfg = _config()
    jdet = jax_factory("faster_rcnn", "vgg16", cfg)
    params = _jax_params(flat)
    batch = [jnp.asarray(a) for a in _batch(b)]
    key = jax.random.PRNGKey(KEY)

    def loss(p):
        return jdet.loss_fn(p, *batch, key)

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    opt = jax_optimizer(cfg, params, "vgg16", "faster_rcnn")
    updates, state = jax.jit(lambda g, p: opt.update(g, opt.init(p), p))(grads, params)
    keep = jax_dropout_keep(jdet, params["roi_head"], key, b, ROI_SAMPLES)
    want = {"grads": parameter_tree_from_jax(_flat_np(grads)),
            "params": parameter_tree_from_jax(_flat_np(optax.apply_updates(params, updates))),
            "trace": parameter_tree_from_jax(_flat_np(state.trace))}
    out = {"jax_metrics": {k: float(v) for k, v in metrics.items()}}
    del params, grads, updates, state

    det = _port(flat)
    before = {n: p.detach().clone() for n, p in det.named_parameters() if not p.requires_grad}
    port_opt = make_optimizer(cfg, det)
    draws = jax_draws(key, b, (128 // 16) ** 2 * det.num_anchors, POST_NMS, ROI_SAMPLES)
    draws = draws._replace(dropout_keep=keep)
    images, hw = _batch(b)[:2]
    with torch.no_grad():  # the RPN foreground probabilities, for the premise
        _, score_map, _ = det._backbone_rpn(torch.from_numpy(images))
        probs = reshuffle_frcnn_scores(score_map, det.num_anchors)
        cells = torch.from_numpy(-(-hw.astype(np.int64) // 16))
        valid = valid_anchor_mask(8, 8, det.num_anchors, cells[:, 0], cells[:, 1])
        out["probs"] = torch.where(valid, probs, torch.full_like(probs, -1.0)).numpy()
    metrics = make_train_step(det, port_opt)(_batch(b), draws)
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    grads = {n: p.grad.numpy() for n, p in det.named_parameters() if p.grad is not None}
    out["frozen"] = {n for n, p in det.named_parameters() if not p.requires_grad}
    out["grad_names"], out["trace_names"] = set(grads), set(port_opt.trace)
    out["param_names"] = {n for n, _ in det.named_parameters()}
    out["grad_err"] = _rel_errors(grads, {k: v for k, v in want["grads"].items()
                                          if k not in out["frozen"]})
    out["grad_max"] = {n: float(np.abs(g).max()) for n, g in grads.items()}
    params_now = {n: p.detach().numpy() for n, p in det.named_parameters()}
    out["param_abs_err"] = {n: float(np.abs(params_now[n] - w.numpy()).max())
                            for n, w in want["params"].items()}
    out["trace_err"] = _rel_errors({n: t.numpy() for n, t in port_opt.trace.items()},
                                   {k: v for k, v in want["trace"].items()
                                    if k not in out["frozen"]})
    out["frozen_unchanged"] = {n: bool(torch.equal(before[n], dict(det.named_parameters())[n]))
                               for n in out["frozen"]}
    return out


@pytest.fixture(scope="module", params=BATCHES)
def step(request, tmp_path_factory, flat):
    b = request.param
    return b, shared(tmp_path_factory, f"torch_vgg16_step_b{b}", lambda: _train_step(flat, b))


def test_losses_and_counts_match_jax(step):
    _, got = step
    want = got["jax_metrics"]
    assert set(got["metrics"]) == set(want)
    for k, v in want.items():
        if k.startswith("num_"):
            assert got["metrics"][k] == v, k
        else:
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4, err_msg=k)
    assert want["num_roi_fg"] > 0 and want["num_rpn_fg"] > 0
    for probs in got["probs"]:  # the premise: the RPN scores separate at the pre-NMS cut
        p = np.sort(probs)[::-1]
        assert p[PRE_NMS - 1] - p[PRE_NMS] > 1e-4


def _assert_within(errors):
    """GRAD_TOL for every tensor, FLIP_TOL below the flipped ReLU."""
    for name, err in errors.items():
        assert err <= (FLIP_TOL if name.startswith(FLIPPED) else GRAD_TOL), (name, err)


def test_gradients_match_jax(step):
    """Every trainable tensor within GRAD_TOL of its largest value (observed
    worst away from block3_conv1 / conv2 7.7e-5 at B=1), those two within
    FLIP_TOL (observed 2.0e-3 at B=1, 2.5e-3 at B=2); the RoI branch's
    gradient reaches the backbone through the crop and the dropout layers."""
    _, got = step
    assert got["grad_names"] == got["param_names"] - got["frozen"]
    _assert_within(got["grad_err"])
    assert got["grad_max"]["roi_head.fc1.weight"] > 0
    assert got["grad_max"]["extractor.block5_conv3.weight"] > 0


def test_params_and_momentum_after_one_step_match_jax(step):
    _, got = step
    assert set(got["param_abs_err"]) == got["param_names"]
    assert got["trace_names"] == got["param_names"] - got["frozen"]
    for name, err in got["param_abs_err"].items():
        assert err <= (2.5e-6 if name.startswith(FLIPPED) else 1e-6), (name, err)
    _assert_within(got["trace_err"])


def test_frozen_blocks_unchanged(step):
    """The VGG16 freeze policy: blocks 1-2 of the extractor (and nothing
    else) are frozen, take no gradient and keep their bits."""
    _, got = step
    assert {n.rsplit(".", 1)[0] for n in got["frozen"]} == {
        f"extractor.block{b}_conv{c}" for b in (1, 2) for c in (1, 2)}
    assert all(got["frozen_unchanged"].values())


def test_freeze_and_weight_decay_masks_match_jax(flat):
    """trainable and L2 masks of the real VGG16 detector against JAX's on
    its parameter tree: blocks 1-2 frozen, decay on trainable kernels only."""
    det = model_factory("faster_rcnn", "vgg16", _config(), device="cpu")
    tree = unflatten_dict({k: 0.0 for k in flat}, sep="/")
    jt = flatten_dict(jax_freeze.trainable_mask(tree, "vgg16", "faster_rcnn"), sep="/")
    jd = flatten_dict(jax_freeze.weight_decay_mask(tree, "vgg16", "faster_rcnn"), sep="/")
    tm, dm = trainable_mask(det), weight_decay_mask(det)
    names = {k: k.rsplit("/", 1)[0].replace("/", ".")
             + (".weight" if k.endswith("/kernel") else ".bias") for k in flat}
    assert set(names.values()) == set(tm)
    for path, name in names.items():
        assert tm[name] == jt[path] and dm[name] == jd[path], path
    # 4 frozen convs (weight, bias); decay on 9 + 3 conv and 4 dense kernels
    assert sum(not v for v in tm.values()) == 8 and sum(dm.values()) == 16


def _port_checks(det):
    """The port alone, on a float32 detector: its draws' masks, a step with
    every unit dropped, and `tpu_remat`'s gradients against none."""
    a = (128 // 16) ** 2 * det.num_anchors
    gen = torch.Generator().manual_seed(0)
    draws = TrainDraws.sample(gen, 2, 100, 30, 8, det.roi_dropout)
    out = {"roi_dropout": det.roi_dropout, "keep_shape": tuple(draws.dropout_keep.shape),
           "keep_dtype": draws.dropout_keep.dtype,
           "keep_mean": float(draws.dropout_keep.float().mean()),
           "resnet_roi_dropout": model_factory("faster_rcnn", "resnet50", _config(),
                                               device="cpu").roi_dropout}

    draws = TrainDraws.sample(torch.Generator().manual_seed(1), 1, a, POST_NMS, ROI_SAMPLES,
                              det.roi_dropout)
    total, metrics = det.loss_fn(*_batch(1), draws._replace(
        dropout_keep=torch.zeros_like(draws.dropout_keep)))
    total.backward()
    out["dropped_roi_cls_loss"] = float(metrics["roi_cls_loss"].detach())
    out["dropped_grad_max"] = {n: float(getattr(det.roi_head, n).weight.grad.abs().max())
                               for n in ("fc1", "fc2")}
    out["dropped_backbone_grad"] = float(det.extractor.block5_conv3.weight.grad.abs().max())

    grads = []
    for remat in (False, True):
        det.cfg["tpu_remat"] = remat
        det.zero_grad()
        total, _ = det.loss_fn(*_batch(1), draws)
        total.backward()
        grads.append({n: p.grad.clone() for n, p in det.named_parameters()
                      if p.grad is not None})
    det.cfg["tpu_remat"] = False
    det.zero_grad()
    out["remat_names_equal"] = grads[0].keys() == grads[1].keys()
    out["remat_unequal"] = [n for n, g in grads[0].items() if not torch.equal(g, grads[1][n])]
    return out


@pytest.fixture(scope="module")
def port_checks(serving):
    return serving["port_checks"]


def test_train_draws_carry_masks_only_for_a_head_with_dropout(port_checks):
    assert port_checks["roi_dropout"] == (0.5, VGG16_HIDDEN)
    assert port_checks["keep_shape"] == (2, 16, VGG16_HIDDEN)
    assert port_checks["keep_dtype"] == torch.bool
    assert 0.45 < port_checks["keep_mean"] < 0.55
    assert port_checks["resnet_roi_dropout"] is None


def test_dropout_masks_reach_the_head(port_checks):
    """With every unit dropped, fc1 and fc2 take no gradient from the RoI
    losses and the head's output is its biases (0 at init): the RoI
    classification loss is log 21."""
    np.testing.assert_allclose(port_checks["dropped_roi_cls_loss"], np.log(21.0), rtol=1e-6)
    assert port_checks["dropped_grad_max"] == {"fc1": 0.0, "fc2": 0.0}
    assert port_checks["dropped_backbone_grad"] > 0  # the RPN losses


def test_tpu_remat_gives_equal_gradients(port_checks):
    """`tpu_remat` recomputes the VGG16 extractor in the backward: the same
    gradients, bit for bit, at float32."""
    assert port_checks["remat_names_equal"] and port_checks["remat_unequal"] == []


# ------------------------------------------------------------------- bf16
def _jax_dtype_map():
    """{flax submodule: [(input dtype, output dtype)]} of the JAX VGG16 bf16
    path (interceptors under `jax.eval_shape`), and the crop's dtype."""
    jdet = jax_factory("faster_rcnn", "vgg16", _config("bfloat16"))
    params = jax.eval_shape(jdet.init_params, jax.random.PRNGKey(0))
    seen, prefix = {}, [""]

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__":
            name = ".".join((prefix[0], *context.module.scope.path))
            seen.setdefault(name, []).append((_dt(args[0]), _dt(out)))
        return out

    def run(params, image):
        def apply(name, x, **kw):
            prefix[0] = name
            return getattr(jdet, name).apply({"params": params[name]}, x, **kw)

        with fnn.intercept_methods(interceptor):
            feats = apply("extractor", image)
            apply("rpn_head", feats)
            crop = jax_crop(feats[0], jnp.zeros((6, 4), jnp.float32).at[:, 2:].set(40.0),
                            jdet.stride, 7, True)
            apply("roi_head", crop, train=False)
        return crop

    crop = jax.eval_shape(run, params, jax.ShapeDtypeStruct((1, 128, 128, 3), jnp.float32))
    return seen, _dt(crop)


def _dt(x):
    if isinstance(x, (tuple, list)):
        return tuple(_dt(v) for v in x)
    return str(x.dtype).removeprefix("torch.")


def _bf16(flat):
    """The JAX VGG16 bf16 dtype map, and on one port bf16 detector from
    the bridged weights: the dtypes its modules take and give on the same
    path (forward hooks) and one training step."""
    want, want_crop = _jax_dtype_map()
    det = _port(flat, "bfloat16")
    got = {}

    def hook(name):
        def fn(mod, inputs, out):
            got.setdefault(name, []).append((_dt(inputs[0]), _dt(out)))
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in det.named_modules() if n]
    try:
        with torch.no_grad():
            image = torch.from_numpy(np.random.RandomState(0).randn(1, 128, 128, 3) * 40.0)
            det._detect(image.float(), torch.tensor([[120, 124]]))
            feats = torch.zeros(1, 8, 8, 512, dtype=torch.bfloat16)
            rois = torch.zeros(1, 6, 4)
            rois[..., 2:] = 40.0
            got_crop = _dt(roi_crop_faster_rcnn(feats, rois, 16, 7, True))
    finally:
        for h in handles:
            h.remove()
    opt = make_optimizer(det.cfg, det)
    metrics = make_train_step(det, opt)(_batch(1), torch.Generator().manual_seed(0))
    return dict(
        want=want, want_crop=want_crop, got=got, got_crop=got_crop,
        metrics={k: float(v) for k, v in metrics.items()},
        param_dtypes={p.dtype for p in det.parameters()},
        trace_dtypes={t.dtype for t in opt.trace.values()},
        fc1_grad=float(det.roi_head.fc1.weight.grad.abs().max()),
    )


@pytest.fixture(scope="module")
def bf16(tmp_path_factory, flat):
    return shared(tmp_path_factory, "torch_vgg16_bf16", lambda: _bf16(flat))


def test_bf16_dtype_of_every_stage_matches_jax(bf16):
    """Every flax submodule of the JAX VGG16 bf16 path has a port module of
    the same name whose every call takes and gives the same dtypes (flax's
    two `Dropout`s are functions of the port's head: they keep fc1's and
    fc2's bf16). The counterpart of tests/test_bf16.py's VGG16 case."""
    want, got = bf16["want"], bf16["got"]
    dropouts = {n: c for n, c in want.items() if "Dropout" in n}
    assert sorted(dropouts) == ["roi_head.Dropout_0", "roi_head.Dropout_1"]
    assert all(c == [("bfloat16", "bfloat16")] for c in dropouts.values())
    for name, calls in want.items():
        if name not in dropouts:
            assert got.get(name) == calls, name
    assert bf16["got_crop"] == bf16["want_crop"] == "float32"
    assert want["extractor.block5_conv3"][0] == ("bfloat16", "bfloat16")
    assert want["extractor"][0] == ("float32", "bfloat16")
    assert want["rpn_head.rpn_score_conv"][0] == ("bfloat16", "float32")
    assert want["roi_head.fc2"][0] == ("bfloat16", "bfloat16")
    assert want["roi_head.roi_head_score"][0] == ("bfloat16", "float32")
    assert want["roi_head"][0][1] == ("float32", "float32")


def test_bf16_training_step_is_finite_with_float32_state(bf16):
    assert all(np.isfinite(v) for v in bf16["metrics"].values())
    assert bf16["metrics"]["num_rpn_fg"] > 0
    assert bf16["param_dtypes"] == bf16["trace_dtypes"] == {torch.float32}
    assert bf16["fc1_grad"] > 0


# ------------------------------------------------------- checkpoints, npz
def test_port_npz_is_read_by_jax_and_predicts_the_same(serving):
    """A VGG16 `.npz` written by the port: JAX `load_params` reads every
    leaf bit for bit and JAX `predict` on it gives the port's detections."""
    assert serving["npz_keys_equal"] and serving["npz_leaves_unequal"] == []
    boxes, labels, scores, valid = serving["predict"]
    jb, jl, js, jv = serving["jax_predict_of_port_npz"]
    np.testing.assert_array_equal(jv, valid)
    np.testing.assert_array_equal(jl, labels)
    np.testing.assert_allclose(js, scores, **SCORE_TOL)
    np.testing.assert_allclose(jb, boxes, **BOX_TOL)


def test_jax_npz_loads_into_the_port(serving):
    """JAX `save_params` of the VGG16 tree fills every tensor of the port's
    detector (zeroed first) bit for bit."""
    assert serving["port_leaves_unequal"] == [] and serving["port_state_size"] == 40


def test_model_factory_refuses_fpn_vgg16_and_unknown_backbones():
    with pytest.raises(ValueError, match="vgg16"):
        model_factory("fpn", "vgg16", dict(config_factory("pascal", "fpn")), device="cpu")
    with pytest.raises(ValueError, match="resnet18"):
        model_factory("faster_rcnn", "resnet18", _config(), device="cpu")


# ---------------------------------------------------- trainer, command lines
TINY = ["scales=[2, 4, 8]", "rpn_proposal_train_pre_nms_sample_number=256",
        "rpn_proposal_train_after_nms_sample_number=64", "rpn_total_sample_number=64",
        "rpn_pos_sample_max_number=32", "roi_total_sample_number=32",
        "roi_pos_sample_max_number=8", "rpn_proposal_test_pre_nms_sample_number=100",
        "rpn_proposal_test_after_nms_sample_number=20", "tpu_image_buckets=[[128, 128]]",
        "image_min_size=128", "image_max_size=128"]


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    """4 trainval and 20 test procedural images (every class in the test
    split), their trainval TFRecords."""
    root = tmp_path_factory.mktemp("vgg16_voc")
    generate(str(root / "VOCdevkit" / "VOC2007"), n_train=4, n_test=20, seed=0)
    create_pascal_tf_records(str(root / "VOCdevkit"), "2007", "trainval",
                             str(root / "tfrecords"), num_shards=1)
    return root


def _tiny_config():
    from tf_eager_object_detection_tpu_torch.config.config_factory import apply_config_overrides
    return apply_config_overrides(dict(config_factory("pascal", "faster_rcnn")), TINY)


def _batches(voc, seed=0):
    from tf_eager_object_detection_tpu_torch.data.dataset_factory import dataset_factory
    return dataset_factory("pascal", "train", {
        "model_config": _tiny_config(), "batch_size": 1, "preprocessing_type": "tf",
        "tf_records_list": sorted(glob.glob(str(voc / "tfrecords" / "*.tfrecords"))),
        "seed": seed})


def _trainer_run(voc, logs):
    """Trainer A's first step draws from its generator (seeded seed + 1),
    its second from an injected `draws(step)`; it saves; Trainer B, built
    from another seed, restores; both take the same third step. The RoI
    head of A records the keep masks of every call."""
    cfg = _tiny_config()
    a = (128 // 16) ** 2 * 9

    def draws(step):
        return TrainDraws.sample(torch.Generator().manual_seed(100 + step), 1, a, 64, 32,
                                 (0.5, VGG16_HIDDEN))

    det = model_factory("faster_rcnn", "vgg16", cfg, device="cpu")
    trainer = Trainer(det, str(logs), logging_every_n_steps=1000, summary_every_n_steps=1000,
                      saving_every_n_steps=1000, seed=4)
    seen = []
    forward = det.roi_head.forward

    def recording(x, keep=None):
        seen.append(keep)
        return forward(x, keep)

    det.roi_head.forward = recording
    batches = _batches(voc)
    trainer.train_one_epoch(batches, steps=1)
    trainer.draws = draws
    trainer.train_one_epoch(batches, steps=1)
    want = TrainDraws.sample(torch.Generator().manual_seed(5), 1, a, 64, 32, det.roi_dropout)
    out = {"calls": len(seen), "generator_masks": torch.equal(seen[0], want.dropout_keep),
           "injected_masks": torch.equal(seen[1], draws(2).dropout_keep)}
    trainer.ckpt.save(det, trainer.optimizer)
    batch = next(iter(_batches(voc, seed=9)))
    runs = []
    for t in (trainer, Trainer(model_factory("faster_rcnn", "vgg16", cfg, device="cpu", seed=7),
                               str(logs), seed=7, draws=draws)):
        out.setdefault("steps", []).append(t.step)
        m = t.step_fn(t._to_device(batch), draws(3))
        runs.append(({k: float(v) for k, v in m.items()},
                     {n: p.detach().clone() for n, p in t.det.named_parameters()},
                     {n: v.clone() for n, v in t.optimizer.trace.items()}))
        t.close()
    (m0, p0, t0), (m1, p1, t1) = runs
    out["metrics"] = (m0, m1)
    out["params_equal"] = all(torch.equal(p0[n], p1[n]) for n in p0)
    out["traces_equal"] = t0.keys() == t1.keys() and all(torch.equal(t0[n], t1[n]) for n in t0)
    return out


@pytest.fixture(scope="module")
def trainer_run(tmp_path_factory, voc):
    return shared(tmp_path_factory, "torch_vgg16_trainer_run",
                  lambda: _trainer_run(voc, tmp_path_factory.mktemp("vgg16_trainer")))


def test_trainer_generator_draws_the_dropout_masks(trainer_run):
    """The Trainer's generator (seeded seed + 1) draws each step's keep
    masks with the samplers' numbers, [2, B * S, 4096]."""
    assert trainer_run["calls"] == 2 and trainer_run["generator_masks"]


def test_trainer_injected_draws_carry_the_masks(trainer_run):
    assert trainer_run["injected_masks"]


def test_restored_trainer_repeats_a_step_bit_for_bit(trainer_run):
    """A Trainer restored from the checkpoint takes the next step as the one
    that saved it: losses, parameters and momentum traces bit for bit."""
    assert trainer_run["steps"] == [2, 2]
    m0, m1 = trainer_run["metrics"]
    assert m0 == m1 and all(np.isfinite(v) for v in m0.values())
    assert trainer_run["params_equal"] and trainer_run["traces_equal"]


def test_train_cli_vgg16_two_steps_then_eval_pascal(voc, tmp_path, capsys):
    logs = str(tmp_path / "logs")
    args = ["--model_type", "faster_rcnn", "--backbone", "vgg16", "--tf_records_dir",
            str(voc / "tfrecords"), "--logs_dir", logs, "--epochs", "1", "--steps_per_epoch",
            "2", "--logging_every_n_steps", "1", "--device", "cpu", "--preprocessing_type", "tf"]
    for ov in TINY:
        args += ["--config_override", ov]
    train_cli.main(args)
    out = capsys.readouterr().out
    assert "epoch finished: 2 steps" in out and "step 2 lr=" in out
    assert "ckpt_00000002.pt" in os.listdir(logs)
    eval_args = [logs, "--root_path", str(voc / "VOCdevkit" / "VOC2007"), "--model_type",
                 "faster_rcnn", "--backbone", "vgg16", "--device", "cpu", "--batch_size", "2",
                 "--result_dir", str(tmp_path / "results"), "--preprocessing_type", "tf"]
    for ov in TINY:
        eval_args += ["--config_override", ov]
    aps = eval_pascal.main(eval_args)
    assert len(aps) == 20 and all(0.0 <= ap <= 1.0 for ap in aps)
    assert "mAP =" in capsys.readouterr().out
