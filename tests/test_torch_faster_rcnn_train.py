"""One Faster R-CNN ResNet-50 (C4) training step of the port against the JAX `loss_fn`, on the CPU.

Bridged weights (JAX `init_params`, the RPN score layer scaled by 20 so
that random-weight proposals separate), a 128x128 bucket, anchor scales
(2, 4, 8) so that anchors of 32-128 px fit inside the images (the stock
(8, 16, 32) gives 128-512 px anchors, none inside a 128x128 image, and no
RPN sample), small proposal and sample counts, one and two images. The port
gets the JAX draws: JAX `loss_fn` splits its key into b + 1 keys (the last
for dropout, which the conv5 head does not use), so the test rebuilds
`split(key, b + 1)[:b]`, then each image's split and the samplers' own
splits, and hands the port the same uniform priorities and Gumbel noise.
Neither framework runs a Pallas kernel on this path: JAX crops with its
einsum `roi_crop_faster_rcnn`, the port with its two matmuls and autograd.
Tolerances, with their reasons (those of tests/test_torch_fpn_train.py):

- losses rtol 1e-4 (convolutions and reductions sum in another order);
  counts exact; the RPN scores separate at the pre-NMS cut (asserted), so
  both frameworks keep the same proposals;
- gradients: every trainable tensor within GRAD_TOL = 2e-3 of its largest
  absolute value, elementwise. A float32 gradient of a 50-layer network
  sums in another order at every layer; the observed worst case is given
  in `test_gradients_match_jax`;
- parameters after one momentum step atol 1e-6 (lr 1e-3 times the
  gradient's tolerance), the momentum trace as the gradient;
- the frozen conv1 and conv2 stack (the C4 freeze policy) takes no
  gradient and is unchanged, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from tf_eager_object_detection_tpu.models.model_factory import model_factory as jax_factory
from tf_eager_object_detection_tpu.training.optimizer import make_optimizer as jax_optimizer
from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
from tf_eager_object_detection_tpu_torch.core.anchors import valid_anchor_mask
from tf_eager_object_detection_tpu_torch.models.heads import reshuffle_frcnn_scores
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.ops.sampling import TrainDraws
from tf_eager_object_detection_tpu_torch.ref_import.from_jax import (
    load_jax_params,
    parameter_tree_from_jax,
)
from tf_eager_object_detection_tpu_torch.training.optimizer import make_optimizer
from tf_eager_object_detection_tpu_torch.training.train_step import make_train_step
from torch_shared import jax_init

GRAD_TOL = 2e-3
RPN_SCORE_SCALE = 20.0
BATCHES = [1, 2]
KEY = 11
PRE_NMS, POST_NMS, ROI_SAMPLES = 256, 64, 32


def _config():
    cfg = dict(config_factory("pascal", "faster_rcnn"))
    cfg.update(
        scales=[2, 4, 8],
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


def _batch(b):
    rng = np.random.RandomState(0)
    images = rng.randn(2, 128, 128, 3).astype(np.float32)
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


def jax_draws(key, b, a, r, s) -> TrainDraws:
    """The random numbers JAX Faster R-CNN `loss_fn` draws from `key`: its
    split into b + 1 keys, of which the first b go to the images, then each
    image's split and `anchor_target`'s and `proposal_target`'s own splits
    (the with-replacement draw is `categorical`, the argmax of this Gumbel
    noise plus its logits)."""
    out = []
    for rng_i in jax.random.split(key, b + 1)[:b]:
        r_at, r_pt = jax.random.split(rng_i)
        k_fg, k_bg = jax.random.split(r_at)
        p_fg, p_bg, p_wr = jax.random.split(r_pt, 3)
        out.append([jax.random.uniform(k_fg, (a,)), jax.random.uniform(k_bg, (a,)),
                    jax.random.uniform(p_fg, (r,)), jax.random.uniform(p_bg, (r,)),
                    jax.random.gumbel(p_wr, (s, r))])
    return TrainDraws(*(torch.from_numpy(np.stack([np.asarray(x) for x in f])) for f in zip(*out)))


@pytest.fixture(scope="module")
def flat(tmp_path_factory):
    return jax_init(tmp_path_factory, "faster_rcnn", RPN_SCORE_SCALE)


_JAX, _PORT = {}, {}


def jax_step(flat, b):
    """JAX loss, gradients and one fused-momentum step (module cache)."""
    if b not in _JAX:
        cfg = _config()
        jdet = jax_factory("faster_rcnn", "resnet50", cfg)
        params = jax.tree_util.tree_map(jnp.asarray, unflatten_dict(flat, sep="/"))
        batch = [jnp.asarray(a) for a in _batch(b)]

        def loss(p):
            return jdet.loss_fn(p, *batch, jax.random.PRNGKey(KEY))

        (total, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        opt = jax_optimizer(cfg, params, "resnet50", "faster_rcnn")
        updates, state = opt.update(grads, opt.init(params), params)
        new_params = optax.apply_updates(params, updates)

        def flat_np(tree):
            return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}

        _JAX[b] = dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads=flat_np(grads), params=flat_np(new_params), trace=flat_np(state.trace),
        )
    return _JAX[b]


def port_step(flat, b):
    """The port's train step from the bridged weights with JAX's draws (module cache)."""
    if b not in _PORT:
        cfg = _config()
        det = model_factory("faster_rcnn", "resnet50", cfg, device="cpu")
        load_jax_params(det, flat)
        before = {n: p.detach().clone() for n, p in det.named_parameters()}
        opt = make_optimizer(cfg, det)
        a = (128 // 16) ** 2 * det.num_anchors
        draws = jax_draws(jax.random.PRNGKey(KEY), b, a, POST_NMS, ROI_SAMPLES)
        images, hw = _batch(b)[:2]
        with torch.no_grad():  # the RPN foreground probabilities, for the premise
            _, score_map, _ = det._backbone_rpn(torch.from_numpy(images))
            probs = reshuffle_frcnn_scores(score_map, det.num_anchors)
            cells = torch.from_numpy(-(-hw.astype(np.int64) // 16))
            valid = valid_anchor_mask(8, 8, det.num_anchors, cells[:, 0], cells[:, 1])
            probs = torch.where(valid, probs, torch.full_like(probs, -1.0))
        metrics = make_train_step(det, opt)(_batch(b), draws)
        _PORT[b] = dict(
            probs=probs.numpy(),
            metrics={k: float(v) for k, v in metrics.items()},
            grads={n: p.grad.numpy().copy() for n, p in det.named_parameters()
                   if p.grad is not None},
            frozen={n for n, p in det.named_parameters() if not p.requires_grad},
            before={n: t.numpy() for n, t in before.items()},
            params={n: p.detach().numpy().copy() for n, p in det.named_parameters()},
            trace={n: t.numpy().copy() for n, t in opt.trace.items()},
        )
    return _PORT[b]


@pytest.mark.parametrize("b", BATCHES)
def test_losses_and_counts_match_jax(flat, b):
    ref = jax_step(flat, b)
    got = port_step(flat, b)
    assert set(got["metrics"]) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        if k.startswith("num_"):
            assert got["metrics"][k] == v, k
        else:
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4, err_msg=k)
    assert ref["metrics"]["num_roi_fg"] > 0 and ref["metrics"]["num_rpn_fg"] > 0
    # the premise: the RPN scores of the valid anchors separate at the pre-NMS cut
    for probs in got["probs"]:
        p = np.sort(probs)[::-1]
        assert p[PRE_NMS - 1] - p[PRE_NMS] > 1e-4


@pytest.mark.parametrize("b", BATCHES)
def test_gradients_match_jax(flat, b):
    """Observed worst case 8.8e-4 of a tensor's largest value
    (`roi_head.conv5_block1_3_conv.weight`, B = 1; 2.6e-4 at B = 2)."""
    want = parameter_tree_from_jax(jax_step(flat, b)["grads"])
    got = port_step(flat, b)["grads"]
    frozen = port_step(flat, b)["frozen"]
    assert set(got) == set(want) - frozen
    for name, w in want.items():
        w = w.numpy()
        if name in frozen:
            continue
        np.testing.assert_allclose(got[name], w, rtol=0, atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=name)
    # the RoI branch reaches the backbone through the crop's matmuls
    assert np.abs(got["roi_head.roi_head_score.weight"]).max() > 0
    assert np.abs(got["extractor.conv4_block6_3_conv.weight"]).max() > 0


@pytest.mark.parametrize("b", BATCHES)
def test_params_and_momentum_after_one_step_match_jax(flat, b):
    ref = jax_step(flat, b)
    got = port_step(flat, b)
    want_params = parameter_tree_from_jax(ref["params"])
    want_trace = parameter_tree_from_jax(ref["trace"])
    assert got["params"].keys() == want_params.keys()
    assert set(got["trace"]) == set(got["params"]) - got["frozen"]
    for name, w in want_params.items():
        np.testing.assert_allclose(got["params"][name], w.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    for name, t in got["trace"].items():
        w = want_trace[name].numpy()
        np.testing.assert_allclose(t, w, rtol=0, atol=GRAD_TOL * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("b", BATCHES)
def test_frozen_conv1_and_conv2_unchanged(flat, b):
    """The C4 freeze policy: every conv1 / conv2 parameter of the backbone
    (and nothing else) is frozen, takes no gradient and keeps its bits."""
    got = port_step(flat, b)
    layers = {n.split(".")[1].split("_")[0] for n in got["frozen"]}
    assert layers == {"conv1", "conv2"} and all(n.startswith("extractor.") for n in got["frozen"])
    for name in got["frozen"]:
        np.testing.assert_array_equal(got["params"][name], got["before"][name], err_msg=name)


def test_training_step_after_serving_on_one_detector():
    """Serving fills the anchor cache under `torch.inference_mode`; a
    training step on the same detector must still build its backward."""
    cfg = _config()
    det = model_factory("faster_rcnn", "resnet50", cfg, device="cpu", seed=2)
    images, hw, gt, mask, labels = _batch(1)
    det.predict(images[0], hw[0])
    metrics = make_train_step(det, make_optimizer(cfg, det))((images, hw, gt, mask, labels),
                                                              torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert float(det.extractor.conv3_block1_1_conv.weight.grad.abs().max()) > 0
