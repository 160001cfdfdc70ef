"""One FPN ResNet-50 training step of the port against the JAX `loss_fn`, on the CPU.

Bridged weights (JAX `init_params`, the RPN score layer scaled by 20 so
that random-weight proposals separate), a 128x128 bucket, small proposal
and sample counts, two images. The port gets the JAX draws: the test
rebuilds JAX's key splits (`loss_fn`'s split per image, then the
samplers' splits) and hands the port the same uniform priorities and
Gumbel noise. JAX runs its default einsum RoIAlign and, with
`tpu_roi_align_impl='pallas_interpret'`, the Pallas kernels K4 and K5 in
interpret mode; the port runs the plain RoIAlign and its autograd. B = 1
and B = 2. Tolerances, with their reasons:

- losses rtol 1e-4 (convolutions and reductions sum in another order);
  counts exact; the RPN scores separate at the pre-NMS cut (asserted), so
  both frameworks keep the same proposals;
- gradients: every trainable tensor within GRAD_TOL = 2e-3 of its largest
  absolute value, elementwise. A float32 gradient of a 50-layer network
  sums in another order at every layer, and the RPN's regression gradient
  is 1/256 of a box delta that itself differs by ~1e-6 between the two;
  the observed worst case is given in `test_gradients_match_jax`;
- parameters after one momentum step atol 1e-6 (lr 1e-3 times the
  gradient's tolerance), the momentum trace as the gradient.

The port's fused (K4 / K5) and per-level (K2 / K3) RoIAlign give the same
step: losses rtol 1e-6, gradients within 1e-5 of their largest value.
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
IMPLS = ["einsum", "pallas_interpret"]
BATCHES = [1, 2]
KEY = 7


def _config():
    cfg = dict(config_factory("pascal", "fpn"))
    cfg.update(
        rpn_proposal_train_pre_nms_sample_number=512,
        rpn_proposal_train_after_nms_sample_number=64,
        rpn_total_sample_number=64,
        rpn_pos_sample_max_number=32,
        roi_total_sample_number=32,
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
    """The random numbers JAX `loss_fn` draws from `key`: its per-image
    split, then `anchor_target`'s and `proposal_target`'s own splits (the
    with-replacement draw is `categorical`, the argmax of this Gumbel
    noise plus its logits)."""
    out = []
    for rng_i in jax.random.split(key, b):
        r_at, r_pt = jax.random.split(rng_i)
        k_fg, k_bg = jax.random.split(r_at)
        p_fg, p_bg, p_wr = jax.random.split(r_pt, 3)
        out.append([jax.random.uniform(k_fg, (a,)), jax.random.uniform(k_bg, (a,)),
                    jax.random.uniform(p_fg, (r,)), jax.random.uniform(p_bg, (r,)),
                    jax.random.gumbel(p_wr, (s, r))])
    return TrainDraws(*(torch.from_numpy(np.stack([np.asarray(x) for x in f])) for f in zip(*out)))


@pytest.fixture(scope="module")
def flat(tmp_path_factory):
    return jax_init(tmp_path_factory, "fpn", RPN_SCORE_SCALE)


_JAX, _PORT = {}, {}


def jax_step(flat, impl, b):
    """JAX loss, gradients and one fused-momentum step (module cache)."""
    if (impl, b) not in _JAX:
        cfg = dict(_config(), tpu_roi_align_impl=impl)
        jdet = jax_factory("fpn", "resnet50", cfg)
        params = jax.tree_util.tree_map(jnp.asarray, unflatten_dict(flat, sep="/"))
        batch = [jnp.asarray(a) for a in _batch(b)]

        def loss(p):
            return jdet.loss_fn(p, *batch, jax.random.PRNGKey(KEY))

        (total, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        opt = jax_optimizer(cfg, params, "resnet50", "fpn")
        updates, state = opt.update(grads, opt.init(params), params)
        new_params = optax.apply_updates(params, updates)

        def flat_np(tree):
            return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}

        _JAX[impl, b] = dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads=flat_np(grads), params=flat_np(new_params), trace=flat_np(state.trace),
        )
    return _JAX[impl, b]


def port_step(flat, b, fused=True):
    """The port's train step from the bridged weights with JAX's draws (module cache)."""
    if (b, fused) not in _PORT:
        cfg = dict(_config(), tpu_roi_align_fused_levels=fused)
        det = model_factory("fpn", "resnet50", cfg, device="cpu")
        load_jax_params(det, flat)
        opt = make_optimizer(cfg, det)
        a = 3 * sum((128 // s) ** 2 for s in cfg["anchor_stride_list"])
        draws = jax_draws(jax.random.PRNGKey(KEY), b, a, 64, 32)
        with torch.no_grad():  # the RPN foreground probabilities, for the premise
            scores2 = det._flatten_levels(*det._backbone_neck_rpn(torch.from_numpy(_batch(b)[0]))[1:])[0]
        metrics = make_train_step(det, opt)(_batch(b), draws)
        _PORT[b, fused] = dict(
            probs=torch.softmax(scores2, dim=-1)[..., 1].numpy(),
            metrics={k: float(v) for k, v in metrics.items()},
            grads={n: p.grad.numpy().copy() for n, p in det.named_parameters()},
            params={n: p.detach().numpy().copy() for n, p in det.named_parameters()},
            trace={n: t.numpy().copy() for n, t in opt.trace.items()},
        )
    return _PORT[b, fused]


def test_jax_categorical_is_argmax_of_the_gumbel_draw():
    """The premise of `jax_draws`: `categorical(key, logits, shape=(S,))` is
    argmax(gumbel(key, (S, R)) + logits)."""
    key = jax.random.PRNGKey(3)
    logits = jnp.where(jnp.arange(50) % 3 == 0, 0.0, -jnp.inf)
    got = jax.random.categorical(key, logits, shape=(40,))
    want = jnp.argmax(jax.random.gumbel(key, (40, 50)) + logits, axis=-1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("impl", IMPLS)
def test_losses_and_counts_match_jax(flat, impl, b):
    ref = jax_step(flat, impl, b)
    got = port_step(flat, b)
    assert set(got["metrics"]) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        if k.startswith("num_"):
            assert got["metrics"][k] == v, k
        else:
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4, err_msg=k)
    assert ref["metrics"]["num_roi_fg"] > 0 and ref["metrics"]["num_rpn_fg"] > 0
    # the premise: the RPN scores separate at the pre-NMS cut
    for probs in got["probs"]:
        p = np.sort(probs)[::-1]
        assert p[511] - p[512] > 1e-4


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("impl", IMPLS)
def test_gradients_match_jax(flat, impl, b):
    """Observed worst case 3.7e-4 of a tensor's largest value
    (`neck.build_p2.weight`, both RoIAlign paths of JAX, B = 1 and 2)."""
    want = parameter_tree_from_jax(jax_step(flat, impl, b)["grads"])
    got = port_step(flat, b)["grads"]
    assert got.keys() == want.keys()
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[name], w, rtol=0, atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=name)
    # the RoI branch reaches the pyramid: the head and the neck have gradients
    assert np.abs(got["roi_head.fc1.weight"]).max() > 0
    assert np.abs(got["neck.build_p2.weight"]).max() > 0


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("impl", IMPLS)
def test_params_and_momentum_after_one_step_match_jax(flat, impl, b):
    ref = jax_step(flat, impl, b)
    got = port_step(flat, b)
    want_params = parameter_tree_from_jax(ref["params"])
    want_trace = parameter_tree_from_jax(ref["trace"])
    assert got["trace"].keys() == want_trace.keys() == got["params"].keys()
    for name, w in want_params.items():
        np.testing.assert_allclose(got["params"][name], w.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    for name, w in want_trace.items():
        w = w.numpy()
        np.testing.assert_allclose(got["trace"][name], w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(), err_msg=name)


def test_training_step_after_serving_on_one_detector():
    """Serving fills the detector's caches (anchors, the neck's resize
    matrices) under `torch.inference_mode`; a training step on the same
    detector must still build its backward through them."""
    cfg = _config()
    det = model_factory("fpn", "resnet50", cfg, device="cpu", seed=2)
    images, hw, gt, mask, labels = _batch(1)
    det.predict(images[0], hw[0])
    metrics = make_train_step(det, make_optimizer(cfg, det))((images, hw, gt, mask, labels),
                                                              torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert det.neck.build_p2.weight.grad is not None
    assert float(det.neck.build_p2.weight.grad.abs().max()) > 0


@pytest.mark.parametrize("b", BATCHES)
def test_fused_and_per_level_roi_align_give_the_same_step(flat, b):
    fused, per_level = port_step(flat, b, fused=True), port_step(flat, b, fused=False)
    for k, v in fused["metrics"].items():
        np.testing.assert_allclose(per_level["metrics"][k], v, rtol=1e-6, err_msg=k)
    for name, g in fused["grads"].items():
        np.testing.assert_allclose(per_level["grads"][name], g, rtol=0,
                                   atol=1e-5 * np.abs(g).max(), err_msg=name)
