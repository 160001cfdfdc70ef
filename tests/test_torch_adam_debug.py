"""The port's Adam training steps, `with_probe`, the debug entry points and
`test_one_image` (the `infer` repair) against the JAX package's, on the CPU.

Weights: the shared JAX `init_params` of C4 and FPN ResNet-50 with the RPN
score layer x20 (`torch_shared.jax_init`), bridged into the port; sizes,
batches and draws of tests/test_torch_faster_rcnn_train.py and
tests/test_torch_fpn_train.py (128x128, B=1, the JAX draws rebuilt from
their keys).

- Adam (`optimizer_type='adam'`, the configs' learning rates): two steps
  of JAX `make_train_step(..., with_probe=True)` over its optax chain
  (decay, bias x2, `optax.adam`, frozen -> 0), jitted once and run twice
  per model (one test each), against
  two steps of the port's `make_train_step(..., with_probe=True)` with the
  same draws. Losses within rtol 1e-4, counts exact and `probe` within
  1e-5 * sum |p| of JAX's (a float32 sum over every parameter and
  statistic, in another order) at both steps. Adam's first update is
  lr * u / (|u| + eps), about lr * sign(g): wherever the two frameworks'
  gradients may differ in sign, it may differ by up to 2 * lr. The
  training parity tests hold the gradients within GRAD_TOL = 2e-3 of a
  tensor's largest |g|, and measured sign flips reach up to there: at
  |g| > 1e-4 of the largest, C4's conv5 and FPN's conv2 / conv3 updates
  differed by up to 1.9-2.0 * lr, at 1e-3 still FPN's conv4 by 1.6 * lr
  (measured on these inputs with the thresholds set to 1e-4 and 1e-3).
  So the first update is held within 1e-3 * lr of JAX's wherever |g|
  exceeds GRAD_TOL of its tensor's largest (the share of such elements
  and the worst case are printed), and within 2 * lr everywhere; frozen
  parameters keep their bits. The second step starts from JAX's
  parameters after the first, so that it compares the optimizer's second
  step (moments, bias correction at count 2) and not the first step's
  sign flips amplified through a random network: the first and second
  moments after it are within 1e-2 of their tensor's largest value (the
  bound of the momentum traces in tests/test_torch_trainer.py).
- `predict_rpn` / `predict_roi` (C4) and `predict_rpns` / `predict_rois`
  (FPN), fed JAX's draws of the same key: the same anchors and positive
  masks, the same sampled labels and validity, rois and targets within
  1e-4.
- `test_one_image` on a 300x400 TGA written by PIL (cv2 cannot decode it;
  both packages fall back to PIL): the same labels, boxes within 1e-3 px
  and scores within 1e-5 of JAX's `test_one_image` on the bridged weights
  (with "tf" preprocessing: pixels in [-1, 1], the scale the random init
  is made for); the port's data reader still raises
  IOError on it, and `infer` prints and draws the detections.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from tf_eager_object_detection_tpu.models.model_factory import model_factory as jax_factory
from tf_eager_object_detection_tpu.training.optimizer import make_optimizer as jax_optimizer
from tf_eager_object_detection_tpu.training.train_step import TrainState
from tf_eager_object_detection_tpu.training.train_step import make_train_step as jax_train_step
from tf_eager_object_detection_tpu_torch.data import pascal
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.ops.sampling import TrainDraws
from tf_eager_object_detection_tpu_torch.ref_import.from_jax import (
    load_jax_params,
    parameter_tree_from_jax,
)
from tf_eager_object_detection_tpu_torch.training.checkpoints import save_params
from tf_eager_object_detection_tpu_torch.training.optimizer import AdamOptimizer, make_optimizer
from tf_eager_object_detection_tpu_torch.training.train_step import make_train_step

import test_torch_faster_rcnn_train as c4_train
import test_torch_fpn_train as fpn_train
from torch_shared import jax_init

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ["faster_rcnn", "fpn"]
TRAIN = {"faster_rcnn": c4_train, "fpn": fpn_train}
KEYS = (11, 12)
GRAD_TOL = 2e-3
MOMENT_TOL = 1e-2
PROBE_TOL = 1e-5


@pytest.fixture
def tmp_path(tmp_path):
    """A test's checkpoints and images go as soon as it ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _config(model_type, **extra):
    return dict(TRAIN[model_type]._config(), optimizer_type="adam", **extra)


def _anchors(model_type, cfg):
    if model_type == "fpn":
        return 3 * sum((128 // s) ** 2 for s in cfg["anchor_stride_list"])
    return (128 // 16) ** 2 * 3 * len(cfg["scales"])


def _draws(model_type, key, cfg, b=1):
    return TRAIN[model_type].jax_draws(
        jax.random.PRNGKey(key), b, _anchors(model_type, cfg),
        cfg["rpn_proposal_train_after_nms_sample_number"], cfg["roi_total_sample_number"])


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _adam_state(opt_state):
    """The ScaleByAdamState inside JAX's optax chain."""
    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "nu")):
        if hasattr(leaf, "nu"):
            return leaf
    raise AssertionError("no Adam state in the chain")


def _jax_adam_steps(model_type, flat, cfg, batch):
    """JAX's two Adam steps (`make_train_step(..., with_probe=True)`, jitted
    once): each step's metrics, the first step's parameters and the
    second's moments."""
    jdet = jax_factory(model_type, "resnet50", cfg)
    params = jax.tree_util.tree_map(jnp.asarray, unflatten_dict(flat, sep="/"))
    opt = jax_optimizer(cfg, params, "resnet50", model_type)
    step = jax_train_step(jdet, opt, with_probe=True)
    state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    out = []
    for i, key in enumerate(KEYS):
        state, metrics = step(state, [jnp.asarray(a) for a in batch], jax.random.PRNGKey(key))
        adam = _adam_state(state.opt_state)
        out.append(dict(metrics={k: float(v) for k, v in metrics.items()},
                        **({"params": _flat_np(state.params)} if i == 0 else
                           {"mu": _flat_np(adam.mu), "nu": _flat_np(adam.nu)})))
    return out


@pytest.mark.parametrize("model_type", MODELS)
def test_adam_two_steps_match_jax(tmp_path_factory, model_type):
    """Losses, counts and `probe` at both steps; the first update; frozen
    parameters; the moments after the second step, taken from JAX's
    parameters (see the module's docstring for the tolerances)."""
    flat = jax_init(tmp_path_factory, model_type, 20.0)
    cfg = _config(model_type)
    batch = TRAIN[model_type]._batch(1)
    want = _jax_adam_steps(model_type, flat, cfg, batch)

    det = model_factory(model_type, "resnet50", cfg, device="cpu")
    load_jax_params(det, flat)
    start = {n: p.detach().clone().numpy() for n, p in det.named_parameters()}
    frozen = {n for n, p in det.named_parameters() if not p.requires_grad}
    assert bool(frozen) == (model_type == "faster_rcnn")
    opt = make_optimizer(cfg, det)
    assert isinstance(opt, AdamOptimizer)
    step = make_train_step(det, opt, with_probe=True)
    lr = opt.lr
    for i, key in enumerate(KEYS):
        got = {k: float(v) for k, v in step(batch, _draws(model_type, key, cfg)).items()}
        ref = want[i]["metrics"]
        assert set(got) == set(ref) and "probe" in ref
        for k, v in ref.items():
            if k.startswith("num_"):
                assert got[k] == v, (i, k)
            elif k == "probe":
                abs_sum = float(sum(t.abs().double().sum() for t in det.state_dict().values()))
                assert abs(got[k] - v) <= PROBE_TOL * abs_sum, (i, got[k], v)
            else:
                np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=f"step {i} {k}")
        if i == 0:
            assert ref["num_rpn_fg"] > 0 and ref["num_roi_fg"] > 0
            _check_first_update(model_type, det, start, frozen, want[0]["params"], lr)
            load_jax_params(det, want[0]["params"])  # the second step from JAX's parameters
    for slot in ("mu", "nu"):
        theirs = parameter_tree_from_jax(want[1][slot])
        mine = getattr(opt, slot)
        assert set(mine) == set(theirs) - frozen
        for name in frozen:
            assert not theirs[name].any()
        for name, m in mine.items():
            w = theirs[name].numpy()
            np.testing.assert_allclose(m.numpy(), w, rtol=0, atol=MOMENT_TOL * np.abs(w).max(),
                                       err_msg=f"{slot} {name}")


def _check_first_update(model_type, det, start, frozen, jax_params, lr):
    theirs = parameter_tree_from_jax(jax_params)
    worst, covered, total = (0.0, ""), 0, 0
    for name, p in det.named_parameters():
        p = p.detach().numpy()
        if name in frozen:
            np.testing.assert_array_equal(p, start[name], err_msg=name)
            np.testing.assert_array_equal(theirs[name].numpy(), start[name], err_msg=name)
            continue
        diff = np.abs((p - start[name]) - (theirs[name].numpy() - start[name]))
        g = np.abs(det.get_parameter(name).grad.numpy())
        sure = g > GRAD_TOL * g.max()
        assert diff.max() <= 2 * lr, (name, float(diff.max()) / lr)
        if sure.any():
            worst = max(worst, (float(diff[sure].max()) / lr, name))
            assert diff[sure].max() <= 1e-3 * lr, (name, float(diff[sure].max()) / lr)
        covered, total = covered + int(sure.sum()), total + g.size
    print(f"{model_type}: first Adam update within {worst[0]:.3g} * lr of JAX's ({worst[1]}) "
          f"on the {covered / total:.4f} of elements with |g| > {GRAD_TOL} of the tensor's largest")


# -------------------------------------------------------------- debug APIs
def _debug_config(model_type):
    return dict(TRAIN[model_type]._config(), rpn_proposal_test_pre_nms_sample_number=512,
                rpn_proposal_test_after_nms_sample_number=64)


def _one_image_draws(key, a, r, s):
    """JAX's draws of `predict_rpn(s)` (`anchor_target`'s split of the key)
    and of `predict_roi(s)` (`proposal_target`'s), as a TrainDraws of one
    image."""
    k_fg, k_bg = jax.random.split(key)
    p_fg, p_bg, p_wr = jax.random.split(key, 3)
    fields = [jax.random.uniform(k_fg, (a,)), jax.random.uniform(k_bg, (a,)),
              jax.random.uniform(p_fg, (r,)), jax.random.uniform(p_bg, (r,)),
              jax.random.gumbel(p_wr, (s, r))]
    return TrainDraws(*(torch.from_numpy(np.array(f))[None] for f in fields))


@pytest.mark.parametrize("model_type", MODELS)
def test_debug_apis_match_jax(tmp_path_factory, model_type):
    flat = jax_init(tmp_path_factory, model_type, 20.0)
    cfg = _debug_config(model_type)
    images, hw, gt, mask, labels = TRAIN[model_type]._batch(1)
    args = (images[0], hw[0], gt[0], mask[0])
    jdet = jax_factory(model_type, "resnet50", cfg)
    params = jax.tree_util.tree_map(jnp.asarray, unflatten_dict(flat, sep="/"))
    det = model_factory(model_type, "resnet50", cfg, device="cpu")
    load_jax_params(det, flat)
    key = jax.random.PRNGKey(21)
    phase = "train" if model_type == "faster_rcnn" else "test"  # as JAX takes the proposals
    draws = _one_image_draws(key, _anchors(model_type, cfg),
                             cfg[f"rpn_proposal_{phase}_after_nms_sample_number"],
                             cfg["roi_total_sample_number"])
    rpn, roi = (("predict_rpn", "predict_roi") if model_type == "faster_rcnn"
                else ("predict_rpns", "predict_rois"))
    j_anchors, j_pos = jax.jit(getattr(jdet, rpn))(params, *map(jnp.asarray, args), key)
    anchors, pos = getattr(det, rpn)(*args, draws)
    np.testing.assert_allclose(anchors.numpy(), np.asarray(j_anchors), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(j_pos))
    assert pos.any()
    want = jax.jit(getattr(jdet, roi))(params, *map(jnp.asarray, args), jnp.asarray(labels[0]),
                                       key)
    got = getattr(det, roi)(*args, labels[0], draws)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert (got.labels > 0).any()
    for field in ("rois", "bbox_targets", "in_weights", "out_weights"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=0, atol=1e-4, err_msg=field)


# ------------------------------------------------------- test_one_image (infer)
INFER_OVERRIDES = ["rpn_proposal_test_pre_nms_sample_number=300",
                   "rpn_proposal_test_after_nms_sample_number=50",
                   "tpu_image_buckets=[[128, 128]]", "image_min_size=128",
                   "image_max_size=128", "max_objects_per_image=10",
                   "max_objects_per_class_per_image=10"]


def test_infer_reads_a_tga_as_jax_does(tmp_path_factory, tmp_path):
    from PIL import Image

    from tf_eager_object_detection_tpu_torch.config.config_factory import (
        apply_config_overrides,
        config_factory,
    )

    rng = np.random.RandomState(4)
    yy, xx = np.mgrid[0:300, 0:400]
    img = np.stack([xx * 0.6, yy * 0.8, (xx + yy) * 0.3], -1) + rng.normal(0, 20, (300, 400, 3))
    path = str(tmp_path / "image.tga")
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path)
    with pytest.raises(IOError):
        pascal._read_image(path)  # the data iterators do not fall back, as in JAX

    flat = dict(jax_init(tmp_path_factory, "faster_rcnn", 20.0))
    flat["roi_head/roi_head_score/kernel"] = flat["roi_head/roi_head_score/kernel"] * 10.0
    cfg = apply_config_overrides(dict(config_factory("pascal", "faster_rcnn")), INFER_OVERRIDES)
    jdet = jax_factory("faster_rcnn", "resnet50", cfg)
    params = jax.tree_util.tree_map(jnp.asarray, unflatten_dict(flat, sep="/"))
    det = model_factory("faster_rcnn", "resnet50", cfg, device="cpu")
    load_jax_params(det, flat)
    jb, jl, js = jdet.test_one_image(params, path, preprocessing_type="tf")
    boxes, labels, scores = det.test_one_image(path, preprocessing_type="tf")
    assert len(jl) > 0
    np.testing.assert_array_equal(labels, np.asarray(jl))
    np.testing.assert_allclose(boxes, np.asarray(jb), rtol=0, atol=1e-3)
    np.testing.assert_allclose(scores, np.asarray(js), rtol=0, atol=1e-5)
    assert boxes.max() > 128  # on the raw 300x400 image's coordinates

    ckpt = str(tmp_path / "params.npz")
    save_params(ckpt, det)
    out = str(tmp_path / "dets.png")
    cmd = [sys.executable, "-m", "tf_eager_object_detection_tpu_torch.scripts.infer", ckpt, path,
           "--out", out, "--device", "cpu", "--score_threshold", "0"]
    for ov in INFER_OVERRIDES:
        cmd += ["--config_override", ov]
    proc = subprocess.run(cmd, cwd=_ROOT, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=_ROOT))
    assert proc.returncode == 0, proc.stderr
    assert f"wrote {out}" in proc.stdout
    assert np.asarray(Image.open(out)).shape == (300, 400, 3)
