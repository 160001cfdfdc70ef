"""FPN with `tpu_fpn_backbone_style: "slim"`: the port's `SlimResNetBackbone`
and FPN detector against JAX's, on the CPU.

The slim extractor has the keras one's parameter leaves, names and shapes,
so a port that ignored the key would load slim weights into the keras
backbone without a word and compute another function (the stride on
other blocks, explicit VALID padding, other pre-stride laterals).
`test_slim_backbone_c2_c5_match_jax` shows that fault: it fails on a port
that builds the keras backbone for a slim config.

Depth 50 runs JAX's own FPN init (`init_params(PRNGKey(0))`, the RPN score
layer scaled by 20 so that random-weight proposals separate, shared with
tests/test_torch_fpn_train.py through `tests/torch_shared.py::jax_init`:
the slim tree equals the keras one leaf for leaf, asserted), a 128x128
bucket and the configs of tests/test_torch_fpn.py (serving) and
tests/test_torch_fpn_train.py (one training step at B=1 with JAX's draws).
The slim ResNet-101 extractor runs seeded numpy weights
(`tests/torch_shared.py::numpy_params`); at every depth and in both
compute dtypes the style selects the slim extractor, which takes JAX's
slim tree. Tolerances, with their reasons
(those of the keras-style tests): c2..c5 and heads rtol/atol 1e-4 (oneDNN
and XLA:CPU sum in another order); scores atol 1e-4, boxes atol 1e-3 px,
labels and validity exact; losses rtol 1e-4 and counts exact; gradients
and momentum traces within GRAD_TOL = 2e-3 of each tensor's largest
value; parameters after one momentum step atol 1e-6.
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
from tf_eager_object_detection_tpu_torch.config.config_factory import (
    apply_config_overrides,
    config_factory,
)
from tf_eager_object_detection_tpu_torch.models.backbones.resnet import (
    ResNetBackbone,
    SlimResNetBackbone,
)
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.ref_import.from_jax import (
    load_jax_params,
    parameter_tree_from_jax,
    state_dict_from_jax,
)
from tf_eager_object_detection_tpu_torch.training.optimizer import make_optimizer
from tf_eager_object_detection_tpu_torch.training.train_step import make_train_step
from test_torch_fpn_train import _batch
from test_torch_fpn_train import _config as _train_config
from test_torch_fpn_train import jax_draws
from torch_shared import jax_init, numpy_params, shared

MAP_TOL = dict(rtol=1e-4, atol=1e-4)
BOX_TOL = dict(rtol=0, atol=1e-3)
SCORE_TOL = dict(rtol=0, atol=1e-4)
GRAD_TOL = 2e-3
RPN_SCORE_SCALE = 20.0
ROI_SCORE_SCALE = 10.0  # serving only: spreads the random head's class scores
KEY = 7
SLIM = {"tpu_fpn_backbone_style": "slim"}


def _serve_config():
    cfg = dict(config_factory("pascal", "fpn"), **SLIM)
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


def _jax_params(flat):
    return jax.tree_util.tree_map(jnp.asarray, unflatten_dict(flat, sep="/"))


def _port(flat, cfg):
    det = model_factory("fpn", "resnet50", cfg, device="cpu")
    load_jax_params(det, flat)
    return det


def _images():
    rng = np.random.RandomState(0)
    return rng.randn(2, 128, 128, 3).astype(np.float32), np.array([[120, 124], [128, 100]],
                                                                  np.int32)


def _level_margin(rois):
    r = np.asarray(rois, np.float64)
    v = 4.0 + np.log2(np.sqrt(np.maximum(r[..., 2] - r[..., 0], 0)
                              * np.maximum(r[..., 3] - r[..., 1], 0) + 1e-8) / 224.0)
    return np.abs(v - np.round(v))


def _serving(flat):
    """JAX and the port with the slim backbone at depth 50: c2..c5 of both
    images, `predict` of each and `im_detect_batch` of both."""
    cfg = _serve_config()
    sflat = dict(flat, **{"roi_head/roi_head_score/kernel":
                          flat["roi_head/roi_head_score/kernel"] * ROI_SCORE_SCALE})
    jdet = jax_factory("fpn", "resnet50", cfg)
    shapes = flatten_dict(jax.eval_shape(jdet.init_params, jax.random.PRNGKey(0)), sep="/")
    params = _jax_params(sflat)
    images, hw = _images()
    scales = np.array([1.0, 1.25], np.float32)
    feats = jax.jit(lambda p, x: jdet.extractor.apply({"params": p}, x))(
        params["extractor"], jnp.asarray(images))
    out = {"same_tree": {k: tuple(v.shape) for k, v in shapes.items()}
           == {k: v.shape for k, v in flat.items()},
           "jax_feats": [np.asarray(f) for f in feats],
           "jax_predict": [[np.asarray(t) for t in jdet.predict(params, jnp.asarray(images[i]),
                                                                   jnp.asarray(hw[i]))]
                           for i in range(2)],
           "jax_batch": [np.asarray(t) for t in jdet.im_detect_batch(
               params, jnp.asarray(images), jnp.asarray(hw), jnp.asarray(scales))]}
    det = _port(sflat, cfg)
    out["extractor"] = type(det.extractor).__name__
    with torch.no_grad():
        out["feats"] = [f.numpy() for f in det.extractor(torch.from_numpy(images))]
    out["predict"] = [[t.numpy() for t in det.predict(images[i], hw[i])] for i in range(2)]
    out["batch"] = [t.numpy() for t in det.im_detect_batch(images, hw, scales)]
    return out


@pytest.fixture(scope="module")
def flat(tmp_path_factory):
    return jax_init(tmp_path_factory, "fpn", RPN_SCORE_SCALE)


@pytest.fixture(scope="module")
def serving(tmp_path_factory, flat):
    return shared(tmp_path_factory, "torch_fpn_slim_serving", lambda: _serving(flat))


def test_slim_backbone_c2_c5_match_jax(serving):
    """The repair: a slim-style config builds the slim extractor, whose
    c2..c5 are JAX's `SlimResNetBackbone`'s (c2 at stride 4 before conv2's
    strided last block ... c5 at 32 from conv5 at stride 1)."""
    assert serving["same_tree"]
    assert serving["extractor"] == "SlimResNetBackbone"
    got, want = serving["feats"], serving["jax_feats"]
    assert [g.shape for g in got] == [(2, 32, 32, 256), (2, 16, 16, 512), (2, 8, 8, 1024),
                                      (2, 4, 4, 2048)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **MAP_TOL)


def test_slim_predict_matches_jax(serving):
    for i, hw in enumerate(_images()[1]):
        boxes, labels, scores, valid = serving["predict"][i]
        jb, jl, js, jv = serving["jax_predict"][i]
        np.testing.assert_array_equal(valid, jv)
        np.testing.assert_array_equal(labels, jl)
        np.testing.assert_allclose(scores, js, **SCORE_TOL)
        np.testing.assert_allclose(boxes, jb, **BOX_TOL)
        assert valid.sum() > 0
        assert boxes[valid, 2].max() <= hw[1] - 1 and boxes[valid, 3].max() <= hw[0] - 1


def test_slim_im_detect_batch_matches_jax(serving):
    sm, deltas, rois, valid = serving["batch"]
    jsm, jdeltas, jrois, jvalid = serving["jax_batch"]
    assert sm.shape == (2, 64, 21)
    np.testing.assert_array_equal(valid, jvalid)
    assert valid.any() and _level_margin(jrois[jvalid]).min() > 1e-4
    np.testing.assert_allclose(rois, jrois, **BOX_TOL)
    np.testing.assert_allclose(sm[valid], jsm[jvalid], **SCORE_TOL)
    np.testing.assert_allclose(deltas[valid], jdeltas[jvalid], **MAP_TOL)


# ---------------------------------------------------------- training step
def _rel_errors(got, want):
    return {n: float(np.abs(got[n] - w.numpy()).max()) / max(float(w.abs().max()), 1e-30)
            for n, w in want.items()}


def _train_step(flat):
    """JAX `loss_fn` + one fused-momentum step against the port's
    `make_train_step` at B=1 with JAX's draws, slim style."""
    cfg = dict(_train_config(), **SLIM)
    jdet = jax_factory("fpn", "resnet50", cfg)
    params = _jax_params(flat)
    batch = [jnp.asarray(a) for a in _batch(1)]

    def loss(p):
        return jdet.loss_fn(p, *batch, jax.random.PRNGKey(KEY))

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    opt = jax_optimizer(cfg, params, "resnet50", "fpn")
    updates, state = jax.jit(lambda g, p: opt.update(g, opt.init(p), p))(grads, params)

    def tree(t):
        return parameter_tree_from_jax({k: np.asarray(v) for k, v in
                                        flatten_dict(t, sep="/").items()})

    want = {"grads": tree(grads), "params": tree(optax.apply_updates(params, updates)),
            "trace": tree(state.trace)}
    out = {"jax_metrics": {k: float(v) for k, v in metrics.items()}}
    det = _port(flat, cfg)
    port_opt = make_optimizer(cfg, det)
    a = 3 * sum((128 // s) ** 2 for s in cfg["anchor_stride_list"])
    with torch.no_grad():
        scores2 = det._flatten_levels(*det._backbone_neck_rpn(
            torch.from_numpy(_batch(1)[0]))[1:])[0]
    out["probs"] = torch.softmax(scores2, dim=-1)[0, :, 1].numpy()
    metrics = make_train_step(det, port_opt)(_batch(1), jax_draws(jax.random.PRNGKey(KEY), 1, a,
                                                                   64, 32))
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["grad_err"] = _rel_errors({n: p.grad.numpy() for n, p in det.named_parameters()},
                                  want["grads"])
    out["param_err"] = {n: float(np.abs(p.detach().numpy() - want["params"][n].numpy()).max())
                        for n, p in det.named_parameters()}
    out["trace_err"] = _rel_errors({n: t.numpy() for n, t in port_opt.trace.items()},
                                   want["trace"])
    out["extractor_grad"] = float(det.extractor.conv2_block1_1_conv.weight.grad.abs().max())
    return out


@pytest.fixture(scope="module")
def step(tmp_path_factory, flat):
    return shared(tmp_path_factory, "torch_fpn_slim_step", lambda: _train_step(flat))


def test_slim_losses_and_counts_match_jax(step):
    want = step["jax_metrics"]
    assert set(step["metrics"]) == set(want)
    for k, v in want.items():
        if k.startswith("num_"):
            assert step["metrics"][k] == v, k
        else:
            np.testing.assert_allclose(step["metrics"][k], v, rtol=1e-4, err_msg=k)
    assert want["num_roi_fg"] > 0 and want["num_rpn_fg"] > 0
    p = np.sort(step["probs"])[::-1]  # the premise: the scores separate at the pre-NMS cut
    assert p[511] - p[512] > 1e-4


def test_slim_gradients_params_and_momentum_match_jax(step):
    """Every tensor (FPN trains conv1 and conv2 too) within GRAD_TOL of its
    largest value; parameters after the step atol 1e-6."""
    worst = max(step["grad_err"].items(), key=lambda kv: kv[1])
    assert worst[1] <= GRAD_TOL, worst
    worst = max(step["trace_err"].items(), key=lambda kv: kv[1])
    assert worst[1] <= GRAD_TOL, worst
    worst = max(step["param_err"].items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-6, worst
    assert step["extractor_grad"] > 0


# ------------------------------------------------------- depths and dtypes
def _deep_feats(backbone):
    cfg = _serve_config()
    jdet = jax_factory("fpn", backbone, cfg)
    flat = numpy_params(jdet, seed=3)
    ext = {k.split("/", 1)[1]: v for k, v in flat.items() if k.startswith("extractor/")}
    x = np.random.RandomState(1).randn(1, 96, 80, 3).astype(np.float32)
    want = jax.jit(lambda p, v: jdet.extractor.apply({"params": p}, v))(
        _jax_params(ext), jnp.asarray(x))
    port = SlimResNetBackbone({"resnet101": 101, "resnet152": 152}[backbone])
    load_jax_params(port, ext)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def test_slim_backbone_at_depth_101_matches_jax(tmp_path_factory):
    """c2..c5 of the slim ResNet-101 extractor on a 96x80 image (odd sides
    past the stride-8 level: 12x10 -> 6x5 -> 3x3) against JAX's."""
    backbone = "resnet101"
    want, got = shared(tmp_path_factory, f"torch_fpn_slim_{backbone}",
                       lambda: _deep_feats(backbone))
    assert [g.shape for g in got] == [w.shape for w in want] == [
        (1, 24, 20, 256), (1, 12, 10, 512), (1, 6, 5, 1024), (1, 3, 3, 2048)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **MAP_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backbone", ["resnet50", "resnet101", "resnet152"])
def test_style_picks_the_backbone_at_every_depth_and_dtype(backbone, dtype):
    """A slim-style config builds `SlimResNetBackbone` in the compute dtype;
    its state_dict takes the JAX slim tree (names and shapes; checked at
    float32, the dtype changes neither)."""
    base = dict(config_factory("pascal", "fpn"), tpu_compute_dtype=dtype)
    det = model_factory("fpn", backbone, dict(base, **SLIM), device="cpu")
    assert isinstance(det.extractor, SlimResNetBackbone)
    assert det.extractor.conv1_conv.compute_dtype == det.compute_dtype
    assert det.extractor.conv3_block1_2_conv.compute_dtype == det.compute_dtype
    if dtype != "float32":
        return
    jdet = jax_factory("fpn", backbone, dict(base, **SLIM))
    shapes = flatten_dict(jax.eval_shape(jdet.init_params, jax.random.PRNGKey(0)), sep="/")
    converted = state_dict_from_jax({k: np.zeros(v.shape, np.float32)
                                     for k, v in shapes.items()})
    expected = det.state_dict()
    assert converted.keys() == expected.keys()
    assert all(converted[k].shape == expected[k].shape for k in expected)


@pytest.mark.parametrize("style", [{"tpu_fpn_backbone_style": "keras"}, {}])
def test_keras_style_and_no_style_build_the_keras_backbone(style):
    det = model_factory("fpn", "resnet50", dict(config_factory("pascal", "fpn"), **style),
                        device="cpu")
    assert type(det.extractor) is ResNetBackbone


@pytest.mark.parametrize("override", ['tpu_fpn_backbone_style="slim"',
                                      "tpu_fpn_backbone_style=slim"])
def test_config_override_selects_the_slim_backbone(override):
    """What `train` / `eval_pascal` / `infer --config_override` do with the
    key: the port's FPN preset lists it, so the override is accepted."""
    cfg = apply_config_overrides(dict(config_factory("pascal", "fpn")), [override])
    assert cfg["tpu_fpn_backbone_style"] == "slim"
    assert isinstance(model_factory("fpn", "resnet50", cfg, device="cpu").extractor,
                      SlimResNetBackbone)


@pytest.mark.parametrize("style", ["Slim", "resnet", ""])
def test_unknown_backbone_style_raises(style):
    cfg = dict(config_factory("pascal", "fpn"), tpu_fpn_backbone_style=style)
    with pytest.raises(ValueError, match="tpu_fpn_backbone_style"):
        model_factory("fpn", "resnet50", cfg, device="cpu")


def test_slim_bf16_dtype_of_every_stage_matches_jax():
    """The slim extractor under bf16 compute: every flax submodule's input
    and output dtypes (interceptors under `jax.eval_shape`) equal the port
    module's of the same name (forward hooks)."""
    import flax.linen as fnn

    cfg = dict(_serve_config(), tpu_compute_dtype="bfloat16")
    jdet = jax_factory("fpn", "resnet50", cfg)
    params = jax.eval_shape(jdet.init_params, jax.random.PRNGKey(0))
    want = {}

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__":
            name = ".".join(("extractor", *context.module.scope.path))
            want.setdefault(name, []).append((_dt(args[0]), _dt(out)))
        return out

    def run(p, x):
        with fnn.intercept_methods(interceptor):
            return jdet.extractor.apply({"params": p}, x)

    jax.eval_shape(run, params["extractor"], jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    det = model_factory("fpn", "resnet50", cfg, device="cpu")
    got = {}

    def hook(name):
        def fn(mod, inputs, out):
            got.setdefault(name, []).append((_dt(inputs[0]), _dt(out)))
        return fn

    handles = [m.register_forward_hook(hook(f"extractor.{n}" if n else "extractor"))
               for n, m in det.extractor.named_modules()]
    try:
        with torch.no_grad():
            det.extractor(torch.zeros(1, 64, 64, 3))
    finally:
        for h in handles:
            h.remove()
    assert len(want) > 100
    for name, calls in want.items():
        assert got.get(name) == calls, name
    assert want["extractor"][0] == ("float32", ("bfloat16",) * 4)


def _dt(x):
    if isinstance(x, (tuple, list)):
        return tuple(_dt(v) for v in x)
    return str(x.dtype).removeprefix("torch.")
