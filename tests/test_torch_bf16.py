"""bfloat16 compute of the port against the JAX package's, on the CPU.

`tpu_compute_dtype: "bfloat16"` for Faster R-CNN ResNet-50 (C4) and FPN
ResNet-50 at the sizes of tests/test_bf16.py (a 128x128 bucket, 256 / 64
training and 256 / 32 test proposals, RoI batch 16), with anchor scales
(2, 4, 8) for C4 so that its anchors fit the image. Both frameworks run the
same bridged JAX init (`init_params(PRNGKey(0))`, the RPN score layer
scaled by 20 so that random-weight proposals separate), computed once per
session and shared with the float32 training tests and between workers
(`tests/torch_shared.py::jax_init`); the forward tests undo the scale.

- The dtype of every stage: every flax submodule's input and output (read
  with method interceptors under `jax.eval_shape`) against the port
  module of the same name (forward hooks), plus the RoI crops, the FPN
  upsample and the RoIAlign kernels' output and plane gradients.
- Backbone + RPN (and the FPN pyramid) against JAX bf16 and against the
  port's own float32, each within `rel.mean() < 0.05` (the bound of
  tests/test_bf16.py; rel = |a - b| / (|b| + 1)) and max |a - b| within 5%
  of max |b|. Observed: 0.008-0.024 mean and <= 1.4% of the largest value
  against JAX, 0.002-0.025 against f32. bf16 rounds in other places in
  the two frameworks (XLA rounds a conv's output and again after its bias,
  cuDNN and oneDNN fuse the bias; XLA may keep an elementwise chain in
  float32), so the port is as far from JAX bf16 as bf16 is from float32.
- The RoI heads on JAX's own proposals (both frameworks crop the same
  rois, so ties in proposal order decide nothing): softmax within 0.05
  absolute, box deltas within 3% of their largest value (observed 0.026
  and 0.63%).
- One training step at B=1 with JAX's draws and JAX's own bf16 training
  proposals given to both `loss_fn`s (a proposal whose IoU with a gt box
  lies near 0.5 flips between foreground and background under bf16 noise
  of its deltas: unpinned, FPN's RoI foreground count differs by one):
  losses rtol 2e-2 (observed <= 9e-3, the RPN classification loss), counts
  equal; every trainable tensor's gradient has cosine > 0.9 with JAX's and
  all of them together > 0.99 (observed worst 0.951, a conv5 bias of the
  C4 head, and 0.9992 / 0.9998 overall). After `make_train_step`, every
  parameter, gradient and momentum trace is float32.
- The plain RoIAlign on bf16 planes: the forward bit-equal to the plain
  version on the upcast planes, the backward equal to the float32 backward
  rounded to bf16 (also through autograd), and the forward within atol /
  rtol 1e-5 of the Pallas K4 in interpret mode on the same bf16 planes
  (planes below 16 cells, one image a call, as tests/test_torch_roi_align_fpn.py).
- `predict`, `im_detect_batch` and `batched_im_detect` in bf16; the train
  command line with `--compute_dtype bfloat16`; `tpu_remat` gives
  bit-equal gradients at float32.
"""

import glob
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from tf_eager_object_detection_tpu.models.fpn import resize_bilinear_tf1 as jax_resize
from tf_eager_object_detection_tpu.models.model_factory import model_factory as jax_factory
from tf_eager_object_detection_tpu.ops.pallas.roi_align_pallas import pallas_roi_align_multilevel
from tf_eager_object_detection_tpu.ops.roi_align import roi_crop_faster_rcnn as jax_crop
from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
from tf_eager_object_detection_tpu_torch.data.voc import create_pascal_tf_records
from tf_eager_object_detection_tpu_torch.evaluation.batched_inference import batched_im_detect
from tf_eager_object_detection_tpu_torch.models.fpn import resize_bilinear_tf1
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.ops import roi_align as port_roi
from tf_eager_object_detection_tpu_torch.ops.sampling import TrainDraws
from tf_eager_object_detection_tpu_torch.ref_import.from_jax import (
    load_jax_params,
    parameter_tree_from_jax,
)
from tf_eager_object_detection_tpu_torch.scripts import train as train_cli
from tf_eager_object_detection_tpu_torch.scripts.voc_rehearsal import generate
from tf_eager_object_detection_tpu_torch.training.optimizer import make_optimizer
from tf_eager_object_detection_tpu_torch.training.train_step import make_train_step
from torch_shared import jax_init, shared

MODELS = ["faster_rcnn", "fpn"]
RPN_SCORE_SCALE = 20.0
KEY = 7
HW = np.asarray([120, 124], np.int32)
REL_MEAN, REL_MAX = 0.05, 0.05
SOFTMAX_ATOL, DELTAS_TOL = 0.05, 0.03
LOSS_RTOL, GRAD_COS, GRAD_COS_ALL = 2e-2, 0.9, 0.99


def _cfg(model_type, dtype="bfloat16"):
    cfg = dict(config_factory("pascal", model_type))
    cfg.update(
        tpu_compute_dtype=dtype,
        tpu_image_buckets=[[128, 128]],
        image_min_size=128,
        image_max_size=128,
        rpn_proposal_train_pre_nms_sample_number=256,
        rpn_proposal_train_after_nms_sample_number=64,
        rpn_proposal_test_pre_nms_sample_number=256,
        rpn_proposal_test_after_nms_sample_number=32,
        roi_total_sample_number=16,
        rpn_total_sample_number=32,
        max_objects_per_image=8,
        max_objects_per_class_per_image=8,
        tpu_max_gt_boxes=8,
    )
    if model_type == "faster_rcnn":
        cfg["scales"] = [2, 4, 8]
    return cfg


def _image(scale=40.0):
    return (np.random.RandomState(0).randn(1, 128, 128, 3) * scale).astype(np.float32)


def _batch():
    gt = np.zeros((1, 8, 4), np.float32)
    gt[0, :3] = [[10, 12, 60, 70], [40, 30, 118, 100], [5, 50, 50, 110]]
    mask = np.arange(8)[None] < 3
    labels = np.asarray([[3, 7, 12, 0, 0, 0, 0, 0]], np.int32)
    return _image(1.0), HW[None], gt, mask, labels


def _flat(tmp_path_factory, model_type):
    return jax_init(tmp_path_factory, model_type, RPN_SCORE_SCALE)


def _jax_params(flat):
    return jax.tree_util.tree_map(jnp.asarray, unflatten_dict(flat, sep="/"))


def _port(model_type, flat, dtype="bfloat16", **overrides):
    det = model_factory(model_type, "resnet50", dict(_cfg(model_type, dtype), **overrides),
                        device="cpu")
    load_jax_params(det, flat)
    return det


def _dt(x):
    """dtype name of an array, or a tuple of them for a sequence."""
    if isinstance(x, (tuple, list)):
        return tuple(_dt(v) for v in x)
    return str(x.dtype).removeprefix("torch.")


# ------------------------------------------------------------- dtype map
def _jax_dtype_map(model_type):
    """{module name: [(input dtype, output dtype) per call]} of the JAX bf16
    path's flax submodules, with the inputs that path gives each of them;
    plus the dtypes of the crops and of the RoIAlign's plane gradients."""
    jdet = jax_factory(model_type, "resnet50", _cfg(model_type))
    params = jax.eval_shape(jdet.init_params, jax.random.PRNGKey(0))
    seen, prefix = {}, [""]

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__":
            name = ".".join((prefix[0], *context.module.scope.path))
            seen.setdefault(name, []).append((_dt(args[0]), _dt(out)))
        return out

    image = jax.ShapeDtypeStruct((1, 128, 128, 3), jnp.float32)

    def run(params, image):
        def apply(name, x, **kw):
            prefix[0] = name
            return getattr(jdet, name).apply({"params": params[name]}, x, **kw)

        with fnn.intercept_methods(interceptor):
            feats = apply("extractor", image)
            if model_type == "fpn":
                feats = apply("neck", feats)
                maps = [apply("rpn_head", p) for p in feats]
                rois = jnp.zeros((1, 6, 4), jnp.float32).at[..., 2:].set(40.0)
                crop = pallas_roi_align_multilevel(
                    tuple(feats[:4]), rois, jnp.zeros((1, 6), jnp.int32), jnp.full((1,), 120.0),
                    jnp.full((1,), 124.0), 14, strides=jdet.strides[:4], interpret=True)
                pooled = jnp.zeros((6, 7, 7, 256), crop.dtype)
            else:
                maps = [apply("rpn_head", feats)]
                crop = jax_crop(feats[0], jnp.zeros((6, 4), jnp.float32).at[:, 2:].set(40.0),
                                jdet.stride, 7, True)
                pooled = crop
            apply("roi_head", pooled, train=False)
        return crop

    crop = jax.eval_shape(run, params, image)
    stages = {"crop": _dt(crop)}
    if model_type == "fpn":
        planes = tuple(jax.ShapeDtypeStruct((1, 128 // s, 128 // s, 256), jnp.bfloat16)
                       for s in (4, 8, 16, 32))

        def plane_grads(planes):
            def f(ps):
                return pallas_roi_align_multilevel(
                    ps, jnp.zeros((1, 6, 4)).at[..., 2:].set(40.0), jnp.zeros((1, 6), jnp.int32),
                    jnp.full((1,), 120.0), jnp.full((1,), 124.0), 14, strides=(4, 8, 16, 32),
                    interpret=True)
            out, vjp = jax.vjp(f, planes)
            return vjp(jnp.ones(out.shape, out.dtype))[0]

        stages["plane_grads"] = _dt(jax.eval_shape(plane_grads, planes))
        stages["resize"] = _dt(jax.eval_shape(
            lambda x: jax_resize(x, 8, 8), jax.ShapeDtypeStruct((1, 4, 4, 16), jnp.bfloat16)))
    return seen, stages


def _port_dtype_map(model_type):
    det = model_factory(model_type, "resnet50", _cfg(model_type), device="cpu")
    seen = {}

    def hook(name):
        def fn(mod, inputs, out):
            seen.setdefault(name, []).append((_dt(inputs[0]), _dt(out)))
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in det.named_modules() if n]
    try:
        with torch.no_grad():
            det._detect(torch.from_numpy(_image()), torch.from_numpy(HW[None]).long())
    finally:
        for h in handles:
            h.remove()
    stages = {}
    if model_type == "fpn":
        planes = [torch.zeros(1, 128 // s, 128 // s, 256, dtype=torch.bfloat16,
                              requires_grad=True) for s in (4, 8, 16, 32)]
        rois = torch.zeros(1, 6, 4)
        rois[..., 2:] = 40.0
        crop = port_roi.roi_align_multilevel(
            planes, rois, torch.zeros(1, 6, dtype=torch.long), torch.ones(1, 6, dtype=torch.bool),
            torch.full((1,), 120.0), torch.full((1,), 124.0), 14, (4, 8, 16, 32))
        stages["crop"] = _dt(crop)
        stages["plane_grads"] = _dt(torch.autograd.grad(crop, planes, torch.ones_like(crop)))
        stages["resize"] = _dt(resize_bilinear_tf1(torch.zeros(1, 4, 4, 16, dtype=torch.bfloat16),
                                                   8, 8))
    else:
        feats = torch.zeros(1, 8, 8, 1024, dtype=torch.bfloat16)
        rois = torch.zeros(1, 6, 4)
        rois[..., 2:] = 40.0
        stages["crop"] = _dt(port_roi.roi_crop_faster_rcnn(feats, rois, 16, 7, True))
    return seen, stages


@pytest.mark.parametrize("model_type", MODELS)
def test_dtype_of_every_stage_matches_jax(model_type):
    """Every flax submodule of the JAX path (convs, dense layers, frozen
    BatchNorms, the backbone, neck and heads themselves) has a port module of
    the same name whose every call takes and gives the same dtypes; the
    crops, the FPN upsample and the RoIAlign's plane gradients too."""
    want, want_stages = _jax_dtype_map(model_type)
    got, got_stages = _port_dtype_map(model_type)
    missing = sorted(set(want) - set(got))
    assert not missing, f"port modules missing: {missing[:5]}"
    for name, calls in want.items():
        assert got[name] == calls, name
    assert got_stages == want_stages
    # the rows of the JAX contract, spelled out
    if model_type == "fpn":
        assert want["neck.build_p4"][0] == ("float32", "bfloat16")  # the fused sum is f32
        assert want["neck"][0][1] == ("bfloat16",) * 5  # p2..p6
        assert want_stages == {"crop": "float32", "plane_grads": ("bfloat16",) * 4,
                               "resize": "float32"}
        assert want["roi_head.fc2"][0][1] == "bfloat16"
    else:
        assert want_stages == {"crop": "float32"}
        assert want["roi_head.conv5_block3_3_conv"][0][1] == "bfloat16"
    assert want["rpn_head.rpn_first_conv"][0][1] == "bfloat16"
    assert want["rpn_head.rpn_score_conv"][0] == ("bfloat16", "float32")
    assert want["extractor.conv2_block1_1_bn"][0] == ("bfloat16", "bfloat16")
    assert want["roi_head"][0][1] == ("float32", "float32")  # the logits


@pytest.mark.parametrize("name,want", [("float32", torch.float32),
                                       ("bfloat16", torch.bfloat16), ("float16", None)])
def test_compute_dtype_comes_from_the_config(name, want):
    if want is None:
        with pytest.raises(ValueError, match="tpu_compute_dtype"):
            model_factory("fpn", "resnet50", _cfg("fpn", name), device="cpu")
        return
    det = model_factory("fpn", "resnet50", _cfg("fpn", name), device="cpu")
    assert det.compute_dtype == want
    assert det.neck.build_p2.compute_dtype == want and det.roi_head.fc1.compute_dtype == want
    assert det.rpn_head.rpn_score_conv.compute_dtype == torch.float32
    assert {p.dtype for p in det.parameters()} == {torch.float32}


# ----------------------------------------------------- forward parity
def _unscaled(flat):
    """The init without the RPN score layer's scale (the network of
    tests/test_bf16.py, whose bound is on its logits)."""
    return dict(flat, **{"rpn_head/rpn_score_conv/kernel":
                         flat["rpn_head/rpn_score_conv/kernel"] / RPN_SCORE_SCALE})


def _jax_forward(model_type, flat):
    """JAX bf16: backbone + RPN outputs (+ the pyramid), and `_roi_forward`'s
    proposals and raw head outputs for image 0."""
    jdet = jax_factory(model_type, "resnet50", _cfg(model_type))

    def fwd(p, x, hw):
        if model_type == "fpn":
            p_list, s_list, b_list = jdet._backbone_neck_rpn(p, x)
            head = jdet._roi_forward(p, [q[0] for q in p_list], [s[0] for s in s_list],
                                     [b[0] for b in b_list], hw)
            return (*p_list, *s_list, *b_list), head
        feats, score, bbox = jdet._backbone_rpn(p, x)
        return (feats, score, bbox), jdet._roi_forward(p, feats[0], score[0], bbox[0], hw)

    outs, head = jax.jit(fwd)(_jax_params(flat), jnp.asarray(_image()), jnp.asarray(HW))
    return ([(np.asarray(o.astype(jnp.float32)), str(o.dtype)) for o in outs],
            [np.array(h) for h in head])


@pytest.fixture(scope="module", params=MODELS)
def forward(request, tmp_path_factory):
    model_type = request.param
    flat = _unscaled(_flat(tmp_path_factory, model_type))
    ref = shared(tmp_path_factory, f"torch_bf16_jax_forward_{model_type}",
                 lambda: _jax_forward(model_type, flat))
    return model_type, flat, ref


def _port_backbone(det):
    with torch.no_grad():
        x = torch.from_numpy(_image())
        if det.model_type == "fpn":
            p_list, s_list, b_list = det._backbone_neck_rpn(x)
            return [*p_list, *s_list, *b_list]
        return list(det._backbone_rpn(x))


def _rel(a, b):
    return np.abs(a - b) / (np.abs(b) + 1.0)


def test_backbone_and_rpn_close_to_jax_bf16_and_to_float32(forward):
    model_type, flat, (ref, _) = forward
    got16 = _port_backbone(_port(model_type, flat))
    got32 = _port_backbone(_port(model_type, flat, "float32"))
    assert len(got16) == len(ref)
    for (want, want_dtype), g16, g32 in zip(ref, got16, got32):
        assert _dt(g16) == want_dtype  # bf16 features and pyramid, f32 RPN maps
        a, b, c = g16.float().numpy(), want, g32.numpy()
        assert a.shape == b.shape
        assert _rel(a, b).mean() < REL_MEAN and np.abs(a - b).max() <= REL_MAX * np.abs(b).max()
        assert _rel(a, c).mean() < REL_MEAN  # bf16 noise, not garbage (tests/test_bf16.py)
        assert np.abs(a - c).max() > 0  # it did compute in bf16


def test_roi_heads_on_jax_rois_close_to_jax_bf16(forward):
    model_type, flat, (_, (rois, valid, softmax, deltas)) = forward
    det = _port(model_type, flat)
    with torch.no_grad():
        x = torch.from_numpy(_image())
        r, v = torch.from_numpy(rois)[None], torch.from_numpy(valid)[None]
        if model_type == "fpn":
            p_list = det._backbone_neck_rpn(x)[0]
            feats = det._roi_features(p_list, r, v, torch.from_numpy(HW[None]).long())
            got_sm, got_de = det._roi_head(feats)
            got_sm, got_de = got_sm[0], got_de[0].reshape(len(rois), -1)
        else:
            scores, got_de = det._roi_outputs(det._backbone_rpn(x)[0], r)
            got_sm = torch.softmax(scores, dim=-1)
    assert got_sm.dtype == got_de.dtype == torch.float32
    assert valid.sum() > 8
    got_sm, got_de = got_sm.numpy()[valid], got_de.numpy()[valid]
    want_sm, want_de = softmax[valid], deltas.reshape(len(rois), -1)[valid]
    np.testing.assert_allclose(got_sm, want_sm, rtol=0, atol=SOFTMAX_ATOL)
    np.testing.assert_allclose(got_de, want_de, rtol=0, atol=DELTAS_TOL * np.abs(want_de).max())


@pytest.mark.parametrize("model_type", MODELS)
def test_serving_entry_points_in_bf16(model_type):
    det = model_factory(model_type, "resnet50", _cfg(model_type), device="cpu")
    image = _image()[0]
    dets = det.predict(image, HW)
    assert dets.scores.dtype == dets.boxes.dtype == torch.float32
    assert bool(torch.isfinite(dets.boxes).all() and torch.isfinite(dets.scores).all())
    b = dets.boxes[dets.valid]
    assert len(b) and float(b.min()) >= 0 and float(b[:, 2].max()) <= HW[1] - 1 \
        and float(b[:, 3].max()) <= HW[0] - 1
    images = np.stack([image, image[::-1].copy()])
    out = det.im_detect_batch(images, np.stack([HW, HW]), np.ones(2, np.float32))
    assert [t.dtype for t in out] == [torch.float32] * 3 + [torch.bool]
    assert all(bool(torch.isfinite(t).all()) for t in out[:3])
    items = [(im, HW, 1.0, int(HW[0]), int(HW[1])) for im in images]
    results = list(batched_im_detect(det, iter(items), 2))
    assert [idx for idx, *_ in results] == [0, 1]
    torch.testing.assert_close(results[0][2][0], out[0][0], rtol=0, atol=0)


# ------------------------------------------------------- training step
def jax_draws(model_type, key, a, r, s) -> TrainDraws:
    """The random numbers JAX `loss_fn` draws for one image (Faster R-CNN
    splits its key into b + 1; see tests/test_torch_faster_rcnn_train.py)."""
    keys = jax.random.split(key, 2)[:1] if model_type == "faster_rcnn" else jax.random.split(key, 1)
    r_at, r_pt = jax.random.split(keys[0])
    k_fg, k_bg = jax.random.split(r_at)
    p_fg, p_bg, p_wr = jax.random.split(r_pt, 3)
    fields = [jax.random.uniform(k_fg, (a,)), jax.random.uniform(k_bg, (a,)),
              jax.random.uniform(p_fg, (r,)), jax.random.uniform(p_bg, (r,)),
              jax.random.gumbel(p_wr, (s, r))]
    return TrainDraws(*(torch.from_numpy(np.array(f)[None]) for f in fields))


def _jax_train(model_type, flat):
    """JAX bf16's training proposals for the batch, then its `loss_fn` and
    gradients with those proposals pinned."""
    jdet = jax_factory(model_type, "resnet50", _cfg(model_type))
    params = _jax_params(flat)
    images, hw, gt, mask, labels = (jnp.asarray(a) for a in _batch())

    def proposals(p):
        if model_type == "fpn":
            p_list, s_list, b_list = jdet._backbone_neck_rpn(p, images)
            grids = tuple((q.shape[1], q.shape[2]) for q in p_list)
            scores2, deltas = jdet._flatten_levels([s[0] for s in s_list], [b[0] for b in b_list])
            return jdet._proposals(scores2, deltas, jdet.anchors_for_grids(grids),
                                   jdet._level_valid_mask(grids, hw[0]), hw[0], training=True,
                                   grids=grids)
        _, score, bbox = jdet._backbone_rpn(p, images)
        gh, gw = score.shape[1:3]
        return jdet._proposals(score[0], bbox[0], jdet.anchors_for_grid(gh, gw), hw[0], (gh, gw),
                               training=True)[:2]

    rois, valid = (np.array(a) for a in jax.jit(proposals)(params))
    pinned = (jnp.asarray(rois), jnp.asarray(valid))
    jdet._proposals = lambda *a, **k: pinned if model_type == "fpn" else (*pinned, None)

    def loss(p):
        return jdet.loss_fn(p, images, hw, gt, mask, labels, jax.random.PRNGKey(KEY))

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return dict(rois=rois, valid=valid, metrics={k: float(v) for k, v in metrics.items()},
                grads={k: np.asarray(v) for k, v in flatten_dict(grads, sep="/").items()})


@pytest.fixture(scope="module", params=MODELS)
def trained(request, tmp_path_factory):
    """(JAX bf16 step, the port's bf16 loss and gradients with the same
    proposals and draws, the port's detector and optimizer after
    `make_train_step` on them)."""
    model_type = request.param
    flat = _flat(tmp_path_factory, model_type)
    ref = shared(tmp_path_factory, f"torch_bf16_jax_train_{model_type}",
                 lambda: _jax_train(model_type, flat))
    det = _port(model_type, flat)
    pinned = (torch.from_numpy(ref["rois"])[None], torch.from_numpy(ref["valid"])[None])
    det._proposals = lambda *a, **k: pinned
    cfg = det.cfg
    if model_type == "fpn":
        a = 3 * sum((128 // s) ** 2 for s in cfg["anchor_stride_list"])
    else:
        a = (128 // cfg["extractor_stride"]) ** 2 * det.num_anchors
    draws = jax_draws(model_type, jax.random.PRNGKey(KEY), a,
                      cfg["rpn_proposal_train_after_nms_sample_number"],
                      cfg["roi_total_sample_number"])
    opt = make_optimizer(cfg, det)
    metrics = make_train_step(det, opt)(_batch(), draws)
    return model_type, ref, {k: float(v) for k, v in metrics.items()}, det, opt


def test_train_losses_close_to_jax_bf16(trained):
    _, ref, got, _, _ = trained
    assert set(got) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        if k.startswith("num_"):
            assert got[k] == v, k
        else:
            np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=k)
    assert ref["metrics"]["num_rpn_fg"] > 0 and ref["metrics"]["num_roi_fg"] > 0


def test_train_gradients_aligned_with_jax_bf16(trained):
    _, ref, _, det, _ = trained
    want = parameter_tree_from_jax(ref["grads"])
    got = {n: p.grad for n, p in det.named_parameters() if p.grad is not None}
    assert got and set(got) <= set(want)
    flat_got, flat_want = [], []
    for name, g in got.items():
        a, b = g.numpy().ravel().astype(np.float64), want[name].numpy().ravel()
        if not a.any() or not b.any():  # a layer no sample reaches (FPN's build_p4 here)
            assert not a.any() and not b.any(), name
            continue
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos > GRAD_COS, (name, cos)
        flat_got.append(a)
        flat_want.append(b)
    a, b = np.concatenate(flat_got), np.concatenate(flat_want)
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > GRAD_COS_ALL


def test_parameters_gradients_and_momentum_stay_float32(trained):
    _, _, _, det, opt = trained
    assert det.compute_dtype == torch.bfloat16
    assert {p.dtype for p in det.parameters()} == {torch.float32}
    assert {b.dtype for b in det.buffers()} == {torch.float32}
    assert {p.grad.dtype for p in det.parameters() if p.grad is not None} == {torch.float32}
    assert opt.trace and {t.dtype for t in opt.trace.values()} == {torch.float32}
    assert sum(bool(t.any()) for t in opt.trace.values()) > len(opt.trace) // 2


# ---------------------------------------------------- plain RoIAlign, bf16
def _roi_case(seed, b=2, n=8, c=16, bucket=(64, 64)):
    rng = np.random.RandomState(seed)
    planes = [torch.from_numpy(rng.randn(b, -(-bucket[0] // s), -(-bucket[1] // s), c)
                               .astype(np.float32)).bfloat16() for s in (4, 8, 16, 32)]
    ih = np.asarray([58.0, 44.0], np.float32)[:b]
    iw = np.asarray([59.0, 34.0], np.float32)[:b]
    x1, y1 = rng.uniform(0, 30, (b, n)), rng.uniform(0, 40, (b, n))
    rois = np.stack([x1, y1, np.minimum(x1 + rng.uniform(4, 40, (b, n)), 33),
                     np.minimum(y1 + rng.uniform(4, 40, (b, n)), 43)], -1).astype(np.float32)
    levels = rng.randint(0, 4, (b, n))
    valid = np.ones((b, n), bool)
    valid[-1, -1] = False
    return planes, *(torch.from_numpy(a) for a in (rois, levels, valid, ih, iw))


@pytest.mark.parametrize("seed", [3, 4])
def test_plain_roi_align_on_bf16_planes_is_the_upcast_planes(seed):
    planes, rois, levels, valid, ih, iw = _roi_case(seed)
    strides = (4, 8, 16, 32)
    got = port_roi.roi_align_multilevel(planes, rois, levels, valid, ih, iw, 14, strides)
    want = port_roi.roi_align_multilevel_reference([p.float() for p in planes], rois, levels,
                                                   valid, ih, iw, 14, strides)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    one = port_roi.roi_align_single_level(planes[1], rois, levels == 1, ih, iw, 14, 8)
    assert torch.equal(one, port_roi.roi_align_single_level_reference(
        planes[1].float(), rois, levels == 1, ih, iw, 14, 8))
    # the backward: summed in f32, rounded to the planes' dtype once
    g = torch.from_numpy(np.random.RandomState(seed + 10).randn(*got.shape).astype(np.float32))
    d16 = port_roi.roi_align_multilevel_reference_backward(g, planes, rois, levels, valid, ih, iw,
                                                           14, strides)
    d32 = port_roi.roi_align_multilevel_reference_backward(g, [p.float() for p in planes], rois,
                                                           levels, valid, ih, iw, 14, strides)
    assert [d.dtype for d in d16] == [torch.bfloat16] * 4
    assert [d.dtype for d in d32] == [torch.float32] * 4
    assert all(torch.equal(a, b.bfloat16()) for a, b in zip(d16, d32))
    leaves = [p.clone().requires_grad_() for p in planes]
    out = port_roi.roi_align_multilevel(leaves, rois, levels, valid, ih, iw, 14, strides)
    auto = torch.autograd.grad(out, leaves, g)
    assert all(torch.equal(a, b) for a, b in zip(auto, d16))


@pytest.mark.parametrize("seed", [5, 6])
def test_plain_roi_align_on_bf16_planes_matches_pallas_k4_interpret(seed):
    """The Pallas kernel on the same bf16 planes (its float32 window), one
    image a call (see tests/test_torch_roi_align_fpn.py)."""
    planes, rois, levels, valid, ih, iw = _roi_case(seed)
    jplanes = [jnp.asarray(p.float().numpy()).astype(jnp.bfloat16) for p in planes]
    want = np.concatenate([np.asarray(pallas_roi_align_multilevel(
        tuple(p[i:i + 1] for p in jplanes), jnp.asarray(rois.numpy()[i:i + 1]),
        jnp.asarray(levels.numpy()[i:i + 1]), jnp.asarray(ih.numpy()[i:i + 1]),
        jnp.asarray(iw.numpy()[i:i + 1]), 14, strides=(4, 8, 16, 32),
        valid=jnp.asarray(valid.numpy()[i:i + 1].astype(np.int32)), interpret=True,
    )) for i in range(2)])
    got = port_roi.roi_align_multilevel(planes, rois, levels, valid, ih, iw, 14, (4, 8, 16, 32))
    assert want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------- remat, command line
def test_remat_gives_bit_equal_gradients_at_float32(tmp_path_factory):
    flat = _flat(tmp_path_factory, "faster_rcnn")
    draws = jax_draws("faster_rcnn", jax.random.PRNGKey(KEY), 576, 64, 16)
    grads = []
    for remat in (False, True):
        det = _port("faster_rcnn", flat, "float32", tpu_remat=remat)
        total, _ = det.loss_fn(*_batch(), draws)
        total.backward()
        grads.append({n: p.grad for n, p in det.named_parameters() if p.grad is not None})
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) > 50
    assert all(torch.equal(grads[0][n], grads[1][n]) for n in grads[0])


TINY = ["scales=[2, 4, 8]", "rpn_proposal_train_pre_nms_sample_number=256",
        "rpn_proposal_train_after_nms_sample_number=64", "rpn_total_sample_number=64",
        "rpn_pos_sample_max_number=32", "roi_total_sample_number=32",
        "roi_pos_sample_max_number=8", "tpu_image_buckets=[[128, 128]]",
        "image_min_size=128", "image_max_size=128"]


def test_train_command_line_in_bf16_writes_float32_checkpoints(tmp_path):
    voc = tmp_path / "VOCdevkit" / "VOC2007"
    generate(str(voc), 4, 20, seed=0)  # a test split that covers the 20 classes
    create_pascal_tf_records(str(tmp_path / "VOCdevkit"), "2007", "trainval",
                             str(tmp_path / "tfrecords"), num_shards=1)
    logs = tmp_path / "logs"
    argv = ["--device", "cpu", "--compute_dtype", "bfloat16", "--tf_records_dir",
            str(tmp_path / "tfrecords"), "--logs_dir", str(logs), "--epochs", "1",
            "--steps_per_epoch", "2", "--saving_every_n_steps", "2", "--logging_every_n_steps",
            "1", "--summary_every_n_steps", "100"]
    for ov in TINY:
        argv += ["--config_override", ov]
    train_cli.main(argv)
    (path,) = glob.glob(os.path.join(logs, "ckpt_*.pt"))
    state = torch.load(path)
    assert state["step"] == 2
    assert {v.dtype for v in state["params"].values()} == {torch.float32}
    assert {v.dtype for v in state["opt_state"].values()} == {torch.float32}
    assert all(bool(torch.isfinite(v).all()) for v in state["params"].values())
