"""The port's learning-rate schedule, momentum optimizer and freeze / decay
masks against the JAX package's, on the CPU.

- LR: the piecewise schedule at step 0 and at, before and after every
  boundary (the +1 shift), equal as float32 values.
- Three momentum steps across an LR boundary on a small parameter tree
  (a frozen conv1 / conv2 stack for Faster R-CNN, a BatchNorm, a trainable
  conv, the RPN's conv and a dense layer), with the same random gradients:
  against JAX `make_optimizer` as the fused rule and as the optax chain,
  with `learning_rate_bias_double` both ways. Parameters and momentum
  traces within rtol 1e-6, atol 1e-9: both run the same float32 operations
  in the same order, so only the placement of a rounding may differ.
  Frozen tensors must not move at all.
- Three Adam steps across the same boundary against JAX's optax chain,
  parameters and both moments within the same tolerance; a momentum or
  Adam state restored from a checkpoint continues bit-equal.
- The trainable and weight-decay masks of the port's Faster R-CNN and FPN
  ResNet-50 against JAX's masks of the same models (exact), and the VGG16
  policy as a predicate.
"""

import jax
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from torch import nn

from tf_eager_object_detection_tpu.config.config_factory import config_factory as jax_config
from tf_eager_object_detection_tpu.models import freeze as jax_freeze
from tf_eager_object_detection_tpu.models.model_factory import model_factory as jax_factory
from tf_eager_object_detection_tpu.training.optimizer import make_lr_schedule as jax_schedule
from tf_eager_object_detection_tpu.training.optimizer import make_optimizer as jax_optimizer
from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
from tf_eager_object_detection_tpu_torch.models.freeze import (
    freeze_,
    is_frozen,
    trainable_mask,
    weight_decay_mask,
)
from tf_eager_object_detection_tpu_torch.models.layers import FrozenBatchNorm
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.ref_import.from_jax import (
    load_jax_params,
    parameter_tree_from_jax,
)
from tf_eager_object_detection_tpu_torch.training.checkpoints import CheckpointManager
from tf_eager_object_detection_tpu_torch.training.optimizer import (
    AdamOptimizer,
    make_lr_schedule,
    make_optimizer,
)

STEP_TOL = dict(rtol=1e-6, atol=1e-9)
_BN = ("gamma", "beta", "moving_mean", "moving_variance")


def _port_name(path: str) -> str:
    *scope, leaf = path.split("/")
    return ".".join(scope) + "." + ("weight" if leaf == "kernel" else leaf)


# ------------------------------------------------------------------------ LR
LR_CONFIGS = {
    "fpn": dict(config_factory("pascal", "fpn")),
    "faster_rcnn": dict(config_factory("pascal", "faster_rcnn")),
    "three_boundaries": dict(learning_rate_multi_decay_steps=[5, 9, 20],
                             learning_rate_multi_lrs=[0.02, 0.004, 3e-4, 1e-5]),
}


@pytest.mark.parametrize("name", sorted(LR_CONFIGS))
def test_lr_schedule_matches_jax(name):
    cfg = LR_CONFIGS[name]
    ours, theirs = make_lr_schedule(cfg), jax_schedule(cfg)
    steps = {0}
    for s in cfg["learning_rate_multi_decay_steps"]:
        steps |= {s - 1, s, s + 1, s + 2}
    for step in sorted(steps):
        assert np.float32(ours(step)) == np.asarray(theirs(step)), step
    lrs = cfg["learning_rate_multi_lrs"]
    for i, s in enumerate(cfg["learning_rate_multi_decay_steps"]):
        # the value before a boundary holds through it, and switches one step later
        np.testing.assert_allclose(ours(s), lrs[i], rtol=1e-6)
        np.testing.assert_allclose(ours(s + 1), lrs[i + 1], rtol=1e-6)


# ---------------------------------------------------------------- optimizer
def _toy_tree(rng):
    """A flat flax tree: frozen conv1 / conv2 (Faster R-CNN), a BatchNorm, a
    trainable conv3, the RPN's first conv and a dense layer."""
    shapes = {
        "extractor/conv1_conv/kernel": (3, 3, 3, 4), "extractor/conv1_conv/bias": (4,),
        "extractor/conv2_block1_1_conv/kernel": (1, 1, 4, 4),
        "extractor/conv2_block1_1_conv/bias": (4,),
        "extractor/conv3_block1_1_conv/kernel": (1, 1, 4, 8),
        "extractor/conv3_block1_1_conv/bias": (8,),
        "rpn_head/rpn_first_conv/kernel": (3, 3, 8, 8), "rpn_head/rpn_first_conv/bias": (8,),
        "roi_head/fc1/kernel": (8, 6), "roi_head/fc1/bias": (6,),
    }
    shapes.update({f"extractor/conv1_bn/{leaf}": (4,) for leaf in _BN})
    return {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}


class _Toy(nn.Module):
    """The port's modules under the toy tree's names."""

    def __init__(self, model_type):
        super().__init__()
        self.backbone_name, self.model_type = "resnet50", model_type
        self.extractor = nn.Module()
        self.extractor.conv1_conv = nn.Conv2d(3, 4, 3)
        self.extractor.conv1_bn = FrozenBatchNorm(4)
        self.extractor.conv2_block1_1_conv = nn.Conv2d(4, 4, 1)
        self.extractor.conv3_block1_1_conv = nn.Conv2d(4, 8, 1)
        self.rpn_head = nn.Module()
        self.rpn_head.rpn_first_conv = nn.Conv2d(8, 8, 3)
        self.roi_head = nn.Module()
        self.roi_head.fc1 = nn.Linear(8, 6)


@pytest.mark.parametrize("bias_double", [False, True], ids=["bias_x1", "bias_x2"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "optax_chain"])
@pytest.mark.parametrize("model_type", ["faster_rcnn", "fpn"])
def test_three_momentum_steps_across_a_boundary_match_jax(model_type, fused, bias_double):
    cfg = dict(weight_decay=0.01, optimizer_momentum=0.9, learning_rate_bias_double=bias_double,
               learning_rate_multi_decay_steps=[1], learning_rate_multi_lrs=[0.1, 0.01],
               tpu_fused_optimizer=fused)
    rng = np.random.RandomState(0)
    flat = _toy_tree(rng)
    params = jax.tree_util.tree_map(jax.numpy.asarray, unflatten_dict(flat, sep="/"))
    frozen = {k for k, v in flatten_dict(
        jax_freeze.trainable_mask(params, "resnet50", model_type), sep="/").items() if not v}

    toy = _Toy(model_type)
    load_jax_params(toy, flat)
    freeze_(toy)
    opt = make_optimizer(cfg, toy)
    jopt = jax_optimizer(cfg, params, "resnet50", model_type)
    state = jopt.init(params)
    for step in range(3):
        # frozen leaves get no gradient (JAX stops it, the port has none)
        grads = {k: np.zeros_like(v) if k in frozen else rng.randn(*v.shape).astype(np.float32)
                 for k, v in flat.items()}
        updates, state = jopt.update(
            jax.tree_util.tree_map(jax.numpy.asarray, unflatten_dict(grads, sep="/")),
            state, params)
        params = optax.apply_updates(params, updates)
        port_grads = parameter_tree_from_jax(grads)
        for name, p in toy.named_parameters():
            p.grad = port_grads[name].clone() if p.requires_grad else None
        assert opt.lr == pytest.approx(0.1 if step < 2 else 0.01, rel=1e-6)
        opt.step()

    want = parameter_tree_from_jax({k: np.asarray(v) for k, v in
                                    flatten_dict(params, sep="/").items()})
    got = dict(toy.named_parameters())
    trace_tree = state.trace if fused else state[0][-1][0].trace
    want_trace = parameter_tree_from_jax({k: np.asarray(v) for k, v in
                                          flatten_dict(trace_tree, sep="/").items()})
    assert set(opt.trace) == {n for n, p in got.items() if p.requires_grad}
    start = parameter_tree_from_jax(flat)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(), **STEP_TOL,
                                   err_msg=name)
        moved = not torch.equal(got[name].detach(), start[name])
        assert moved == (name in opt.trace), name  # frozen tensors stay put
    for name, t in opt.trace.items():
        np.testing.assert_allclose(t.numpy(), want_trace[name].numpy(), **STEP_TOL, err_msg=name)
    frozen_names = {n for n, p in got.items() if not p.requires_grad}
    assert frozen_names == ({"extractor.conv1_conv.weight", "extractor.conv1_conv.bias",
                             "extractor.conv2_block1_1_conv.weight",
                             "extractor.conv2_block1_1_conv.bias"}
                            if model_type == "faster_rcnn" else set())


@pytest.mark.parametrize("bias_double", [False, True], ids=["bias_x1", "bias_x2"])
@pytest.mark.parametrize("model_type", ["faster_rcnn", "fpn"])
def test_three_adam_steps_across_a_boundary_match_jax(model_type, bias_double):
    """`optimizer_type='adam'` against JAX's optax chain (decay, bias x2,
    `optax.adam`, frozen -> 0) over three steps with the same random
    gradients: the learning rate of the first step and of the step after
    the boundary (the third: the schedule reads the count of the steps
    before), the parameters and both moments within STEP_TOL (the same
    float32 operations; the bias corrections' powers may round apart in
    the last bit); frozen tensors do not move and have no moments."""
    cfg = dict(weight_decay=0.01, optimizer_momentum=0.9, learning_rate_bias_double=bias_double,
               learning_rate_multi_decay_steps=[1], learning_rate_multi_lrs=[0.1, 0.01],
               optimizer_type="adam")
    rng = np.random.RandomState(1)
    flat = _toy_tree(rng)
    params = jax.tree_util.tree_map(jax.numpy.asarray, unflatten_dict(flat, sep="/"))
    frozen = {k for k, v in flatten_dict(
        jax_freeze.trainable_mask(params, "resnet50", model_type), sep="/").items() if not v}
    toy = _Toy(model_type)
    load_jax_params(toy, flat)
    freeze_(toy)
    opt = make_optimizer(cfg, toy)
    jopt = jax_optimizer(cfg, params, "resnet50", model_type)
    state = jopt.init(params)
    for step in range(3):
        grads = {k: np.zeros_like(v) if k in frozen else rng.randn(*v.shape).astype(np.float32)
                 for k, v in flat.items()}
        updates, state = jopt.update(
            jax.tree_util.tree_map(jax.numpy.asarray, unflatten_dict(grads, sep="/")),
            state, params)
        params = optax.apply_updates(params, updates)
        port_grads = parameter_tree_from_jax(grads)
        for name, p in toy.named_parameters():
            p.grad = port_grads[name].clone() if p.requires_grad else None
        assert opt.lr == pytest.approx(0.1 if step < 2 else 0.01, rel=1e-6)
        assert np.float32(opt.lr) == np.asarray(jax_schedule(cfg)(step))
        opt.step()
    assert opt.count == 3
    want = parameter_tree_from_jax({k: np.asarray(v) for k, v in
                                    flatten_dict(params, sep="/").items()})
    got = dict(toy.named_parameters())
    start = parameter_tree_from_jax(flat)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(), **STEP_TOL,
                                   err_msg=name)
        assert (not torch.equal(got[name].detach(), start[name])) == got[name].requires_grad
    adam = [leaf for leaf in jax.tree_util.tree_leaves(state, is_leaf=lambda x: hasattr(x, "nu"))
            if hasattr(leaf, "nu")][0]
    assert int(adam.count) == 3
    for slot in ("mu", "nu"):
        theirs = parameter_tree_from_jax({k: np.asarray(v) for k, v in
                                          flatten_dict(getattr(adam, slot), sep="/").items()})
        mine = getattr(opt, slot)
        assert set(mine) == {n for n, p in got.items() if p.requires_grad}
        for name, t in mine.items():
            np.testing.assert_allclose(t.numpy(), theirs[name].numpy(), **STEP_TOL,
                                       err_msg=f"{slot} {name}")


@pytest.mark.parametrize("opt_type", ["momentum", "adam"])
def test_restored_optimizer_continues_bit_equal(tmp_path, opt_type):
    """The trainer's restore path (`CheckpointManager.save` / `restore`, as
    `Trainer` runs it): after one step and a save, a fresh model and
    optimizer restored from the checkpoint take the next step bit-equal to
    the ones that wrote it (parameters, every state slot, the count)."""
    cfg = dict(weight_decay=0.01, optimizer_momentum=0.9, learning_rate_bias_double=True,
               learning_rate_multi_decay_steps=[1], learning_rate_multi_lrs=[0.1, 0.01],
               optimizer_type=opt_type)
    rng = np.random.RandomState(2)
    models = []
    for _ in range(2):
        toy = _Toy("faster_rcnn")
        load_jax_params(toy, _toy_tree(rng))
        freeze_(toy)
        models.append((toy, make_optimizer(cfg, toy)))
    grads = [parameter_tree_from_jax({k: rng.randn(*v.shape).astype(np.float32)
                                      for k, v in _toy_tree(rng).items()}) for _ in range(2)]

    def step(toy, opt, g):
        for name, p in toy.named_parameters():
            p.grad = g[name].clone() if p.requires_grad else None
        opt.step()

    (first, first_opt), (second, second_opt) = models
    step(first, first_opt, grads[0])
    CheckpointManager(str(tmp_path)).save(first, first_opt)
    assert CheckpointManager(str(tmp_path)).restore(second, second_opt) == 1
    for toy, opt in models:
        step(toy, opt, grads[1])
    assert first_opt.count == second_opt.count == 2
    for name, v in first.state_dict().items():
        assert torch.equal(second.state_dict()[name], v), name
    a, b = first_opt.state_dict(), second_opt.state_dict()
    assert a.keys() == b.keys() == set(type(first_opt).SLOTS) | {"count"}
    for slot in type(first_opt).SLOTS:
        for name, t in a[slot].items():
            assert torch.equal(b[slot][name], t), (slot, name)


@pytest.mark.parametrize("opt_type,error", [("adam", None), ("sgd", ValueError)])
def test_make_optimizer_refuses_what_is_not_ported(opt_type, error):
    """Adam is ported; any other type than momentum or adam raises."""
    cfg = dict(LR_CONFIGS["fpn"], optimizer_type=opt_type)
    if error is None:
        assert isinstance(make_optimizer(cfg, _Toy("fpn")), AdamOptimizer)
        return
    with pytest.raises(error, match="momentum"):
        make_optimizer(cfg, _Toy("fpn"))


# -------------------------------------------------------------------- masks
@pytest.mark.parametrize("model_type", ["faster_rcnn", "fpn"])
def test_freeze_and_decay_masks_match_jax(model_type):
    cfg = dict(jax_config("pascal", model_type))
    shapes = jax.eval_shape(jax_factory(model_type, "resnet50", cfg).init_params,
                            jax.random.PRNGKey(0))
    jt = flatten_dict(jax_freeze.trainable_mask(shapes, "resnet50", model_type), sep="/")
    jd = flatten_dict(jax_freeze.weight_decay_mask(shapes, "resnet50", model_type), sep="/")
    det = model_factory(model_type, "resnet50", dict(config_factory("pascal", model_type)),
                        device="cpu")
    tm, dm = trainable_mask(det), weight_decay_mask(det)
    want_t = {_port_name(k): v for k, v in jt.items() if k.rsplit("/", 1)[-1] not in _BN}
    want_d = {_port_name(k): v for k, v in jd.items() if k.rsplit("/", 1)[-1] not in _BN}
    assert tm == want_t
    assert dm == want_d
    assert {n: p.requires_grad for n, p in det.named_parameters()} == want_t
    # every BatchNorm is frozen in JAX; in the port it has no parameter at all
    assert not any(v for k, v in jt.items() if k.rsplit("/", 1)[-1] in _BN)
    assert any(not v for v in tm.values()) == (model_type == "faster_rcnn")
    assert not any(n.endswith(".bias") for n, v in dm.items() if v)


VGG_NAMES = ["extractor/block1_conv1/kernel", "extractor/block2_conv2/bias",
             "extractor/block3_conv1/kernel", "extractor/block5_conv3/bias",
             "rpn_head/rpn_first_conv/kernel", "roi_head/fc6/kernel"]


@pytest.mark.parametrize("model_type", ["faster_rcnn", "fpn"])
def test_vgg16_freeze_policy_matches_jax(model_type):
    tree = unflatten_dict({k: 0.0 for k in VGG_NAMES}, sep="/")
    want = flatten_dict(jax_freeze.trainable_mask(tree, "vgg16", model_type), sep="/")
    for path in VGG_NAMES:
        assert (not is_frozen(_port_name(path), "vgg16", model_type)) == want[path], path
