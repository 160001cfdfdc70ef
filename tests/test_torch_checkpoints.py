"""The port's checkpoints and its `.npz` bridge to the JAX package, on the CPU.

- `CheckpointManager`: a save and a restore into a fresh detector and
  optimizer give bit-equal parameters (FrozenBatchNorm statistics
  included), momentum traces and step count; `max_to_keep` keeps the
  newest steps; a save at a step already saved does nothing; the trainer's
  restore precedence is an explicit directory, else the latest step in its
  own.
- `save_params` / `load_params` in the JAX package's flat `.npz` format,
  both ways: the JAX `load_params` of the port's file, through JAX
  `predict`, equals the port's `predict`; the port's `load_params` of JAX
  `save_params`' file equals JAX `predict`; trained parameters go port ->
  `.npz` -> JAX -> `.npz` -> port bit for bit.
- `ref_import/cli.py::load_checkpoint_params` reads the two formats; any
  other path without an import flag raises, and a refused or unreadable
  third-party file leaves the detector untouched.

Predictions are compared with the tolerances of tests/test_torch_model.py
(same config, image and score-layer scales): labels and validity exact,
scores atol 1e-4, boxes atol 1e-3 px.
"""

import argparse
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from tf_eager_object_detection_tpu.models.model_factory import model_factory as jax_factory
from tf_eager_object_detection_tpu.training import checkpoints as jax_checkpoints
from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.ref_import.cli import load_checkpoint_params
from tf_eager_object_detection_tpu_torch.ref_import.from_jax import load_jax_params
from tf_eager_object_detection_tpu_torch.training.checkpoints import (
    CheckpointManager,
    load_params,
    save_params,
)
from tf_eager_object_detection_tpu_torch.training.optimizer import make_optimizer
from tf_eager_object_detection_tpu_torch.training.train_step import make_train_step
from tf_eager_object_detection_tpu_torch.training.trainer import Trainer

from test_faster_rcnn import _small_config
from torch_shared import shared

BOX_TOL = dict(rtol=0, atol=1e-3)
SCORE_TOL = dict(rtol=0, atol=1e-4)
RPN_SCORE_SCALE = 5.0
ROI_SCORE_SCALE = 10.0


@pytest.fixture
def tmp_path(tmp_path):
    """A ResNet-50 checkpoint holds hundreds of MB: each test's files go as
    soon as it ends, not with the session's temporary root."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _detector(model_type="faster_rcnn", seed=0):
    return model_factory(model_type, "resnet50", config_factory("pascal", model_type),
                         device="cpu", seed=seed)


def _scramble(det, opt, seed):
    """Random values in every parameter, statistic and trace, and a step
    count, so that a restore that misses anything shows."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in list(det.state_dict().values()) + list(opt.trace.values()):
            t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
    opt.count = 100 + seed


def _state(det, opt):
    return ({k: v.clone() for k, v in det.state_dict().items()},
            {k: v.clone() for k, v in opt.trace.items()}, opt.count)


def _assert_state_equal(got, want):
    for a, b in zip(got[:2], want[:2]):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert got[2] == want[2]


@pytest.mark.parametrize("model_type", ["faster_rcnn", "fpn"])
def test_checkpoint_round_trip_is_bit_equal(tmp_path, model_type):
    det = _detector(model_type)
    opt = make_optimizer(det.cfg, det)
    _scramble(det, opt, 1)
    saved = _state(det, opt)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(det, opt)
    assert mgr.latest_step() == 101

    fresh = _detector(model_type, seed=7)
    fresh_opt = make_optimizer(fresh.cfg, fresh)
    assert CheckpointManager(str(tmp_path)).restore(fresh, fresh_opt) == 101
    _assert_state_equal(_state(fresh, fresh_opt), saved)
    mgr.close()


@pytest.mark.parametrize("max_to_keep", [1, 3])
def test_max_to_keep_keeps_the_newest_steps(tmp_path, max_to_keep):
    det = _detector()
    opt = make_optimizer(det.cfg, det)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=max_to_keep)
    for step in range(1, 6):
        opt.count = step
        mgr.save(det, opt)
    assert mgr.all_steps() == list(range(6 - max_to_keep, 6))
    assert sorted(os.listdir(tmp_path)) == [f"ckpt_{s:08d}.pt" for s in mgr.all_steps()]


def test_save_at_a_saved_step_is_a_no_op(tmp_path):
    det = _detector()
    opt = make_optimizer(det.cfg, det)
    _scramble(det, opt, 2)
    saved = _state(det, opt)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(det, opt)
    _scramble(det, opt, 3)
    opt.count = saved[2]  # the same step, other values
    mgr.save(det, opt)
    assert mgr.all_steps() == [saved[2]]
    mgr.restore(det, opt)
    _assert_state_equal(_state(det, opt), saved)


@pytest.mark.parametrize("case", ["explicit_path", "latest_in_train_dir", "nothing_to_restore"])
def test_trainer_restore_precedence(tmp_path, case):
    """An explicit checkpoint directory wins over the training directory's
    latest step, which wins over the detector's own init from the seed."""
    det = _detector()
    opt = make_optimizer(det.cfg, det)
    train_dir, other = str(tmp_path / "train"), str(tmp_path / "other")
    expected = {}
    if case != "nothing_to_restore":
        for directory, seed in ((train_dir, 4), (other, 5)):
            _scramble(det, opt, seed)
            expected[directory] = _state(det, opt)
            CheckpointManager(directory).save(det, opt)
    restore = other if case == "explicit_path" else None
    fresh = _detector(seed=9)
    trainer = Trainer(fresh, train_dir, restore_ckpt_path=restore, seed=3)
    try:
        got = _state(fresh, trainer.optimizer)
        if case == "nothing_to_restore":
            init = _detector(seed=3)
            assert trainer.step == 0
            for k, v in init.state_dict().items():
                assert torch.equal(got[0][k], v), k
            assert all(not t.any() for t in got[1].values())
        else:
            _assert_state_equal(got, expected[other if restore else train_dir])
    finally:
        trainer.close()


def test_restore_into_another_model_raises(tmp_path):
    det = _detector("fpn")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(det, make_optimizer(det.cfg, det))
    c4 = _detector()
    with pytest.raises(RuntimeError):
        mgr.restore(c4)


def test_optimizer_state_of_other_parameters_raises():
    det = _detector()
    opt = make_optimizer(det.cfg, det)
    state = opt.state_dict()
    state["trace"] = dict(state["trace"])
    state["trace"]["no.such.weight"] = state["trace"].pop(next(iter(state["trace"])))
    with pytest.raises(KeyError):
        opt.load_state_dict(state)


@pytest.mark.parametrize("model_type", ["faster_rcnn", "fpn"])
def test_save_params_round_trips_through_the_port(tmp_path, model_type):
    det = _detector(model_type)
    _scramble(det, make_optimizer(det.cfg, det), 6)
    path = str(tmp_path / "params.npz")
    save_params(path, det)
    fresh = _detector(model_type, seed=8)
    load_params(path, fresh)
    for k, v in det.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


# ------------------------------------------------------------- JAX bridge
def _jax_init():
    jdet = jax_factory("faster_rcnn", "resnet50", _small_config())
    flat = {k: np.array(v) for k, v in
            flatten_dict(jdet.init_params(jax.random.PRNGKey(0)), sep="/").items()}
    flat["rpn_head/rpn_score_conv/kernel"] *= RPN_SCORE_SCALE
    flat["roi_head/roi_head_score/kernel"] *= ROI_SCORE_SCALE
    return flat


@pytest.fixture(scope="module")
def jax_pair(tmp_path_factory):
    """(jax detector, flat JAX init with the score layers scaled, image, hw)."""
    jdet = jax_factory("faster_rcnn", "resnet50", _small_config())
    flat = shared(tmp_path_factory, "torch_checkpoints_jax_init", _jax_init)
    rng = np.random.RandomState(0)
    return jdet, flat, rng.randn(160, 160, 3).astype(np.float32), np.array([144, 128], np.int32)


def _port(flat):
    det = model_factory("faster_rcnn", "resnet50", _small_config(), device="cpu")
    load_jax_params(det, flat)
    return det


def _jax_predict(jdet, params, image, hw):
    params = jax.tree_util.tree_map(jnp.asarray, params)
    return jdet.predict(params, jnp.asarray(image), jnp.asarray(hw))


def _assert_detections_equal(got, ref):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), **SCORE_TOL)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes), **BOX_TOL)
    assert got.valid.numpy().sum() > 0


def _trained(flat):
    """The port from `flat` after one training step on a random batch, at
    lr 1e-5 (at the stock 1e-3 the step drives every foreground score of
    this random network below 1e-38, where XLA:CPU flushes to zero what
    torch keeps as a denormal)."""
    det = _port(flat)
    det.cfg["learning_rate_multi_lrs"] = [1e-5, 1e-6]
    rng = np.random.RandomState(1)
    gt = np.zeros((1, 4, 4), np.float32)
    gt[0, :3] = [[10, 12, 60, 70], [40, 30, 118, 100], [5, 50, 50, 110]]
    batch = (rng.randn(1, 160, 160, 3).astype(np.float32), np.array([[144, 128]], np.int32), gt,
             np.array([[True, True, True, False]]), np.array([[3, 7, 12, 0]], np.int32))
    make_train_step(det, make_optimizer(det.cfg, det))(batch, torch.Generator().manual_seed(0))
    return det


def test_jax_save_params_loads_into_the_port(jax_pair, tmp_path):
    jdet, flat, image, hw = jax_pair
    path = str(tmp_path / "jax.npz")
    jax_checkpoints.save_params(path, unflatten_dict(flat, sep="/"))
    det = model_factory("faster_rcnn", "resnet50", _small_config(), device="cpu", seed=3)
    load_params(path, det)
    _assert_detections_equal(det.predict(image, hw), _jax_predict(jdet, unflatten_dict(
        flat, sep="/"), image, hw))


def test_port_save_params_loads_into_jax(jax_pair, tmp_path):
    """Parameters the port trained, saved by the port, read by the JAX
    `load_params` and served by JAX `predict`."""
    jdet, flat, image, hw = jax_pair
    det = _trained(flat)
    path = str(tmp_path / "port.npz")
    save_params(path, det)
    params = jax_checkpoints.load_params(path)
    assert set(flatten_dict(params, sep="/")) == set(flat)
    _assert_detections_equal(det.predict(image, hw), _jax_predict(jdet, params, image, hw))


def test_trained_params_round_trip_port_jax_port(jax_pair, tmp_path):
    """port -> .npz -> JAX `load_params` -> JAX `save_params` -> port: bit for bit."""
    _, flat, _, _ = jax_pair
    det = _trained(flat)
    save_params(str(tmp_path / "a.npz"), det)
    jax_checkpoints.save_params(str(tmp_path / "b.npz"),
                                jax_checkpoints.load_params(str(tmp_path / "a.npz")))
    back = model_factory("faster_rcnn", "resnet50", _small_config(), device="cpu", seed=4)
    load_params(str(tmp_path / "b.npz"), back)
    for k, v in det.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def test_save_params_writes_the_jax_layout(jax_pair, tmp_path):
    """The port's file of a JAX init holds JAX's keys, shapes and values."""
    _, flat, _, _ = jax_pair
    save_params(str(tmp_path / "p.npz"), _port(flat))
    with np.load(str(tmp_path / "p.npz")) as got:
        assert set(got.files) == set(flat)
        for k, v in flat.items():
            assert got[k].dtype == np.float32 and np.array_equal(got[k], v), k


# ------------------------------------------------- load_checkpoint_params
def _args(**flags):
    return argparse.Namespace(**{**{f: False for f in (
        "use_tf_faster_rcnn_model", "use_fpn_tensorflow_model", "keras_h5")}, **flags})


@pytest.mark.parametrize("fmt", ["checkpoint_dir", "npz"])
def test_load_checkpoint_params_reads_the_port_formats(tmp_path, fmt):
    det = _detector()
    opt = make_optimizer(det.cfg, det)
    _scramble(det, opt, 10)
    if fmt == "npz":
        ckpt = str(tmp_path / "params.npz")
        save_params(ckpt, det)
    else:
        ckpt = str(tmp_path / "logs")
        CheckpointManager(ckpt).save(det, opt)
    fresh = _detector(seed=11)
    assert load_checkpoint_params(fresh, ckpt, _args()) is None
    for k, v in det.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


@pytest.mark.parametrize("case", ["tf_checkpoint_prefix", "keras_h5_flag", "fpn_tensorflow_flag",
                                  "tf_faster_rcnn_flag"])
def test_load_checkpoint_params_other_formats_name_item_9(tmp_path, case):
    """What is neither a checkpoint of the port nor a `.npz` (a TF prefix
    without its flag) raises FileNotFoundError naming the import flags; a
    third-party flag on a missing file raises from its reader (h5py's
    OSError, tensorflow's NotFoundError), and FPN's
    flag on Faster R-CNN refuses before reading; the detector is untouched.
    (The importers themselves: tests/test_torch_ref_import.py.)"""
    pytest.importorskip("h5py")
    pytest.importorskip("tensorflow")
    path = str(tmp_path / "model.ckpt")
    args = _args(**{"keras_h5_flag": {"keras_h5": True},
                    "fpn_tensorflow_flag": {"use_fpn_tensorflow_model": True},
                    "tf_faster_rcnn_flag": {"use_tf_faster_rcnn_model": True}}.get(case, {}))
    error, match = {"tf_checkpoint_prefix": (FileNotFoundError, "--keras_h5"),
                    "keras_h5_flag": (OSError, None),
                    "fpn_tensorflow_flag": (ValueError, "model_type fpn"),
                    "tf_faster_rcnn_flag": (Exception, "Failed to find any matching files")}[case]
    det = _detector()
    before = {k: v.clone() for k, v in det.state_dict().items()}
    with pytest.raises(error, match=match):
        load_checkpoint_params(det, path, args)
    assert all(torch.equal(v, before[k]) for k, v in det.state_dict().items())


def test_load_checkpoint_params_of_an_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint_params(_detector(), str(tmp_path), _args())
