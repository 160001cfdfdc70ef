"""The port's data parallelism without processes, on the CPU.

- `local_batch_slice`: contiguous rows by rank, an indivisible global
  batch refused (JAX tests/test_multihost.py's `local_batch_slice` case);
- `TrainDraws.rows`: a global batch's draws (B = 4, VGG16's dropout masks
  too) cut in 2 and in 4 concatenate back to the global draws;
- `sample_draws` sizes a batch's draws before `loss_fn` runs: for Faster
  R-CNN (ResNet-50 and VGG16) and FPN (keras and slim) on an odd bucket,
  `loss_fn` takes them (it refuses draws of another anchor count);
- `batched_im_detect(..., data_parallel=2, devices=[cpu, cpu])` gives
  exactly the results of `data_parallel=0` (bit for bit: each replica runs
  the same CPU convolutions on its shard), refuses a batch size that 2
  does not divide, and an N above the CUDA device count;
- the port's `data_parallel=2` against JAX `batched_im_detect(...,
  data_parallel=2)` on a 2-device mesh, on bridged VGG16 weights (the JAX
  init of tests/test_torch_vgg16.py, shared through
  `tests/torch_shared.py`, its caffe-scaled pixels): validity equal, the
  softmax, deltas and rois within JAX's own rtol / atol 1e-5 (observed:
  softmax 1.1e-7, deltas 1.6e-7, rois 6.9e-5 px of ~50).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from tf_eager_object_detection_tpu.evaluation.batched_inference import (
    batched_im_detect as jax_batched_im_detect,
)
from tf_eager_object_detection_tpu.models.model_factory import model_factory as jax_factory
from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
from tf_eager_object_detection_tpu_torch.evaluation.batched_inference import batched_im_detect
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.ops.sampling import TrainDraws
from tf_eager_object_detection_tpu_torch.parallel.multihost import local_batch_slice
from tf_eager_object_detection_tpu_torch.ref_import.from_jax import load_jax_params
from test_torch_vgg16 import _jax_init as vgg16_jax_init
from torch_shared import shared

EVAL_BUCKET = 96
# JAX's own, tests/test_batched_inference.py's data-parallel case
JAX_DP_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("global_batch,world,want", [
    (16, 1, [(0, 16)]),
    (8, 4, [(0, 2), (2, 4), (4, 6), (6, 8)]),
    (6, 2, [(0, 3), (3, 6)]),
])
def test_local_batch_slice_math(global_batch, world, want):
    assert [local_batch_slice(global_batch, r, world) for r in range(world)] == want


@pytest.mark.parametrize("global_batch,world", [(9, 2), (3, 2), (2, 4)])
def test_local_batch_slice_refuses_an_indivisible_batch(global_batch, world):
    with pytest.raises(ValueError, match="not divisible"):
        local_batch_slice(global_batch, 0, world)


@pytest.mark.parametrize("parts", [2, 4])
def test_draw_rows_concatenate_to_the_global_draws(parts):
    s = 6
    draws = TrainDraws.sample(torch.Generator().manual_seed(0), 4, 50, 20, s, dropout=(0.5, 16))
    pieces = [draws.rows(*local_batch_slice(4, r, parts), s) for r in range(parts)]
    for name, whole in zip(TrainDraws._fields, draws):
        dim = 1 if name == "dropout_keep" else 0
        got = torch.cat([getattr(p, name) for p in pieces], dim=dim)
        assert torch.equal(got, whole), name
    assert pieces[0].dropout_keep.shape == (2, 4 // parts * s, 16)
    no_dropout = draws._replace(dropout_keep=None).rows(1, 3, s)
    assert no_dropout.dropout_keep is None and no_dropout.anchor_fg.shape == (2, 50)


def _small_train_config(model_type, **extra):
    cfg = dict(config_factory("pascal", model_type))
    cfg.update(scales=[2, 4, 8], rpn_proposal_train_pre_nms_sample_number=128,
               rpn_proposal_train_after_nms_sample_number=32, rpn_total_sample_number=32,
               rpn_pos_sample_max_number=16, roi_total_sample_number=16,
               roi_pos_sample_max_number=4, tpu_max_gt_boxes=4, **extra)
    return cfg


@pytest.mark.parametrize("model_type,backbone,extra", [
    ("faster_rcnn", "resnet50", {}),
    ("faster_rcnn", "vgg16", {}),
    ("fpn", "resnet50", {}),
    ("fpn", "resnet50", {"tpu_fpn_backbone_style": "slim"}),
], ids=["frcnn_resnet50", "frcnn_vgg16", "fpn_keras", "fpn_slim"])
def test_sample_draws_fit_loss_fn(model_type, backbone, extra):
    """Odd sides (97 x 131: not a multiple of any stride) through every
    rounding of the extractors."""
    det = model_factory(model_type, backbone, _small_train_config(model_type, **extra),
                        device="cpu", seed=0)
    h, w = 97, 131
    rng = np.random.RandomState(0)
    images = rng.randn(2, h, w, 3).astype(np.float32)
    hw = np.asarray([[h, w], [90, 120]], np.int32)
    gt = np.zeros((2, 4, 4), np.float32)
    gt[:, 0] = [10, 12, 60, 70]
    mask = np.zeros((2, 4), bool)
    mask[:, 0] = True
    labels = np.where(mask, 5, 0).astype(np.int32)
    draws = det.sample_draws(torch.Generator().manual_seed(1), 2, (h, w))
    assert (draws.dropout_keep is not None) == (backbone == "vgg16")
    total, _ = det.loss_fn(images, hw, gt, mask, labels, draws)
    assert torch.isfinite(total)
    wrong = det.sample_draws(torch.Generator().manual_seed(1), 2, (h + 32, w))
    with pytest.raises(ValueError, match="draws for"):
        det.loss_fn(images, hw, gt, mask, labels, wrong)


def _eval_config():
    cfg = dict(config_factory("pascal", "faster_rcnn"))
    cfg["tpu_image_buckets"] = [[EVAL_BUCKET, EVAL_BUCKET]]
    cfg["rpn_proposal_test_pre_nms_sample_number"] = 128
    cfg["rpn_proposal_test_after_nms_sample_number"] = 16
    return cfg


def _eval_items(n=7):
    """n images of one bucket (caffe-scaled pixels, valid extents below it)."""
    rng = np.random.RandomState(0)
    return [(rng.randn(EVAL_BUCKET, EVAL_BUCKET, 3).astype(np.float32) * 50.0,
             np.asarray([EVAL_BUCKET, EVAL_BUCKET - 8 * i], np.int32), 1.0 + 0.1 * i)
            for i in range(n)]


@pytest.fixture(scope="module")
def vgg16_flat(tmp_path_factory):
    return shared(tmp_path_factory, "jax_init_faster_rcnn_vgg16_rpn_x20", vgg16_jax_init)


@pytest.fixture(scope="module")
def port_vgg16(vgg16_flat):
    det = model_factory("faster_rcnn", "vgg16", _eval_config(), device="cpu")
    load_jax_params(det, vgg16_flat)
    return det


def test_batched_eval_data_parallel_equals_one_device(port_vgg16):
    items = _eval_items()
    single = {i: out for i, _, out in batched_im_detect(port_vgg16, items, 4)}
    dp = {i: out for i, _, out in batched_im_detect(port_vgg16, items, 4, data_parallel=2,
                                                    devices=["cpu", "cpu"])}
    assert sorted(dp) == sorted(single) == list(range(7))
    for i in single:
        for a, b in zip(single[i], dp[i]):
            assert a.dtype == b.dtype and torch.equal(a, b), i


@pytest.mark.parametrize("batch_size,data_parallel,devices,match", [
    (3, 2, ["cpu", "cpu"], "not divisible"),
    (4, 2, ["cpu"], "with 1 devices"),
    (4, -1, None, "< 0"),
])
def test_batched_eval_data_parallel_refusals(port_vgg16, batch_size, data_parallel, devices,
                                             match):
    with pytest.raises(ValueError, match=match):
        batched_im_detect(port_vgg16, _eval_items(), batch_size, data_parallel, devices)


def test_eval_data_parallel_refuses_more_cuda_devices_than_there_are():
    from tf_eager_object_detection_tpu_torch.parallel.mesh import check_eval_data_parallel

    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"needs {have + 1} CUDA devices"):
        check_eval_data_parallel(8, have + 1, "cuda")
    check_eval_data_parallel(8, 4, "cpu")


def test_batched_eval_data_parallel_matches_jax(vgg16_flat, port_vgg16):
    items = _eval_items()
    jdet = jax_factory("faster_rcnn", "vgg16", _eval_config())
    params = jax.tree_util.tree_map(jnp.asarray, unflatten_dict(vgg16_flat, sep="/"))
    want = {i: [np.asarray(t) for t in out]
            for i, _, out in jax_batched_im_detect(jdet, params, items, 4, data_parallel=2)}
    got = {i: [t.numpy() for t in out]
           for i, _, out in batched_im_detect(port_vgg16, items, 4, data_parallel=2,
                                              devices=["cpu", "cpu"])}
    assert sorted(got) == sorted(want)
    for i in want:
        sm, deltas, rois, valid = got[i]
        jsm, jdeltas, jrois, jvalid = want[i]
        np.testing.assert_array_equal(valid, jvalid)
        for a, b in ((sm, jsm), (deltas, jdeltas), (rois, jrois)):
            np.testing.assert_allclose(a, b, **JAX_DP_TOL)
