"""FPN RoIAlign of the port against the JAX package, on the CPU.

The plain PyTorch version of the fused-pyramid kernel K4
(`roi_align_multilevel_reference`) and the port's `roi_crop_fpn` against:

- the Pallas kernel `pallas_roi_align_multilevel` (and the single-level
  `pallas_roi_align_window`) in interpret mode, for rois that fit its
  64-cell window, one image per Pallas call (see the first test);
- JAX `FPNDetector._roi_features` on its default einsum path (pooled 7x7),
  everywhere, including a roi too long for the Pallas window. The einsum
  path scales boxes by (vh-1)/((h-1)*ih) and then by (h-1), the kernel by
  (vh-1)/ih, so the two sample a few ulps apart;
- JAX `roi_crop_fpn`.

Tolerances. XLA:CPU contracts the JAX coordinate arithmetic into fused
multiply-adds, so even where the formulas are the same the oracle's sample
coordinates differ from the port's by an ulp; a sample's value moves by that
much times the difference of its taps (up to ~5 on N(0, 1) features). On
planes of a 64x64 bucket (coordinates below 16 cells, ulp <= 1e-6) every
comparison holds at atol/rtol 1e-5 (observed <= 5e-6). The elongated roi
needs a plane wider than 64 cells; there (coordinates up to 176 cells, ulp
1.5e-5) the einsum comparison holds at atol 1e-4 (observed <= 6.1e-5). On
the card, where the plain version and the kernel round every operation
alike, `tests/test_torch_roi_align_cuda.py` holds them at 1e-5 at full size.

Inputs are N(0, 1) features and uniform rois from numpy seeds; C = 16.
The wrapper of the CUDA kernel is checked for what it refuses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_eager_object_detection_tpu.config.config_factory import config_factory as jax_config
from tf_eager_object_detection_tpu.models.model_factory import model_factory as jax_factory
from tf_eager_object_detection_tpu.ops.pallas.roi_align_pallas import (
    pallas_roi_align_multilevel,
    pallas_roi_align_window,
)
from tf_eager_object_detection_tpu.ops.roi_align import roi_crop_fpn as jax_roi_crop_fpn
from tf_eager_object_detection_tpu_torch.ops import roi_align as port
from tf_eager_object_detection_tpu_torch.ops.kernels.roi_align_cuda import ROI_ALIGN_KERNEL

TOL = dict(rtol=1e-5, atol=1e-5)
WIDE_TOL = dict(rtol=1e-5, atol=1e-4)  # planes wider than 64 cells, see above
BUCKET = (64, 64)
STRIDES = (4, 8, 16, 32)
C = 16


def _planes(rng, b, bucket, strides=STRIDES, c=C):
    return [rng.randn(b, -(-bucket[0] // s), -(-bucket[1] // s), c).astype(np.float32)
            for s in strides]


def _rois(rng, b, n, h, w, min_side=4.0, max_side=140.0):
    """xyxy rois inside an h x w image."""
    x1 = rng.uniform(0, w - min_side, (b, n))
    y1 = rng.uniform(0, h - min_side, (b, n))
    x2 = np.minimum(x1 + rng.uniform(min_side, max_side, (b, n)), w - 1)
    y2 = np.minimum(y1 + rng.uniform(min_side, max_side, (b, n)), h - 1)
    return np.stack([x1, y1, x2, y2], -1).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_plain_k4_matches_pallas_interpret(seed):
    """Padded planes (valid extent < grid), B=2, 4 levels, an invalid roi
    (the setup of tests/test_roi_align_pallas.py, at four levels)."""
    rng = np.random.RandomState(seed)
    b, n = 2, 8
    p_list = _planes(rng, b, BUCKET)
    ih = np.asarray([58.0, 44.0], np.float32)
    iw = np.asarray([59.0, 34.0], np.float32)
    rois = _rois(rng, b, n, 44, 34, max_side=40.0)
    levels = rng.randint(0, 4, (b, n))
    valid = np.ones((b, n), bool)
    valid[1, -1] = False
    # one Pallas call per image: the Pallas kernel folds the batch into the
    # rows of one plane and adds b * rows to image b's sample coordinates
    # before it subtracts the window origin, which rounds them to a coarser
    # ulp; at b = 0 the fold is exact
    want = np.concatenate([np.asarray(pallas_roi_align_multilevel(
        tuple(jnp.asarray(p[i:i + 1]) for p in p_list), jnp.asarray(rois[i:i + 1]),
        jnp.asarray(levels[i:i + 1]), jnp.asarray(ih[i:i + 1]), jnp.asarray(iw[i:i + 1]), 14,
        strides=STRIDES, valid=jnp.asarray(valid[i:i + 1].astype(np.int32)), interpret=True,
    )) for i in range(b)])
    got = port.roi_align_multilevel_reference(
        _t(*p_list), *_t(rois, levels, valid, ih, iw), 14, STRIDES
    ).numpy()
    assert got.shape == (b, n, 14, 14, C)
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[1, -1].any()
    assert np.abs(got[valid]).max(axis=(1, 2, 3)).min() > 0


@pytest.mark.parametrize("stride", [4, 16])
def test_plain_k4_with_one_level_is_the_single_level_kernel(stride):
    """K2 (`pallas_roi_align_window` with `level_stride`) is K4 with one plane."""
    rng = np.random.RandomState(stride)
    b, n = 2, 6
    (feat,) = _planes(rng, b, BUCKET, strides=(stride,))
    ih = np.asarray([62.0, 50.0], np.float32)
    iw = np.asarray([64.0, 41.0], np.float32)
    rois = _rois(rng, b, n, 50, 41, max_side=40.0)
    active = np.ones((b, n), bool)
    active[0, 2] = False
    want = np.concatenate([np.asarray(pallas_roi_align_window(  # per image, as above
        jnp.asarray(feat[i:i + 1]), jnp.asarray(rois[i:i + 1]),
        jnp.asarray(active[i:i + 1].astype(np.int32)), jnp.asarray(ih[i:i + 1]),
        jnp.asarray(iw[i:i + 1]), 14, interpret=True, level_stride=stride,
    )) for i in range(b)])
    got = port.roi_align_multilevel_reference(
        _t(feat), *_t(rois, np.zeros((b, n), np.int64), active, ih, iw), 14, (stride,)
    ).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _detector_fixture(seed, bucket, hw, extra):
    """Planes of `bucket` and random rois inside the image, plus `extra`."""
    rng = np.random.RandomState(seed)
    p_list = _planes(rng, 1, bucket)
    rois = _rois(rng, 1, 12, hw[0], hw[1], max_side=max(hw) / 2)[0]
    return [p[0] for p in p_list], np.concatenate([rois, np.asarray(extra, np.float32)])


def _level_margin(rois):
    """Distance of each roi's unrounded level to the nearest integer."""
    r = rois.astype(np.float64)
    v = 4.0 + np.log2(np.sqrt(np.maximum(r[..., 2] - r[..., 0], 0)
                              * np.maximum(r[..., 3] - r[..., 1], 0) + 1e-8) / 224.0)
    return np.abs(v - np.round(v))


def _check_against_roi_features(p_list, rois, hw, tol):
    """plain K4 + max_pool_2x2_same == JAX `_roi_features` (default einsum
    path) on every roi; the levels are JAX's own."""
    jdet = jax_factory("fpn", "resnet50", dict(jax_config("pascal", "fpn")))
    assert _level_margin(rois).min() > 1e-4
    want = np.asarray(jdet._roi_features(tuple(jnp.asarray(p) for p in p_list),
                                         jnp.asarray(rois), jnp.asarray(hw, jnp.int32)))
    levels = np.asarray(jdet._roi_levels(jnp.asarray(rois))) - jdet.min_level
    crops = port.roi_align_multilevel_reference(
        _t(*[p[None] for p in p_list]),
        *_t(rois[None], levels[None].astype(np.int64), np.ones((1, len(rois)), bool),
            np.asarray([hw[0]], np.float32), np.asarray([hw[1]], np.float32)),
        14, STRIDES,
    )
    got = port.max_pool_2x2_same(crops)[0].numpy()
    assert got.shape == want.shape == (len(rois), 7, 7, C)
    np.testing.assert_allclose(got, want, **tol)
    return levels


@pytest.mark.parametrize("hw", [(64, 64), (60, 52), (41, 63)])
def test_plain_k4_pooled_matches_jax_roi_features(hw):
    """Small planes; the rois include the whole valid extent (on its edges),
    its bottom-right corner and a point."""
    h, w = hw
    extra = [[0.0, 0.0, w - 1.0, h - 1.0], [w - 9.0, h - 7.0, w - 1.0, h - 1.0],
             [20.0, 20.0, 20.0, 20.0]]
    p_list, rois = _detector_fixture(h * w, BUCKET, hw, extra)
    _check_against_roi_features(p_list, rois, hw, TOL)


@pytest.mark.parametrize("hw", [(320, 704), (300, 640), (250, 333)])
def test_plain_k4_pooled_matches_jax_roi_features_elongated(hw):
    """A roi of aspect > 10 spanning more than the Pallas kernel's 64-cell
    window at P2, with the image's edges and corner, on a 320x704 bucket."""
    h, w = hw
    extra = [[0.0, 0.0, w - 1.0, h - 1.0], [w - 30.0, h - 20.0, w - 1.0, h - 1.0],
             [5.0, 10.0, min(605.0, w - 1.0), 30.0]]
    assert (extra[2][2] - extra[2][0]) / 4 > 64 and (extra[2][2] - extra[2][0]) / 20 > 10
    p_list, rois = _detector_fixture(h + w, (320, 704), hw, extra)
    levels = _check_against_roi_features(p_list, rois, hw, WIDE_TOL)
    assert levels[-1] == 0 and set(levels.tolist()) >= {0, 1}


@pytest.mark.parametrize("stride", STRIDES)
def test_roi_crop_fpn_matches_jax(stride):
    rng = np.random.RandomState(stride + 100)
    b, n = 2, 7
    (feat,) = _planes(rng, b, BUCKET, strides=(stride,))
    hws = np.asarray([[62, 60], [50, 64]], np.int32)
    rois = _rois(rng, b, n, 50, 60, max_side=40.0)
    got = port.roi_crop_fpn(
        *_t(feat, rois, hws[:, 0], hws[:, 1]), pool_size=7, level_stride=stride
    ).numpy()
    for i in range(b):
        want = np.asarray(jax_roi_crop_fpn(
            jnp.asarray(feat[i]), jnp.asarray(rois[i]), hws[i, 0], hws[i, 1], 7,
            level_stride=stride,
        ))
        np.testing.assert_allclose(got[i], want, **TOL)


def test_invalid_and_unassigned_rois_give_zeros():
    rng = np.random.RandomState(3)
    p_list = _planes(rng, 1, (128, 128))
    rois = _rois(rng, 1, 4, 128, 128)
    levels = np.asarray([[0, 4, -1, 1]])  # 4 and -1 match no plane
    valid = np.asarray([[True, True, True, False]])
    ext = np.asarray([128.0], np.float32)
    got = port.roi_align_multilevel_reference(
        _t(*p_list), *_t(rois, levels, valid, ext, ext), 14, STRIDES
    ).numpy()[0]
    assert np.abs(got[0]).sum() > 0
    assert not got[1:].any()


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.RandomState(4)
    p_list = _planes(rng, 2, (128, 160))
    rois = _rois(rng, 2, 5, 120, 150)
    levels = rng.randint(0, 4, (2, 5))
    valid = rng.uniform(size=(2, 5)) > 0.2
    ext_h = np.asarray([120.0, 128.0], np.float32)
    ext_w = np.asarray([150.0, 160.0], np.float32)
    args = (_t(*p_list), *_t(rois, levels, valid, ext_h, ext_w), 14, STRIDES)
    before = ROI_ALIGN_KERNEL.launches
    got = port.roi_align_multilevel(*args)
    assert ROI_ALIGN_KERNEL.launches == before
    torch.testing.assert_close(got, port.roi_align_multilevel_reference(*args), rtol=0, atol=0)


def _guard_args(**change):
    p = [torch.zeros(1, 8, 8, 4), torch.zeros(1, 4, 4, 4)]
    args = dict(p_list=p, rois=torch.zeros(1, 3, 4), levels=torch.zeros(1, 3, dtype=torch.long),
                valid=torch.ones(1, 3, dtype=torch.bool), image_height=torch.full((1,), 30.0),
                image_width=torch.full((1,), 30.0), crop_size=14, strides=(4, 8))
    args.update(change)
    return args


@pytest.mark.parametrize("change,error,match", [
    (dict(p_list=[torch.zeros(1, 8, 8, 4, dtype=torch.float64), torch.zeros(1, 4, 4, 4)]),
     TypeError, "dtypes"),
    (dict(levels=torch.zeros(1, 3, dtype=torch.int32)), TypeError, "dtypes"),
    (dict(valid=torch.ones(1, 3)), TypeError, "dtypes"),
    (dict(rois=torch.zeros(1, 3, 5)), ValueError, r"\[B, N, 4\]"),
    (dict(p_list=[torch.zeros(1, 8, 8, 4), torch.zeros(1, 4, 4, 8)]), ValueError, "one C"),
    (dict(p_list=[torch.zeros(2, 8, 8, 4), torch.zeros(2, 4, 4, 4)]), ValueError, "one C"),
    (dict(levels=torch.zeros(1, 2, dtype=torch.long)), ValueError, "levels and valid"),
    (dict(image_width=torch.full((2,), 30.0)), ValueError, "image extents"),
    (dict(strides=(4,)), ValueError, "one stride each"),
    (dict(crop_size=1), ValueError, "crop_size"),
    (dict(crop_size=65), ValueError, "crop_size"),
    ({}, ValueError, "CUDA tensors"),
])
def test_cuda_wrapper_refuses(change, error, match):
    """Types, then shapes, then the device: every refusal comes before any
    build or launch, so it shows here without a card or nvcc."""
    before = ROI_ALIGN_KERNEL.launches
    with pytest.raises(error, match=match):
        ROI_ALIGN_KERNEL(**_guard_args(**change))
    assert ROI_ALIGN_KERNEL.launches == before
