"""RoIAlign gradients of the port against the JAX package, on the CPU.

The plain versions of the backward kernels, K5 (fused pyramid,
`roi_align_multilevel_reference_backward`) and K3 (single level, autograd
through `roi_align_single_level`), and the plain single-level forward K2,
against:

- `jax.grad` through the Pallas kernels in interpret mode:
  `pallas_roi_align_multilevel` (forward `_ml_kernel`, VJP `_ml_bwd_kernel`)
  and `pallas_roi_align_window` with `level_stride` (forward `_kernel`, VJP
  `_bwd_kernel`), one image per Pallas call (the kernels fold the batch
  into the rows of one plane, which rounds image b > 0's coordinates to a
  coarser ulp; see tests/test_torch_roi_align_fpn.py);
- `jax.grad` through JAX `FPNDetector._roi_features_batched` on its default
  einsum path (the path JAX trains with), pooled 7x7, with JAX's levels;
  including a roi longer than the Pallas kernels' 64-cell window.

Fixtures: B = 2, image extents below the planes, invalid / inactive rois,
rois piled on a few cells, and a roi of aspect > 10.

Tolerances, as in tests/test_torch_roi_align_fpn.py: on planes of a 64x64
bucket (coordinates below 16 cells, one ulp <= 1e-6) forward and gradients
hold at atol/rtol 1e-5: XLA:CPU contracts the coordinate arithmetic into
fused multiply-adds, so a sample lies an ulp away from the port's and its
weights move by that much. The
elongated roi needs a 320x704 bucket (coordinates up to 176 cells, ulp
1.5e-5): there atol 1e-4, relative to gradients of order 10.
"""

import jax
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
from tf_eager_object_detection_tpu_torch.ops import roi_align as port
from tf_eager_object_detection_tpu_torch.ops.kernels.roi_align_backward_cuda import (
    ROI_ALIGN_BACKWARD_KERNEL,
    ROI_ALIGN_SINGLE_BACKWARD_KERNEL,
)

TOL = dict(rtol=1e-5, atol=1e-5)
WIDE_TOL = dict(rtol=1e-5, atol=1e-4)
BUCKET = (64, 64)
STRIDES = (4, 8, 16, 32)
C = 8
IH = np.asarray([58.0, 44.0], np.float32)  # valid extents below the bucket
IW = np.asarray([59.0, 34.0], np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _planes(rng, b, bucket, strides=STRIDES):
    return [rng.randn(b, -(-bucket[0] // s), -(-bucket[1] // s), C).astype(np.float32)
            for s in strides]


def _rois(rng, kind, b, n):
    """xyxy rois inside each image: spread over it, or piled on a few cells."""
    h, w = IH.min(), IW.min()
    if kind == "overlap":
        x1, y1 = 8 + rng.uniform(0, 4, (b, n)), 6 + rng.uniform(0, 4, (b, n))
        side = rng.uniform(3, 20, (b, n, 2))
    else:
        x1, y1 = rng.uniform(0, w - 4, (b, n)), rng.uniform(0, h - 4, (b, n))
        side = rng.uniform(4, 40, (b, n, 2))
    return np.stack([x1, y1, np.minimum(x1 + side[..., 0], w - 1),
                     np.minimum(y1 + side[..., 1], h - 1)], -1).astype(np.float32)


@pytest.mark.parametrize("kind,seed", [("spread", 1), ("spread", 2), ("overlap", 3)])
def test_plain_k4_k5_match_pallas_interpret_vjp(kind, seed):
    rng = np.random.RandomState(seed)
    b, n = 2, 10
    p_list = _planes(rng, b, BUCKET)
    rois = _rois(rng, kind, b, n)
    levels = rng.randint(0, 4, (b, n))
    valid = rng.uniform(size=(b, n)) > 0.2
    valid[1, -1] = False
    cot = rng.randn(b, n, 14, 14, C).astype(np.float32)

    def pallas(planes):
        return jnp.concatenate([pallas_roi_align_multilevel(
            tuple(p[i:i + 1] for p in planes), jnp.asarray(rois[i:i + 1]),
            jnp.asarray(levels[i:i + 1]), jnp.asarray(IH[i:i + 1]), jnp.asarray(IW[i:i + 1]), 14,
            strides=STRIDES, valid=jnp.asarray(valid[i:i + 1].astype(np.int32)), interpret=True,
        ) for i in range(b)])

    planes = tuple(jnp.asarray(p) for p in p_list)
    want_out = np.asarray(pallas(planes))
    want = jax.grad(lambda ps: jnp.sum(pallas(ps) * cot))(planes)
    args = (*_t(rois, levels, valid, IH, IW), 14, STRIDES)
    got_out = port.roi_align_multilevel_reference(_t(*p_list), *args)
    got = port.roi_align_multilevel_reference_backward(torch.from_numpy(cot), _t(*p_list), *args)
    np.testing.assert_allclose(got_out.numpy(), want_out, **TOL)
    for k, (d, w) in enumerate(zip(got, want)):
        assert d.shape == w.shape
        np.testing.assert_allclose(d.numpy(), np.asarray(w), **TOL, err_msg=f"level {k}")
        # cells outside every image's valid extent take no gradient
        vh, vw = int(np.ceil(IH.max() / STRIDES[k])), int(np.ceil(IW.max() / STRIDES[k]))
        assert not d[:, vh:].any() and not d[:, :, vw:].any()
    # invalid rois take no part: zeroing their cotangent changes nothing
    cot0 = np.where(valid[..., None, None, None], cot, 0.0).astype(np.float32)
    again = port.roi_align_multilevel_reference_backward(torch.from_numpy(cot0), _t(*p_list), *args)
    for d, e in zip(got, again):
        torch.testing.assert_close(d, e, rtol=0, atol=0)
    assert sum(float(d.abs().sum()) > 0 for d in got) >= 3


@pytest.mark.parametrize("stride", STRIDES)
def test_plain_k2_k3_match_pallas_window_interpret_vjp(stride):
    rng = np.random.RandomState(10 + stride)
    b, n = 2, 12
    (feat,) = _planes(rng, b, BUCKET, strides=(stride,))
    rois = np.concatenate([_rois(rng, "spread", b, n // 2), _rois(rng, "overlap", b, n // 2)], 1)
    active = rng.uniform(size=(b, n)) > 0.25
    active[0, 0] = False
    cot = rng.randn(b, n, 14, 14, C).astype(np.float32)

    def pallas(f):
        return jnp.concatenate([pallas_roi_align_window(
            f[i:i + 1], jnp.asarray(rois[i:i + 1]), jnp.asarray(active[i:i + 1].astype(np.int32)),
            jnp.asarray(IH[i:i + 1]), jnp.asarray(IW[i:i + 1]), 14, interpret=True,
            level_stride=stride,
        ) for i in range(b)])

    want_out = np.asarray(pallas(jnp.asarray(feat)))
    want = np.asarray(jax.grad(lambda f: jnp.sum(pallas(f) * cot))(jnp.asarray(feat)))
    f = torch.from_numpy(feat).requires_grad_()
    out = port.roi_align_single_level(f, *_t(rois, active, IH, IW), 14, stride)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    np.testing.assert_allclose(f.grad.numpy(), want, **TOL)
    assert not out[torch.from_numpy(~active)].any()
    assert float(f.grad.abs().max()) > 0


def _level_margin(rois):
    """Distance of each roi's unrounded level to the nearest integer."""
    r = rois.astype(np.float64)
    v = 4.0 + np.log2(np.sqrt(np.maximum(r[..., 2] - r[..., 0], 0)
                              * np.maximum(r[..., 3] - r[..., 1], 0) + 1e-8) / 224.0)
    return np.abs(v - np.round(v))


EINSUM_CASES = {
    # name: (bucket, image extents [B, 2], extra rois per image, tolerance)
    "b2_padded": ((64, 64), [[58, 59], [44, 34]], [], TOL),
    "b2_whole_extent": ((64, 64), [[64, 64], [60, 52]], [[0.0, 0.0, 33.0, 43.0]], TOL),
    "elongated": ((320, 704), [[300, 640]], [[0.0, 0.0, 639.0, 299.0],
                                            [5.0, 10.0, 605.0, 30.0]], WIDE_TOL),
}


@pytest.mark.parametrize("case", sorted(EINSUM_CASES))
def test_plain_k4_k5_match_jax_einsum_training_path(case):
    """Pooled RoI features and their plane gradients: the port's CPU RoIAlign
    with its autograd against JAX `_roi_features_batched(training=True)` on
    the default einsum path (which has no window: the elongated roi spans
    more than 64 cells at P2)."""
    bucket, hws, extra, tol = EINSUM_CASES[case]
    hws = np.asarray(hws, np.int32)
    b, n = len(hws), 8
    rng = np.random.RandomState(len(case))
    p_list = _planes(rng, b, bucket)
    h, w = hws[:, 0].min(), hws[:, 1].min()
    x1, y1 = rng.uniform(0, w - 12, (b, n)), rng.uniform(0, h - 12, (b, n))
    side = rng.uniform(12, max(h, w) / 2, (b, n, 2))
    rois = np.stack([x1, y1, np.minimum(x1 + side[..., 0], w - 1),
                     np.minimum(y1 + side[..., 1], h - 1)], -1).astype(np.float32)
    if extra:
        rois = np.concatenate([rois, np.broadcast_to(np.float32(extra), (b, len(extra), 4))], 1)
    assert _level_margin(rois).min() > 1e-4
    cot = rng.randn(b, rois.shape[1], 7, 7, C).astype(np.float32)

    jdet = jax_factory("fpn", "resnet50", dict(jax_config("pascal", "fpn")))

    def einsum(planes):
        return jdet._roi_features_batched(planes, jnp.asarray(rois), jnp.asarray(hws),
                                          training=True)

    planes = tuple(jnp.asarray(p) for p in p_list)
    want_out = np.asarray(einsum(planes))
    want = jax.grad(lambda ps: jnp.sum(einsum(ps) * cot))(planes)
    levels = np.asarray(jdet._roi_levels(jnp.asarray(rois))) - jdet.min_level
    ours = [p.requires_grad_() for p in _t(*p_list)]
    ih, iw = _t(hws[:, 0].astype(np.float32), hws[:, 1].astype(np.float32))
    crops = port.roi_align_multilevel(ours, *_t(rois, levels.astype(np.int64)),
                                      torch.ones(levels.shape, dtype=torch.bool), ih, iw, 14,
                                      STRIDES)
    out = port.max_pool_2x2_same(crops)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, **tol)
    for k, (p, wg) in enumerate(zip(ours, want)):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(wg), **tol, err_msg=f"level {k}")
    if case == "elongated":
        assert levels[0, -1] == 0 and (605.0 - 5.0) / STRIDES[0] > 64


@pytest.mark.parametrize("fused", [True, False], ids=["multilevel", "single_level"])
def test_cpu_gradients_reach_the_planes_only(fused):
    """On CPU tensors the autograd of the plain version: a gradient for the
    planes, none for the rois (as JAX stops it), no kernel launched."""
    rng = np.random.RandomState(5)
    b, n = 2, 6
    planes = [p.requires_grad_() for p in _t(*_planes(rng, b, BUCKET))]
    rois = torch.from_numpy(_rois(rng, "spread", b, n)).requires_grad_()
    levels = torch.from_numpy(rng.randint(0, 4, (b, n)))
    valid = torch.ones(b, n, dtype=torch.bool)
    ih, iw = _t(IH, IW)
    before = (ROI_ALIGN_BACKWARD_KERNEL.launches, ROI_ALIGN_SINGLE_BACKWARD_KERNEL.launches)
    if fused:
        out = port.roi_align_multilevel(planes, rois, levels, valid, ih, iw, 14, STRIDES)
    else:
        out = sum(port.roi_align_single_level(planes[k], rois, (levels == k) & valid, ih, iw, 14,
                                              STRIDES[k]) for k in range(4))
    out.square().sum().backward()
    assert rois.grad is None
    assert all(p.grad is not None and float(p.grad.abs().sum()) > 0 for p in planes)
    assert (ROI_ALIGN_BACKWARD_KERNEL.launches,
            ROI_ALIGN_SINGLE_BACKWARD_KERNEL.launches) == before


def _bwd_args(**change):
    args = dict(grad=torch.zeros(1, 3, 14, 14, 4), plane_shapes=[(1, 8, 8, 4), (1, 4, 4, 4)],
                rois=torch.zeros(1, 3, 4), levels=torch.zeros(1, 3, dtype=torch.long),
                valid=torch.ones(1, 3, dtype=torch.bool), image_height=torch.full((1,), 30.0),
                image_width=torch.full((1,), 30.0), crop_size=14, strides=(4, 8))
    args.update(change)
    return args


@pytest.mark.parametrize("change,error,match", [
    (dict(grad=torch.zeros(1, 3, 14, 14, 4, dtype=torch.float64)), TypeError, "float32"),
    (dict(grad=torch.zeros(1, 3, 14, 14, 2)), ValueError, "gradient"),
    (dict(grad=torch.zeros(1, 3, 7, 7, 4)), ValueError, "gradient"),
    (dict(grad=torch.zeros(1, 3, 4, 14, 14).transpose(2, 4)), ValueError, "gradient"),
    (dict(levels=torch.zeros(1, 3, dtype=torch.int32)), TypeError, "dtypes"),
    (dict(plane_shapes=[(1, 8, 8, 4)]), ValueError, "one stride each"),
    ({}, ValueError, "CUDA tensors"),
])
def test_backward_wrapper_refuses(change, error, match):
    """The K5 / K3 wrapper refuses before any build or launch, so this shows
    without a card or nvcc."""
    before = ROI_ALIGN_BACKWARD_KERNEL.launches
    with pytest.raises(error, match=match):
        ROI_ALIGN_BACKWARD_KERNEL(**_bwd_args(**change))
    assert ROI_ALIGN_BACKWARD_KERNEL.launches == before
