"""The CUDA RoIAlign backward kernels K5 / K3 (csrc/roi_align_backward.cu) and the
single-level forward K2 against their plain PyTorch versions, on the card.

Needs a CUDA device and nvcc; skips elsewhere. Imports no JAX:
`python -m pytest -m gpu tests/test_torch_roi_align_backward_cuda.py`.

Tolerances: a backward cell within 1e-5 of sum |g * w| over the terms it
adds (the plain backward of |g|): float atomics add in no fixed order, and a
sum taken in another order moves by a few ulps of that sum. The backward's
float4 path (C % 4 == 0, g and planes 16-byte aligned) and its scalar path
(C = 42, or g 4 bytes off alignment) are both held to it, on dense g and on
the pool-sparse g of the training path (the 2x2 max pool's backward). K2 within
atol/rtol 1e-5, as K4, also where the image extents reach past the planes
(a tap past the plane weighs 0). The autograd Functions' gradients are the
kernels' outputs and are held to the same tolerance against autograd through
the plain forward.
"""

import numpy as np
import pytest
import torch

from tf_eager_object_detection_tpu_torch.ops import roi_align as port
from tf_eager_object_detection_tpu_torch.ops.kernels.roi_align_backward_cuda import (
    ROI_ALIGN_BACKWARD_KERNEL,
    ROI_ALIGN_SINGLE_BACKWARD_KERNEL,
)
from tf_eager_object_detection_tpu_torch.ops.kernels.roi_align_cuda import (
    ROI_ALIGN_KERNEL,
    ROI_ALIGN_SINGLE_KERNEL,
    vectorizable,
)

pytestmark = pytest.mark.gpu

STRIDES = (4, 8, 16, 32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU or interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(cuda, b, n, c, bucket, hws, overlap=False, invalid=0.0, seed=0, crop=14):
    rng = np.random.RandomState(seed)
    planes = [torch.from_numpy(rng.randn(b, -(-bucket[0] // s), -(-bucket[1] // s), c)
                               .astype(np.float32)).to(cuda) for s in STRIDES]
    hws = np.asarray(hws, np.float32)
    h, w = hws[:, :1], hws[:, 1:]
    if overlap:
        x1, y1 = 30 + rng.uniform(0, 10, (b, n)), 20 + rng.uniform(0, 10, (b, n))
        side = rng.uniform(2, 30, (b, n, 2))
    else:
        x1, y1 = rng.uniform(0, 1, (b, n)) * (w - 2), rng.uniform(0, 1, (b, n)) * (h - 2)
        side = np.exp(rng.uniform(np.log(2), np.log(400), (b, n, 2)))
    rois = np.stack([x1, y1, np.minimum(x1 + side[..., 0], w - 1),
                     np.minimum(y1 + side[..., 1], h - 1)], -1).astype(np.float32)
    rois[:, 0] = np.stack([np.zeros(b), np.zeros(b), hws[:, 1] - 1, hws[:, 0] - 1], -1)
    wh = np.sqrt(np.maximum(rois[..., 2] - rois[..., 0], 0)
                 * np.maximum(rois[..., 3] - rois[..., 1], 0) + 1e-8)
    levels = np.clip(np.floor(4 + np.log2(wh / 224)), 2, 5).astype(np.int64) - 2
    valid = rng.uniform(size=(b, n)) >= invalid
    t = [torch.from_numpy(a).to(cuda) for a in (rois, levels, valid, hws[:, 0], hws[:, 1])]
    g = torch.from_numpy(rng.randn(b, n, crop, crop, c).astype(np.float32)).to(cuda)
    return planes, t, g


def _check(got, ref, scale):
    for d, r, m in zip(got, ref, scale):
        assert d.shape == r.shape
        assert bool(((d - r).abs() <= 1e-5 * m).all()), float((d - r).abs().max())


CASES = [  # (name, b, n, c, bucket, image extents, overlap, invalid)
    ("train_b1", 1, 256, 256, (640, 1024), [[600, 800]], False, 0.0),
    ("b2_invalid", 2, 64, 32, (192, 256), [[180, 250], [150, 200]], False, 0.3),
    ("overlap", 1, 128, 16, (128, 128), [[128, 120]], True, 0.0),
    ("odd_channels", 1, 20, 40, (128, 128), [[100, 128]], False, 0.1),
]


@pytest.mark.parametrize("name,b,n,c,bucket,hws,overlap,invalid", CASES)
def test_k5_matches_plain_backward(cuda, name, b, n, c, bucket, hws, overlap, invalid):
    planes, (rois, levels, valid, ih, iw), g = _case(cuda, b, n, c, bucket, hws, overlap, invalid)
    args = (rois, levels, valid, ih, iw, 14, STRIDES)
    before = ROI_ALIGN_BACKWARD_KERNEL.launches
    got = ROI_ALIGN_BACKWARD_KERNEL(g, [tuple(p.shape) for p in planes], *args)
    torch.cuda.synchronize()
    assert ROI_ALIGN_BACKWARD_KERNEL.launches == before + 1
    _check(got, port.roi_align_multilevel_reference_backward(g, planes, *args),
           port.roi_align_multilevel_reference_backward(g.abs(), planes, *args))
    assert any(bool(d.abs().max() > 0) for d in got)


@pytest.mark.parametrize("level", range(4))
def test_k3_and_k2_match_plain_versions(cuda, level):
    planes, (rois, levels, valid, ih, iw), g = _case(cuda, 2, 96, 24, (256, 320),
                                                     [[250, 300], [200, 320]], invalid=0.2,
                                                     seed=level)
    active = (levels == level) & valid
    feat, stride = planes[level], STRIDES[level]
    crops = ROI_ALIGN_SINGLE_KERNEL([feat], rois, torch.zeros_like(levels), active, ih, iw, 14,
                                    (stride,))
    torch.testing.assert_close(crops, port.roi_align_single_level_reference(
        feat, rois, active, ih, iw, 14, stride), rtol=1e-5, atol=1e-5)
    assert not bool(crops[~active].any())
    (df,) = ROI_ALIGN_SINGLE_BACKWARD_KERNEL(g, [tuple(feat.shape)], rois,
                                             torch.zeros_like(levels), active, ih, iw, 14,
                                             (stride,))
    one = ([feat], rois, torch.zeros_like(levels), active, ih, iw, 14, (stride,))
    _check([df], port.roi_align_multilevel_reference_backward(g, *one),
           port.roi_align_multilevel_reference_backward(g.abs(), *one))


@pytest.mark.parametrize("fused", [True, False], ids=["K4_K5", "K2_K3"])
def test_autograd_functions_give_the_plain_gradients(cuda, fused):
    """roi_align_multilevel / roi_align_single_level on CUDA tensors: the
    forward and the planes' gradients equal autograd through the plain
    forward; rois get none."""
    planes, (rois, levels, valid, ih, iw), g = _case(cuda, 2, 48, 16, (192, 256),
                                                     [[180, 250], [150, 200]], invalid=0.2)
    ours = [p.clone().requires_grad_() for p in planes]
    ref = [p.clone().requires_grad_() for p in planes]
    rois = rois.requires_grad_()
    counts = [k.launches for k in (ROI_ALIGN_BACKWARD_KERNEL, ROI_ALIGN_SINGLE_BACKWARD_KERNEL)]
    if fused:
        out = port.roi_align_multilevel(ours, rois, levels, valid, ih, iw, 14, STRIDES)
    else:
        out = sum(port.roi_align_single_level(ours[k], rois, (levels == k) & valid, ih, iw, 14,
                                              STRIDES[k]) for k in range(4))
    want = port.roi_align_multilevel_reference(ref, rois.detach(), levels, valid, ih, iw, 14,
                                               STRIDES)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    out.backward(g)
    want.backward(g)
    scale = port.roi_align_multilevel_reference_backward(g.abs(), planes, rois.detach(), levels,
                                                         valid, ih, iw, 14, STRIDES)
    _check([p.grad for p in ours], [p.grad for p in ref], scale)
    assert rois.grad is None
    after = [k.launches for k in (ROI_ALIGN_BACKWARD_KERNEL, ROI_ALIGN_SINGLE_BACKWARD_KERNEL)]
    assert after == ([counts[0] + 1, counts[1]] if fused else [counts[0], counts[1] + 4])


def _pool_sparse(planes, rois, levels, valid, ih, iw, crop, seed):
    """The training path's g: the 2x2 max pool's backward of an N(0, 1)
    gradient of the pooled crops (three of every four samples of a channel
    exactly zero)."""
    crops = port.roi_align_multilevel_reference(planes, rois, levels, valid, ih, iw, crop,
                                                STRIDES).requires_grad_()
    pooled = port.max_pool_2x2_same(crops)
    cot = np.random.RandomState(seed).randn(*pooled.shape).astype(np.float32)
    (g,) = torch.autograd.grad(pooled, crops, torch.from_numpy(cot).to(crops.device))
    return g.contiguous()


def _off_alignment(t):
    """A contiguous copy of `t` 4 bytes past a 16-byte boundary."""
    return torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)


NEW_PATH_CASES = [  # (name, b, n, c, bucket, image extents, crop, g, float4 path)
    ("pool_sparse_g", 1, 256, 256, (640, 1024), [[600, 800]], 14, "pooled", True),
    ("pool_sparse_g_scalar", 2, 48, 42, (192, 256), [[180, 250], [150, 200]], 14, "pooled",
     False),
    ("channels_42", 2, 64, 42, (192, 256), [[180, 250], [150, 200]], 14, "dense", False),
    ("g_off_alignment", 2, 64, 32, (192, 256), [[180, 250], [150, 200]], 14, "misaligned",
     False),
    ("same_cells", 1, 256, 64, (256, 256), [[250, 240]], 14, "same", True),
    ("crop_7", 2, 96, 64, (256, 320), [[250, 300], [200, 320]], 7, "dense", True),
    ("b4", 4, 128, 64, (256, 320), [[250, 300], [200, 320], [256, 256], [180, 310]], 14,
     "dense", True),
    # rois 600 px wide on P2 (150 cells): samples ~11 cells apart share no column
    ("wide_rois", 1, 32, 64, (128, 1024), [[120, 1000]], 14, "wide", True),
]


@pytest.mark.parametrize("name,b,n,c,bucket,hws,crop,g_kind,vec", NEW_PATH_CASES)
def test_k5_and_k3_paths_match_plain_backward(cuda, name, b, n, c, bucket, hws, crop, g_kind,
                                               vec):
    """K5 and K3 (one launch per level) on each path of the redesigned kernel:
    float4 and scalar units, pool-sparse g, every roi on the same cells (the
    reductions contend), S = 7, B = 4, rows whose samples share no column."""
    planes, (rois, levels, valid, ih, iw), g = _case(cuda, b, n, c, bucket, hws, invalid=0.1,
                                                     seed=len(name), crop=crop)
    if g_kind == "same":
        rois[:] = torch.tensor([40.0, 30.0, 95.0, 80.0], device=cuda)
        levels.zero_()
    if g_kind == "wide":
        rois[..., 2] = rois[..., 0].clamp_max(390.0) + 600.0
        rois[..., 3] = rois[..., 1].clamp_max(90.0) + 20.0
        levels.zero_()
    if g_kind == "pooled":
        g = _pool_sparse(planes, rois, levels, valid, ih, iw, crop, seed=len(name))
        assert float((g == 0).float().mean()) >= 0.7
    if g_kind == "misaligned":
        g = _off_alignment(g)
    shapes = [tuple(p.shape) for p in planes]
    assert vectorizable([torch.empty(s, device=cuda) for s in shapes], g) == vec
    args = (rois, levels, valid, ih, iw, crop, STRIDES)
    before = ROI_ALIGN_BACKWARD_KERNEL.launches
    got = ROI_ALIGN_BACKWARD_KERNEL(g, shapes, *args)
    torch.cuda.synchronize()
    assert ROI_ALIGN_BACKWARD_KERNEL.launches == before + 1
    _check(got, port.roi_align_multilevel_reference_backward(g, planes, *args),
           port.roi_align_multilevel_reference_backward(g.abs(), planes, *args))
    assert any(bool(d.abs().max() > 0) for d in got)
    for k, (feat, stride) in enumerate(zip(planes, STRIDES)):
        one = ([feat], rois, torch.zeros_like(levels), (levels == k) & valid, ih, iw, crop,
               (stride,))
        (df,) = ROI_ALIGN_SINGLE_BACKWARD_KERNEL(g, [tuple(feat.shape)], *one[1:])
        _check([df], port.roi_align_multilevel_reference_backward(g, *one),
               port.roi_align_multilevel_reference_backward(g.abs(), *one))


def _samples_past_the_plane(rois, levels, valid, ih, iw, planes):
    """In-range samples of valid rois whose coordinate lies past their
    level's plane (the taps there weigh 0)."""
    count = 0
    for k, (feat, stride) in enumerate(zip(planes, STRIDES)):
        on = ((levels == k) & valid)[..., None]
        for lo, hi, dim, size in ((1, 3, ih, feat.shape[1]), (0, 2, iw, feat.shape[2])):
            v, ok = port.level_sample_coords(rois[..., lo], rois[..., hi], dim, stride, 14)
            count += int((ok & on & (v > size - 1)).sum())
    return count


@pytest.mark.parametrize("aligned", [True, False], ids=["float4", "scalar"])
def test_k5_adds_clamped_taps_where_k4_reads_them(cuda, aligned):
    """Image extents past the planes (images up to 160 px on the planes of a
    128x128 bucket, so a sample's last valid cell lies past the plane's): a
    tap past the plane weighs 0 in K4 and in K5, and K5 writes nothing past
    the plane. Both are held against the plain versions
    (`roi_align_multilevel_reference` and its autograd backward, whose tent
    runs over the plane's own cells): K4 within atol/rtol 1e-5, K5 within
    1e-5 of sum |g * w|. (The name is older than the rule: the kernels
    used to put a clamped tap's weight on the plane's last cell.)"""
    planes, (rois, levels, valid, ih, iw), g = _case(cuda, 2, 64, 32, (128, 128),
                                                     [[160, 150], [144, 160]], seed=5)
    if not aligned:
        g = _off_alignment(g)
    shapes = [tuple(p.shape) for p in planes]
    assert vectorizable([torch.empty(s, device=cuda) for s in shapes], g) == aligned
    args = (rois, levels, valid, ih, iw, 14, STRIDES)
    assert _samples_past_the_plane(rois, levels, valid, ih, iw, planes) > 0
    torch.testing.assert_close(ROI_ALIGN_KERNEL(planes, *args),
                               port.roi_align_multilevel_reference(planes, *args), rtol=1e-5,
                               atol=1e-5)
    got = ROI_ALIGN_BACKWARD_KERNEL(g, shapes, *args)
    torch.cuda.synchronize()
    _check(got, port.roi_align_multilevel_reference_backward(g, planes, *args),
           port.roi_align_multilevel_reference_backward(g.abs(), planes, *args))


def test_backward_wrapper_rejects_bad_inputs(cuda):
    shapes = [(1, 8, 8, 4), (1, 4, 4, 4)]
    rois = torch.zeros(1, 3, 4, device=cuda)
    levels = torch.zeros(1, 3, dtype=torch.long, device=cuda)
    valid = torch.ones(1, 3, dtype=torch.bool, device=cuda)
    ext = torch.full((1,), 30.0, device=cuda)
    g = torch.zeros(1, 3, 14, 14, 4, device=cuda)
    before = ROI_ALIGN_BACKWARD_KERNEL.launches
    with pytest.raises(TypeError):
        ROI_ALIGN_BACKWARD_KERNEL(g.double(), shapes, rois, levels, valid, ext, ext, 14, (4, 8))
    with pytest.raises(ValueError):
        ROI_ALIGN_BACKWARD_KERNEL(g[..., :2], shapes, rois, levels, valid, ext, ext, 14, (4, 8))
    with pytest.raises(ValueError):
        ROI_ALIGN_BACKWARD_KERNEL(g, shapes, rois.cpu(), levels, valid, ext, ext, 14, (4, 8))
    assert ROI_ALIGN_BACKWARD_KERNEL.launches == before
